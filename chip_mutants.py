#!/usr/bin/env python3
"""Planted faults in the flash-attention kernel, held to chip_smoke.py's checks.

    python3 chip_mutants.py        # from the repository root; needs one card

A check that passes the real kernel shows little unless it fails a wrong
one.  Each mutant is ``src/repro_torch/kernels/csrc/flash_attention.cu``
with one edit that makes the bf16 kernel wrong in its late kv tiles only,
where an output row averages ~1000 keys and is small:

  skip_tile_16    kv tile 16 (keys 1024-1087) is skipped when a later tile
                  follows it
  stale_alpha_16  from kv tile 16 on, acc is not rescaled by alpha when a
                  tile raises the row's running max

Each mutant is compiled from an edited copy of the source written under
``build/mutants/`` (the checkout's sources stay as they are) and swapped in
for the real kernel.  The kernel alone at the smollm-135m prefill shape
(8, 2048, 9/3 heads, dh 64, bf16), and the whole prefill forward at
(8, 2048), are then held to chip_smoke.py's checks (``row_rel_err`` against
FLASH_TOL and LM_TOL), the real kernel first.  The whole-tensor measure
max|got - want| / max|want| is printed beside them.  Exits 0 when the real
kernel passes both checks and every mutant fails both.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke     # also puts src/ on sys.path

_RESCALE = ("      acc[n][0] *= alpha[0];\n      acc[n][1] *= alpha[0];\n"
            "      acc[n][2] *= alpha[1];\n      acc[n][3] *= alpha[1];\n")
#: name -> (text of the bf16 kernel, its replacement)
MUTANTS = {
    "skip_tile_16": ("    const int k0 = kt * kBfTileK;\n",
                     "    if (kt == 16 && kt + 1 < kt_last) continue;\n"
                     "    const int k0 = kt * kBfTileK;\n"),
    "stale_alpha_16": (_RESCALE, "      if (kt >= 16) continue;\n" + _RESCALE),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_mutants.py runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_flash_attention
    from repro_torch.models import transformer

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # every mutant's nvcc at once, the real kernel's build meanwhile
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in MUTANTS.items():
        smoke.check(src.count(old) == 1,
                    f"{name}: its text is not in flash_attention.cu once")
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels = {"real": fa._launcher()}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed on {name}:\n{log}")
        kernels[name] = fa.bind(ctypes.CDLL(str(so)))

    cfg = get_config("smollm-135m").replace(use_flash=True)
    bf16 = cfg.compute_dtype
    B, S = smoke.PREFILL[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((B, S, n, cfg.dh), generator=gen, device=dev)
               .to(bf16) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    want_attn = ref_flash_attention(q, k, v)
    params = lm_params_from_numpy(
        smoke.smollm_tree(cfg, np.random.default_rng(0)), device=dev)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    want_lm = transformer.forward(params, tokens, cfg.replace(use_flash=False))[0]

    real_launcher = fa._launcher
    rows = []
    try:
        for name, fn in kernels.items():
            fa._launcher = lambda fn=fn: fn
            got = ops.flash_attention(q, k, v)
            logits = transformer.forward(params, tokens, cfg)[0]
            row = {
                "kernel": name,
                "attn_row_rel_err": smoke.row_rel_err(got, want_attn),
                "attn_tol": smoke.FLASH_TOL[bf16],
                "attn_whole_rel_err": smoke.rel_err(got, want_attn),
                "logits_row_rel_err": smoke.row_rel_err(logits, want_lm),
                "logits_tol": smoke.LM_TOL,
                "logits_whole_rel_err": smoke.rel_err(logits, want_lm),
                "argmax_agrees": (logits.argmax(-1) == want_lm.argmax(-1))
                .float().mean().item(),
                "shape": [B, S, cfg.n_heads, cfg.n_kv_heads, cfg.dh],
                "card": card}
            row["caught"] = [row["attn_row_rel_err"] >= row["attn_tol"],
                             row["logits_row_rel_err"] >= row["logits_tol"]]
            print(json.dumps(row), flush=True)
            rows.append(row)
            del got, logits
    finally:
        fa._launcher = real_launcher
    ok = (rows[0]["caught"] == [False, False]
          and all(r["caught"] == [True, True] for r in rows[1:]))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
