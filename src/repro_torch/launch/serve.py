"""Serving launcher: batched greedy decoding against the KV-cache engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --batch 4 --prompt-len 8 --new-tokens 32 [--device cpu]

The port of ``repro.launch.serve``: random params from ``--seed`` on a
generator of the target device (on the card, so a full-width model is not
drawn on the host first), drawn by family (``init_encdec``, ``init_vlm`` or
``init_lm``), and a random prompt from ``--seed + 1`` on the CPU
(``torch.Generator`` streams, not JAX's), then
``serve.engine.greedy_generate``.  A VLM serves on its language model's
path, text only; an enc-dec model fails, as the reference's CLI does,
because the CLI passes no encoder frames and the engine needs them.
``--device`` defaults to the card; the CPU runs only when asked.

``--mesh DxM`` (default ``1x1``) serves under a ``(data, model)``
``DeviceMesh`` bound with the reference's GQA-safe rules
(``launch.mesh.enter_mesh``, ``distributed.sharding.cli_rules``): the
params are laid out by their logical specs
(``distributed.sharding.specs_to_shardings``), the prompt's batch on the
data axis, the cache as the decode rules give it.
The mesh is the world: one process makes ``1x1`` (on the card the model
then runs on local tensors, so the kernels launch as they do without a
mesh); a larger mesh takes that many ranks under ``torchrun`` on the CPU
(gloo; DTensors on the plain path) and several cards on the card (ROADMAP
Queue 1 item 4).  A mesh that is not the world exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NamedSharding, logical_spec,
                                              place, place_tree,
                                              specs_to_shardings)
from repro_torch.launch.mesh import enter_mesh
from repro_torch.models.encdec import init_encdec
from repro_torch.models.transformer import init_lm
from repro_torch.models.vlm import init_vlm
from repro_torch.serve.engine import greedy_generate
from repro_torch.train.loop import model_param_specs

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(compute_dtype=torch.float32)
    dev = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = enter_mesh(stack, args.mesh, cfg, dev)
        if mesh is None:
            return 2
        init = {"encdec": init_encdec,
                "vlm": init_vlm}.get(cfg.family, init_lm)
        params = place_tree(
            init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                 device=dev),
            specs_to_shardings(model_param_specs(cfg), mesh))
        prompt = place(torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator().manual_seed(args.seed + 1)).to(dev),
            NamedSharding(mesh, logical_spec(("batch", None))))
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompt, steps=args.new_tokens,
                              max_len=args.prompt_len + args.new_tokens)
        dt = time.perf_counter() - t0
        if hasattr(out, "full_tensor"):
            out = out.full_tensor()
    tok_s = args.batch * args.new_tokens / dt
    print(f"{args.arch}: batch={args.batch} +{args.new_tokens} tokens "
          f"in {dt:.2f}s ({tok_s:.0f} tok/s)")
    print("first sequence:", out[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
