"""What each device of a mesh repeats in the port's dry-run: the MoE's and
the sLSTM's per-device F and all-gather bytes as the sequence grows, and
any cell's counts beside the JAX package's.

Lowers on fake meshes (``repro_torch.launch.dryrun.lower_cell``; no card,
no collective moves a byte) and prints one line per measurement:

  * the reduced qwen2-moe and xlstm train cells at (8, S), S = 32, 64 and
    128, on 1x1 and 2x2, layers unrolled, as
    ``tests/test_torch_dryrun_parity.py`` lowers S = 32: F x 4 / F(1x1)
    and the 2x2 wire MB a device by kind;
  * one sLSTM block of xlstm-125m (n_layers 1) at the train_4k batch on
    16x16 at S = 32 and 64, its all-gather a device and the linear fit of
    the two read at S = 4096 (``chip_smoke.py``'s ``dryrun`` check);
  * with ``--full``, xlstm-125m train_4k on 16x16 at full depth
    (``probe=False``: the CLI's k = 2, 4 probe holds mLSTM blocks only):
    F, the wire by kind and the seconds it took (minutes: the sLSTM's
    4,096 steps a layer run on fake tensors);
  * with ``--against-reference``, and only that, the given cells (by
    default every decode_32k cell, whisper-tiny's train_4k and
    prefill_32k, smollm-135m's train_4k and prefill_32k and qwen2-7b's
    train_4k) at 1x1 and 16x16 (or the meshes ``--mesh`` names) in both
    packages, at the CLIs' k = 2, 4 probe depth: per device F x N /
    F(1x1), all-gather, all-reduce and total wire bytes and B_M, the
    port's beside the reference's.  The reference's encdec runs its layers
    under ``lax.scan`` whatever ``scan_layers`` says, and XLA counts a
    scanned body once, so its probe reads one encoder and one decoder
    layer at any depth; an encdec cell of the port is lowered at one layer
    a stack (``n_layers = encoder_layers = 1``, no probe) beside it, and
    its line says so.  The reference's dry-run CLI runs in a subprocess
    (it sets ``XLA_FLAGS`` before jax starts) and writes its reports to a
    temporary directory; a full decode cell compiles there in seconds,
    whisper-tiny train_4k 16x16 in ~20 s and xlstm-125m train_4k 16x16 in
    minutes on a CPU;
  * with ``--by-module``, and only that, the given cells at full width and
    two layers (no probe) at 1x1 and 16x16 (or ``--mesh``): F x N /
    F(1x1) of each function of ``MODULES`` that the step calls, and the
    wire bytes a device of the collectives issued while it runs, by kind,
    each summed over its calls (the forward's; a train cell's backward is
    not split; a function's sum holds the functions it calls, and a
    collective that DTensor defers to a later op counts there).

Usage::

    PYTHONPATH=src python scripts/dryrun_repeats_torch.py [--full]
    PYTHONPATH=src python scripts/dryrun_repeats_torch.py \
        --against-reference [qwen2-7b:decode_32k xlstm-125m:train_4k ...] \
        [--mesh 16x16 2x16x16]
    PYTHONPATH=src python scripts/dryrun_repeats_torch.py \
        --by-module qwen2-moe-a2.7b:decode_32k whisper-tiny:train_4k
"""
import argparse
import dataclasses
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: the reference's CLI on each (arch, shape, mesh) of argv[2], its reports
#: written to argv[1]: importing its module sets XLA_FLAGS before jax
REFERENCE = r"""
import json, sys
from repro.launch import dryrun
dryrun.ARTIFACTS = sys.argv[1]
for arch, shape, mesh in json.loads(sys.argv[2]):
    if dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--force"]):
        sys.exit(1)
"""

def _reduced_overrides(arch: str) -> dict:
    full, red = get_config(arch), get_reduced(arch)
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
          if getattr(red, f.name) != getattr(full, f.name)}
    ov.pop("max_seq_len", None)
    ov["scan_layers"] = False
    return ov


def _shape(S: int, batch: int) -> str:
    name = f"train_b{batch}_s{S}"
    SHAPES[name] = ShapeSpec(name, S, batch, "train")
    return name


def _kinds(wire: dict, scale: float, unit: str) -> str:
    return ", ".join(f"{k} {v / scale:.4f}" for k, v in sorted(wire.items())
                     if v) + f" {unit}"


def reduced_cells() -> None:
    for arch in ("qwen2-moe-a2.7b", "xlstm-125m"):
        ov = _reduced_overrides(arch)
        for S in (32, 64, 128):
            shape = _shape(S, 8)
            one, four = (dryrun.lower_cell(arch, shape, mesh, overrides=ov,
                                           probe=False)[1]
                         for mesh in ("1x1", "2x2"))
            print(f"{arch} reduced (8, {S}) 2x2: F x 4 / F(1x1) "
                  f"{four.flops * 4 / one.flops:.4f}; "
                  f"{_kinds(four.wire_bytes_by_kind, 1e6, 'MB')}", flush=True)


def slstm_block() -> None:
    batch = SHAPES["train_4k"].global_batch
    gathered = {}
    for S in (32, 64):
        low = dryrun.lower_cell("xlstm-125m", _shape(S, batch), "16x16",
                                overrides={"n_layers": 1,
                                           "slstm_layers": (0,)},
                                probe=False)[1]
        gathered[S] = low.wire_bytes_by_kind.get("all-gather", 0.0)
        print(f"xlstm-125m one sLSTM block ({batch}, {S}) 16x16: "
              f"{_kinds(low.wire_bytes_by_kind, 1e9, 'GB')}", flush=True)
    S4 = SHAPES["train_4k"].seq_len
    fit = gathered[32] + (gathered[64] - gathered[32]) / 32 * (S4 - 32)
    print(f"  all-gather x{gathered[64] / gathered[32]:.4f} per doubling; "
          f"linear fit at S {S4}: {fit / 1e9:.4f} GB", flush=True)


def full_depth() -> None:
    t0 = time.time()
    low = dryrun.lower_cell("xlstm-125m", "train_4k", "16x16",
                            probe=False)[1]
    print(f"xlstm-125m train_4k 16x16 full depth: {time.time() - t0:.1f} s; "
          f"F a device {low.flops!r}; "
          f"{_kinds(low.wire_bytes_by_kind, 1e9, 'GB')}", flush=True)


def _reference_reports(cells, meshes) -> dict:
    """{(arch, shape, mesh): the reference's report} from its CLI."""
    runs = [(a, s, m) for a, s in cells for m in meshes]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run([sys.executable, "-c", REFERENCE, out,
                               json.dumps(runs)], env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit("the reference's dry-run failed:\n"
                             + (proc.stdout + proc.stderr)[-3000:])
        reports = {}
        for a, s, m in runs:
            with open(os.path.join(out, f"{a}__{s}__{m}__baseline.json")) as f:
                reports[(a, s, m)] = json.load(f)
    return reports


def against_reference(cells, pods=("16x16",)) -> None:
    meshes = ("1x1",) + tuple(pods)
    t0 = time.time()
    ref = _reference_reports(cells, meshes)
    print(f"reference: {len(ref)} lowerings in {time.time() - t0:.1f} s",
          flush=True)
    for arch, shape in cells:
        kw, like = {}, ""
        if get_config(arch).family == "encdec":
            kw = {"overrides": {"n_layers": 1, "encoder_layers": 1},
                  "probe": False}
            like = (" (port at one layer a stack: the reference scans "
                    "encdec's layers and counts one)")
        port = {m: json.loads(dryrun.lower_cell(arch, shape, m, **kw)[0]
                              .to_json())
                for m in meshes}
        p1, r1 = port["1x1"], ref[(arch, shape, "1x1")]
        for mesh in pods:
            p, r = port[mesh], ref[(arch, shape, mesh)]

            def pair(get) -> str:
                return f"{get(p):.4f} | {get(r):.4f}"

            def kind(k):
                return lambda rep: rep["wire_bytes_by_kind"].get(k, 0.0) / 1e9

            print(f"{arch} {shape} {mesh}, port | reference: F x N / F(1x1) "
                  f"{p['flops'] * p['num_devices'] / p1['flops']:.4f} | "
                  f"{r['flops'] * r['num_devices'] / r1['flops']:.4f}; "
                  f"all-gather {pair(kind('all-gather'))} GB; all-reduce "
                  f"{pair(kind('all-reduce'))} GB; wire "
                  f"{pair(lambda rep: rep['wire_bytes'] / 1e9)} GB; B_M "
                  f"{pair(lambda rep: rep['mem_bytes'] / 1e9)} GB{like}",
                  flush=True)


#: the functions ``--by-module`` splits a cell's F by: (module of
#: ``repro_torch.models``, or of ``repro_torch`` where dotted, and name),
#: each wrapped wherever a module of ``repro_torch.models`` holds it
MODULES = (("moe", "_route_groups"), ("moe", "_dispatch"),
           ("moe", "_experts"), ("moe", "_combine"),
           ("attention", "decode_attention"), ("attention", "_project_qkv"),
           ("attention", "write_row"), ("attention", "_sdpa_grouped"),
           ("attention", "apply_attention"), ("attention", "_sdpa"),
           ("ffn", "apply_ffn"), ("common", "apply_norm"),
           ("transformer", "_embed_decode"), ("transformer", "_head"),
           ("hybrid", "decode_hymba_block"), ("mamba", "decode_mamba"),
           ("encdec", "encode"), ("encdec", "_encode"),
           ("encdec", "_logits"),
           ("distributed.sharding", "tokens_matmul"))


def by_module(cells, pods=("16x16",)) -> None:
    import pkgutil

    from repro_torch import models
    from repro_torch.measure.counters import MeshCounter
    live, flops, wire, patched = [], {}, {}, []

    class Recorded(MeshCounter):
        def __enter__(self):
            live.append(self)
            return super().__enter__()

        def __exit__(self, *exc):
            live.remove(self)
            return super().__exit__(*exc)

    def counted(key, fn):
        def call(*args, **kwargs):
            if not live:        # outside a count (whisper's abstract cache)
                return fn(*args, **kwargs)
            rec = live[-1]
            before, sent = rec.flops, len(rec.collectives)
            out = fn(*args, **kwargs)
            flops[key] = flops.get(key, 0.0) + rec.flops - before
            kinds = wire.setdefault(key, {})
            for op in rec.collectives[sent:]:
                kinds[op.kind] = kinds.get(op.kind, 0.0) + op.wire_bytes
            return out
        return call

    def megabytes(kinds) -> str:
        return ", ".join(f"{k} {v / 1e6:.4f}" for k, v in sorted(
            kinds.items()) if v) or "none"

    mods = [importlib.import_module(f"repro_torch.models.{m.name}")
            for m in pkgutil.iter_modules(models.__path__)]
    for home, name in MODULES:
        where = home if "." in home else f"models.{home}"
        fn = getattr(importlib.import_module(f"repro_torch.{where}"), name)
        for mod in mods:
            if getattr(mod, name, None) is fn:
                setattr(mod, name, counted(
                    f"{home.rsplit('.', 1)[-1]}.{name}", fn))
                patched.append((mod, name, fn))
    dryrun.MeshCounter = Recorded
    try:
        for arch, shape in cells:
            two = {"n_layers": 2}
            if get_config(arch).family == "encdec":
                two["encoder_layers"] = 2
            per, sent = {}, {}
            for mesh in ("1x1",) + tuple(pods):
                flops.clear()
                wire.clear()
                low = dryrun.lower_cell(arch, shape, mesh, overrides=two,
                                        probe=False)[1]
                per[mesh] = dict(flops, step=low.flops)
                sent[mesh] = dict(wire, step=low.wire_bytes_by_kind)
            for mesh in pods:
                n = math.prod(dryrun._mesh_from_name(mesh)[0])
                print(f"{arch} {shape} {mesh} at 2 layers, F x N / F(1x1) "
                      f"(F x N, F(1x1)); wire MB a device by kind:",
                      flush=True)
                for key in sorted(per["1x1"], key=lambda k: k != "step"):
                    one, many = per["1x1"][key], per[mesh].get(key, 0.0) * n
                    ratio = f"{many / one:.4f}" if one else "-"
                    print(f"  {key}: {ratio} ({many:.5g}, {one:.5g}); "
                          f"{megabytes(sent[mesh].get(key, {}))}",
                          flush=True)
    finally:
        dryrun.MeshCounter = MeshCounter
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def _cells(names) -> list:
    from repro_torch.configs import ASSIGNED
    from repro_torch.configs.shapes import applicable
    if names:
        return [tuple(n.split(":", 1)) for n in names]
    return [(a, "decode_32k") for a in ASSIGNED
            if applicable(get_config(a).family, "decode_32k")] + [
        ("whisper-tiny", "train_4k"), ("whisper-tiny", "prefill_32k"),
        ("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
        ("qwen2-7b", "train_4k")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="also lower xlstm-125m train_4k 16x16 at full depth")
    ap.add_argument("--against-reference", nargs="*", metavar="ARCH:SHAPE",
                    help="only set the given cells (default: every "
                         "decode_32k cell, whisper-tiny's train_4k and "
                         "prefill_32k, smollm-135m's train_4k and "
                         "prefill_32k and qwen2-7b's train_4k) beside "
                         "the reference's dry-run")
    ap.add_argument("--by-module", nargs="+", metavar="ARCH:SHAPE",
                    help="only split the given cells' F by MODULES")
    ap.add_argument("--mesh", nargs="+", default=["16x16"],
                    help="the meshes --against-reference or --by-module "
                         "set beside 1x1")
    args = ap.parse_args(argv)
    if args.by_module:
        by_module(_cells(args.by_module), args.mesh)
        return 0
    if args.against_reference is not None:
        against_reference(_cells(args.against_reference), args.mesh)
        return 0
    reduced_cells()
    slstm_block()
    if args.full:
        full_depth()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
