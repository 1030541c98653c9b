"""What each device of a mesh repeats in the port's dry-run: the MoE's and
the sLSTM's per-device F and all-gather bytes as the sequence grows.

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
    4,096 steps a layer run on fake tensors).

Usage::

    PYTHONPATH=src python scripts/dryrun_repeats_torch.py [--full]
"""
import argparse
import dataclasses
import time

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import dryrun


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="also lower xlstm-125m train_4k 16x16 at full depth")
    args = ap.parse_args(argv)
    reduced_cells()
    slstm_block()
    if args.full:
        full_depth()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
