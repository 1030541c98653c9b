"""The readings a cell's limits are set from, on the chip at the cell's
own sizes: the program's numbers over many seeds, the control's (the plain
reference in fp8 in the program's place) and each planted fault's over a
few.  Not run by the benchmark's runs.

    python3 ridgebench/readings.py --workload <name> --seeds 1-12 \
        --control-seeds 13-15 [--fault-seeds 16-18]

Prints one JSON line a reading.  Each seed's cell runs the window's units
up to the last one its check keeps, and is judged as a run judges it.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT / "src")
sys.path.insert(1, str(ROOT))


def seeds(text: str):
    out = []
    for part in text.split(",") if text else []:
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def say(**kw):
    print(json.dumps(kw), flush=True)


@contextlib.contextmanager
def planted(kind, fault):
    """The timed path broken underneath by ``kind.FAULTS[fault]``, applied
    to the forward's logits."""
    if fault is None:
        yield
        return
    from repro_torch.models import transformer
    bad = kind.FAULTS[fault]
    real = transformer.forward

    def forward(params, tokens, cfg):
        logits, aux = real(params, tokens, cfg)
        return bad(logits), aux
    transformer.forward = forward
    try:
        yield
    finally:
        transformer.forward = real


def readings(files, dev, args):
    import torch
    kind = files["kind"]
    for role, group in (("program", seeds(args.seeds)),
                        ("control", seeds(args.control_seeds)),
                        ("fault", seeds(args.fault_seeds))):
        for s in group:
            for fault in (kind.FAULTS if role == "fault" else [None]):
                t = time.perf_counter()
                with planted(kind, fault):
                    cell = kind.Cell(files["doc"], files["traffic"], s, dev)
                    for i in range(max(cell.kept_at) + 1):
                        cell.unit(i)
                nums = cell.check(control=role == "control", extra=True)
                say(role=role, fault=fault, seed=s, **nums,
                    seconds=time.perf_counter() - t)
                del cell
                torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser(prog="ridgebench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    from ridgebench import harness
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("ridgebench/readings.py: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    files = harness.cell_files(harness.workload(args.workload))
    say(workload=args.workload, card=torch.cuda.get_device_name(dev),
        setup_s=time.perf_counter() - T0)
    readings(files, dev, args)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
