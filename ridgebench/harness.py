"""Run one cell of ``BENCHMARK.json`` once and make its result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, whose ``kind`` names the module in ``kinds/``
that runs it, each per-layer metric's reader in ``metrics/<metric>.py``
(or, for a reader shared by every kind, ``metrics/<metric without its
last part>.py``) and the limits of its check in ``limits/<workload>.json``.

A run: set-up (the kind's ``Cell``: weights from the seed, the cell's
shapes warmed up), timed from the process's start; then the window, units
of work one after another until ``--seconds`` have passed, each timed by
the host's clock around work that ends on a synchronised device.  With
``--trace 1`` a few more whole units run under the profiler once the
window has closed (``trace.py``: the traffic's ``trace_units``), and the
per-layer metrics are
read from them and from the window's units; without it the end-to-end
metrics are reported.  Then the device's peak memory is
read, and the kind's check runs the plain reference.  The numbers compared
go last, each beside its limit, on standard error and in the line.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "ridgebench"
#: top-level modules that no run may load: JAX, and the JAX package
#: (``repro_torch``'s name begins with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"ridgebench: no workload {name!r} in BENCHMARK.json "
                     f"({', '.join(w['name'] for w in bench['workloads'])})")


def cell_files(w: Dict) -> Dict:
    """The configuration, traffic and limits of a workload, by name."""
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return {"doc": load_json(HERE / "configs" / f"{w['config']}.json"),
            "traffic": traffic,
            "kind": importlib.import_module(f"ridgebench.kinds."
                                            f"{traffic['kind']}"),
            "limits": load_json(HERE / "limits" / f"{w['name']}.json")}


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``, or, where there is no
    such file, of the reader that serves the metric in every kind: the
    file named without the name's last part (``mfu.prefill``:
    ``metrics/mfu.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"ridgebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(w: Dict, bench: Dict, section: str) -> List[Dict]:
    """The ``section`` metrics this workload reports."""
    return [m for m in bench[section]
            if w["name"] in m.get("workloads", [w["name"]])]


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What a per-layer metric's reader gets: the cell's files, its kind's
    work per unit, the traced stretch, and the host seconds of the window's
    units outside it."""

    def __init__(self, doc, traffic, work, trace, seconds):
        self.doc, self.traffic, self.work = doc, traffic, work
        self.trace, self.seconds = trace, seconds


def run_window(cell, seconds: float, stretch=None, traced: int = 0):
    """(each unit's host seconds in the window, the window's seconds, units
    run).  The window ends with the first unit that ends after ``seconds``.
    ``stretch``: a Stretch that traces ``traced`` more units after the
    window's close, the state as the window left it; the profiler is
    started only then, because it slows the host's launches for the rest
    of the process."""
    times: List[float] = []
    i = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        cell.unit(i)
        t_end = time.perf_counter()
        times.append(t_end - t0)
        i += 1
        if t_end - t_start >= seconds:
            break
    window_s = t_end - t_start
    if stretch is not None:
        stretch.start()
        for _ in range(traced):
            cell.unit(i)
            i += 1
        stretch.stop()
    return times, window_s, i


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench: Optional[Dict] = None,
             files: Optional[Dict] = None) -> Dict:
    """One run of cell ``name`` on ``device``: the result line's fields,
    and ``checks``, the numbers compared beside their limits."""
    import torch

    from ridgebench.trace import Stretch
    bench = bench or manifest()
    w = workload(name, bench)
    files = files or cell_files(w)
    doc, traffic, kind = files["doc"], files["traffic"], files["kind"]
    t_cell = time.perf_counter()
    cell = kind.Cell(doc, traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    stretch = Stretch(device) if trace else None
    traced = traffic.get("trace_units", 1)
    times, window_s, units = run_window(cell, seconds, stretch, traced)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    out: Dict = {"attempted": units, "failed": 0, "metrics": {}}
    if trace:
        tr = stretch.read(traced)
        stretch = None
        ctx = Ctx(doc, traffic, cell.work(), tr, times)
        for m in metrics_of(w, bench, "per_layer"):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        out["trace"] = tr
    else:
        e2e = cell.end_to_end(times, window_s)
        for m in metrics_of(w, bench, "end_to_end"):
            if m["name"] == "setup_s":
                out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                value, unit = e2e[m["name"]]
                out["metrics"][m["name"]] = {"value": value, "unit": unit}
    found = forbidden_loaded()
    if found:
        raise SystemExit(f"ridgebench: the run loaded {', '.join(found)}; "
                         f"no result")
    numbers = cell.check()
    limits = files["limits"]
    out["checks"] = {k: {"value": numbers[k], "limit": lim}
                     for k, lim in limits.items()}
    out["correct"] = all(numbers[k] <= lim for k, lim in limits.items())
    out["peak"], out["seconds"] = peak, times
    out["setup_parts"] = (t_cell - t_start, setup_s - (t_cell - t_start))
    return out


def device_line(device, count: int, peak: int, tr=None) -> Dict:
    import torch
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
         "count": count, "memory_peak_bytes": peak}
    if tr is not None:
        d["busy_s"], d["window_s"] = tr.busy_s, tr.window_s
    return d


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="ridgebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    bench = manifest()
    w = workload(args.workload, bench)
    files = cell_files(w)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < w["chips"]:
        print(f"ridgebench: {args.workload} needs {w['chips']} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, t_start, bench, files)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_line(device, w["chips"], res["peak"],
                                  res.get("trace"))}
    if args.trace:
        tr = res["trace"]
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": [list(g) for g in tr.idle_gaps]}
    line["checks"] = res["checks"]
    if res["seconds"]:
        q = statistics.quantiles(res["seconds"], n=10, method="inclusive") \
            if len(res["seconds"]) > 1 else res["seconds"] * 9
        print(f"units: {len(res['seconds'])} untraced, host seconds p10 "
              f"{q[0]!r} p50 {q[4]!r} p90 {q[8]!r}", file=sys.stderr)
    print(f"setup: start to the card's first use {res['setup_parts'][0]!r} s,"
          f" the cell's set-up {res['setup_parts'][1]!r} s", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def cache_dirs() -> None:
    """Every cache a run could write, at fixed paths inside the checkout
    (the port's own nvcc builds already go to ``build/repro_torch``)."""
    build = ROOT / "build" / "ridgebench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(build / sub)
