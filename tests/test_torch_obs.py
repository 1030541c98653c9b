"""The port's span tracer and metrics (``repro_torch.obs``) against
``repro.obs``: nesting, counters, export, both packages' validators, the
CLI gate, the port's own environment variable, the disabled path, and the
spans a traced calibration opens (the reference's names)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch.core import sweep
from repro_torch.core.hardware import H100_SXM
from repro_torch.measure import calibrate
from repro_torch.obs import metrics, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_TRACE", "REPRO_TORCH_TRACE")}
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               **kw)
    return env


def test_spans_nest_counters_export_and_both_validators_agree(tmp_path):
    t = trace.Tracer()
    with t.span("outer", arch="dlrm-mlp"):
        with t.span("inner") as sp:
            sp.set(n=3)
            with t.span("leaf"):
                pass
        with t.span("inner2"):
            pass
    t.count("things", 2)
    t.count("things", 3)
    path = t.write(str(tmp_path / "deep" / "t.json"))
    assert not os.path.exists(path + ".tmp")
    got = trace.validate_chrome_trace(path)
    assert got == jax_trace.validate_chrome_trace(path)
    assert (got["n_spans"], got["n_counter_events"], got["max_depth"],
            got["n_threads"], got["counters"]) == (4, 2, 3, 1,
                                                   {"things": 5.0})
    doc = json.loads(pathlib.Path(path).read_text())
    args = {e["name"]: e.get("args", {}) for e in doc["traceEvents"]
            if e["ph"] == "X"}
    assert args["inner"] == {"n": 3} and args["outer"] == {"arch": "dlrm-mlp"}
    assert {"torch", "device"} <= set(doc["otherData"]["provenance"])


@pytest.mark.parametrize("bad, match", [
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 1,
                       "tid": 1}]}, "missing 'dur'"),
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": -1, "pid": 1,
                       "tid": 1}]}, "negative dur"),
    ({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
     "partially overlaps"),
    ({"events": []}, "traceEvents")])
def test_validator_rejects_what_the_reference_rejects(bad, match):
    for validate in (trace.validate_chrome_trace,
                     jax_trace.validate_chrome_trace):
        with pytest.raises(ValueError, match=match):
            validate(bad)


def test_validate_cli_exit_codes(tmp_path, capsys):
    good = trace.Tracer()
    with good.span("s"):
        pass
    ok = good.write(str(tmp_path / "good.json"))
    broken = tmp_path / "broken.json"
    broken.write_text('{"traceEvents": [{"name": "a", "ph": "X"}]}')
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--validate", str(broken)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout.startswith("INVALID trace")
    assert trace.main(["--validate", ok]) == 0
    assert capsys.readouterr().out.startswith("valid Chrome trace")
    assert trace.main(["--validate", str(garbage)]) == 1
    assert trace.main(["--validate", str(tmp_path / "missing.json")]) == 1


_CHILD = """
from repro_torch.obs import trace
with trace.span("child", k=1):
    trace.count("seen")
print(trace.enabled())
"""


def test_the_ports_variable_traces_a_subprocess_and_the_references_does_not(
        tmp_path):
    mine, theirs = tmp_path / "torch.json", tmp_path / "jax.json"
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=_env(REPRO_TORCH_TRACE=str(mine)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["True"], out.stderr
    summary = trace.validate_chrome_trace(str(mine))
    assert (summary["n_spans"], summary["counters"]) == (1, {"seen": 1})
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env=_env(REPRO_TRACE=str(theirs)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["False"], out.stderr
    assert not theirs.exists()
    assert trace.TRACE_ENV == "REPRO_TORCH_TRACE" != jax_trace.TRACE_ENV


def test_disabled_path_is_the_shared_noop():
    assert not trace.enabled()
    sp = trace.span("anything", heavy_arg=object())
    # one shared singleton, no allocation per call site on the hot path
    assert sp is trace.span("other") is trace._NULL_SPAN
    with sp as s:
        assert s.set(n=1) is s
    assert trace.count("c") is None
    assert trace.counters() == {}
    assert trace.write() is None
    assert trace.active() is None and trace.disable() is None


def test_module_tracer_records_the_sweep_span(tmp_path):
    try:
        t = trace.enable(str(tmp_path / "m.json"))
        assert trace.enable() is t and trace.active() is t
        sweep.sweep([1e9, 1e12], 1e8, 0.0, H100_SXM)
        trace.count("seen")
        assert trace.counters() == {"seen": 1}
        doc = t.to_dict()
    finally:
        assert trace.disable() is t
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["args"]) for e in spans] == [
        ("core.sweep", {"cells": 2})]


def test_metrics_registry_matches_the_reference():
    got, want = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for reg in (got, want):
        reg.counter("c").inc()
        reg.counter("c").inc(2)
        reg.gauge("g").set(2.5)
        for v in (1.0, 2.0, 3.0, 4.0, 10.0):
            reg.histogram("h").observe(v)
        reg.histogram("empty")
    assert got.snapshot() == want.snapshot()
    assert json.dumps(got.snapshot())
    with pytest.raises(ValueError):
        got.counter("c").inc(-1)
    with got.section("section.s"):
        pass
    assert got.gauge("section.s").value >= 0.0
    got.reset()
    assert got.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert isinstance(metrics.REGISTRY, metrics.MetricsRegistry)
    p = metrics.provenance()
    assert set(p) == {"git_sha", "hostname", "wall_clock_utc", "python",
                      "platform", "numpy", "torch", "cuda", "device"}
    assert p["numpy"] is not None and json.dumps(p)


def test_the_fit_opens_one_network_span_a_link():
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.measure.microbench import Measurement
    recs = [{"name": f"matmul_{s}", "flops": 2.0 * s ** 3,
             "mem_bytes": 12.0 * s * s, "net_bytes": 0.0,
             "seconds": 3e-6 + 2.0 * s ** 3 / 5e13, "category": "compute"}
            for s in (256, 1024, 2048)]
    for kb in (16, 4096):
        for link, n in (("net", 4), ("pod", 2)):
            wire = 2.0 * (n - 1) / n * kb * 1024
            recs.append({"name": f"ar_{kb}_{link}", "flops": 0.0,
                         "mem_bytes": 0.0, "net_bytes": wire,
                         "net_steps": 2.0 * (n - 1), "category": "network",
                         "seconds": 1e-5 + wire / 1e11,
                         "meta": {"link": link}})
    try:
        t = trace.enable()
        calibrate.fit_ceilings(
            [Measurement.from_dict(r) for r in recs],
            HardwareSpec("h", 67e12, 3.35e12, 450e9,
                         extra_links={"pod": 25e9}))
        doc = t.to_dict()
    finally:
        trace.disable()
    args = sorted((e["name"], tuple(sorted(e["args"].items())))
                  for e in doc["traceEvents"] if e["ph"] == "X")
    assert args == [
        ("calibrate.fit.compute", (("n_points", 3),)),
        ("calibrate.fit.efficiency", (("n_points", 3),)),
        ("calibrate.fit.network", (("link", "pod"), ("n_points", 2))),
        ("calibrate.fit.network", (("link", "primary"), ("n_points", 2)))]


def test_a_traced_calibration_opens_the_references_spans(tmp_path):
    path = tmp_path / "cal.json"
    try:
        trace.enable(str(path))
        assert calibrate.main(["--device", "cpu", "--smoke", "--repeats", "1",
                               "--out", str(tmp_path / "reg")]) == 0
        trace.write()
    finally:
        trace.disable()
    for validate in (trace.validate_chrome_trace,
                     jax_trace.validate_chrome_trace):
        assert validate(str(path))["max_depth"] >= 3
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"calibrate.suite", "calibrate.fit", "calibrate.fit.compute",
            "calibrate.fit.memory", "calibrate.fit.efficiency",
            "bench.suite_pass", "train.init_state"} <= names
    entry = json.loads((tmp_path / "reg" / "h100_sxm_fp32_cal.json")
                       .read_text())
    measured = [m["name"] for m in entry["measurements"]
                + entry["validation_measurements"]]
    # every bench once a pass (3 passes), each span once a bench
    benches = [e for e in spans if e["name"].startswith("bench.")
               and e["name"] != "bench.suite_pass"]
    assert sorted({e["name"] for e in benches}) == \
        sorted(f"bench.{n}" for n in measured)
    assert len(benches) == 3 * len(measured)
    args = {e["name"]: e["args"] for e in benches}
    assert args["bench.matmul_64x64x64"]["via"] == "ops"
    assert {"category", "repeats", "median_s", "best_s"} <= \
        set(args["bench.matmul_64x64x64"])
    assert args["bench.train_step_mlp_b64_w256x3"]["kind"] == "train_step"
    suite = next(e for e in spans if e["name"] == "calibrate.suite")
    assert suite["args"] == {"smoke": True, "devices": 1}
