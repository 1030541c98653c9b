"""The port's cost attribution (``obs.explain``) against ``repro.obs.explain``.

The qwen2-7b / 16-chip / ZeRO golden comes out of the port key for key on a
spec of the reference's ``TPU_V5E`` fields; on the port's presets (and a
fitted spec with α terms and an efficiency curve) every candidate's
breakdown sums to its step time, ``explain=True`` leaves every priced array
as it was, and the table, the prune line and the ``--explain`` CLI print
what the reference prints for the same grid.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core import hardware as jax_hw
from repro.launch import plan as jax_plan
from repro.launch import plan_grid as jax_pg
from repro.obs import explain as jax_explain
from repro_torch import configs
from repro_torch.core import hardware
from repro_torch.launch import plan as plan_mod
from repro_torch.launch import plan_grid as pg
from repro_torch.obs import explain, trace

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "explain_qwen2_7b_c16_zero.json")
QWEN = dict(seq=128, zero_stages=(0, 1, 2, 3))


def _spec(spec, hw_mod):
    """``spec``'s field values as a HardwareSpec of ``hw_mod``."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    fields["compute_eff"] = hw_mod.EfficiencyModel(
        **spec.compute_eff.to_dict())
    return hw_mod.HardwareSpec(**fields)


V5E = _spec(jax_hw.TPU_V5E, hardware)
FITTED = dataclasses.replace(
    hardware.H100_SXM, name="h100_fitted", alpha_compute=6e-6,
    alpha_memory=3e-6, alpha_network=2e-5, link_alphas={"pod": 5e-5},
    compute_eff=hardware.EfficiencyModel(f_half=3e9, p=1.1, eff_min=0.05),
    model_rel_error=0.25)


def _qwen_grid(hw=V5E, **kw):
    return pg.plan_grid(configs.get_config("qwen2-7b"), hw, [16], [8],
                        **QWEN, **kw)


def test_golden_reproduced_on_the_reference_fields():
    got = json.loads(explain.to_json(_qwen_grid(explain=True)))
    with open(GOLDEN) as f:
        assert got == json.load(f)
    assert explain.EXPLAIN_SCHEMA == jax_explain.EXPLAIN_SCHEMA


@pytest.mark.parametrize("hw", [hardware.H100_SXM, hardware.H100_SXM_FP32,
                                FITTED], ids=lambda h: h.name)
def test_breakdown_terms_sum_to_the_step(hw):
    cfg = configs.get_config("dlrm-mlp")
    grid = pg.plan_grid(cfg, hw, [1, 8, 16], [512, 4096], max_pp=4,
                        zero_stages=(0, 1), pod_size=8, explain=True,
                        goodput=True)
    d = explain.explain_dict(grid)
    n = 0
    for point in d["points"]:
        for rec in point["candidates"]:
            assert sum(rec["breakdown"].values()) == \
                pytest.approx(rec["runtime"], rel=1e-9), rec["mesh"]
            t = rec["terms"]
            assert t["compute"]["alpha"] + t["compute"]["flops"] == \
                pytest.approx(rec["t_compute"], rel=1e-9)
            assert t["memory"]["alpha"] + t["memory"]["bytes"] == \
                pytest.approx(rec["t_memory"], rel=1e-9)
            assert sum(ax["total"] for ax in t["network"].values()) == \
                pytest.approx(rec["t_network"], rel=1e-9)
            n += 1
    assert n == grid.n_candidates
    jgrid = jax_pg.plan_grid(jax_configs.get_config("dlrm-mlp"),
                             _spec(hw, jax_hw), [1, 8, 16], [512, 4096],
                             max_pp=4, zero_stages=(0, 1), pod_size=8,
                             explain=True, goodput=True)
    assert d == jax_explain.explain_dict(jgrid)


@pytest.mark.parametrize("hw", [V5E, hardware.H100_SXM], ids=["v5e", "h100"])
def test_explain_off_by_default_and_bit_identical(hw):
    g0 = _qwen_grid(hw)
    assert g0.explain_terms is None and g0.prune_reasons is None
    with pytest.raises(ValueError, match="explain=True"):
        explain.explain_dict(g0)
    g1 = _qwen_grid(hw, explain=True)
    for f in ("runtime", "t_compute", "t_memory", "t_network", "n_pruned",
              "hbm_bytes", "bottleneck", "runtime_hi"):
        np.testing.assert_array_equal(getattr(g0, f), getattr(g1, f))


def test_table_and_prune_line_equal_the_reference():
    grid = _qwen_grid(explain=True)
    jgrid = jax_pg.plan_grid(jax_configs.get_config("qwen2-7b"),
                             jax_hw.TPU_V5E, [16], [8], **QWEN, explain=True)
    point = explain.explain_point(grid)
    table = explain.format_explain_table(point["candidates"])
    line = explain.format_prune_reasons(point)
    jpoint = jax_explain.explain_point(jgrid)
    assert table == jax_explain.format_explain_table(jpoint["candidates"])
    assert line == jax_explain.format_prune_reasons(jpoint)
    assert "step ms" in table and "dp4xtp4" in table
    assert "capacity=5" in line and "ZeRO-2" in line
    assert point["prune_reasons"]["capacity"] == int(grid.n_pruned.sum())
    # the ep columns appear only with an ep axis
    moe = pg.plan_grid(configs.get_config("qwen2-moe-a2.7b"),
                       hardware.H100_SXM, [16], [16], seq=512, max_ep=4,
                       zero_stages=(0, 1, 2, 3), explain=True)
    assert "epα ms" in explain.format_explain_table(
        explain.explain_point(moe)["candidates"])


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-7b", "--chips", "16", "--batch", "8", "--seq", "128",
     "--zero", "auto", "--explain"],
    ["--arch", "dlrm-mlp", "--chips-grid", "1,2,4,8", "--explain", "--json"],
], ids=["table", "grid-json"])
def test_explain_cli_equals_the_reference(argv, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR", str(tmp_path))
    monkeypatch.setattr(jax_plan, "get_hardware",
                        lambda name, calibrated=False: _spec(
                            hardware.get_hardware(name), jax_hw))
    monkeypatch.setattr(jax_plan, "list_hardware", hardware.list_hardware)
    rc, out = _run(plan_mod.main, argv)
    jrc, jout = _run(jax_plan.main, argv + ["--hardware", "h100_sxm"])
    assert rc == jrc == 0 and out == jout
    assert "explain" in out


def test_traced_cli_spans_and_counters(tmp_path):
    path = str(tmp_path / "plan.trace.json")
    try:
        rc, out = _run(plan_mod.main, [
            "--arch", "dlrm-mlp", "--chips-grid", "1,2,4,8", "--explain",
            "--json", "--trace", path])
    finally:
        trace.disable()
    assert rc == 0
    doc = json.loads(out)
    assert doc["explain"]["schema"] == explain.EXPLAIN_SCHEMA
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    trace.validate_chrome_trace(path)
    names = {e["name"] for e in events}
    assert {"plan_grid", "plan_grid.enumerate", "plan_grid.feasibility",
            "plan_grid.price_collectives", "plan_grid.sweep_classify",
            "core.sweep", "planner.candidates_enumerated",
            "planner.candidates_evaluated"} <= names
