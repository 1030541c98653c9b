"""The port's planner (``launch.plan_grid`` and ``launch.plan``) against the
JAX package's.

Three layers, each held to exact equality (the engine is the reference's
numpy over the same parameter counts, so no tolerance is needed):

  * (a) on a spec built at test time from the reference's ``TPU_V5E``
    fields, the five committed planner goldens (``tests/golden/plan_pr*``)
    come out as the reference's own tests compare them, float for float;
  * (b) on the port's ``h100_sxm`` / ``h100_sxm_fp32`` presets (the
    reference side gets a ``HardwareSpec`` of the same fields), every array
    of a ``plan_grid`` pass equals the reference's: dlrm-mlp, qwen2-7b with
    ``max_pp`` 8 and every ZeRO stage over the pod link, qwen2-moe with ep,
    with goodput priced on the preset's ``ckpt_bw``;
  * (c) the CLI: ``--json``, ``--goodput --mtbf-hours``, ``--algo all``,
    ``--hardware list`` and ``--calibrated`` print exactly what the
    reference's CLI prints when it is handed the same spec.
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
from repro.resilience.failures import FailureModel as JaxFailureModel
from repro_torch import configs
from repro_torch.core import hardware
from repro_torch.launch import plan as plan_mod
from repro_torch.launch import plan_grid as pg
from repro_torch.resilience.failures import FailureModel

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def _spec(spec, hw_mod):
    """``spec``'s field values as a HardwareSpec of ``hw_mod`` (the port's
    ``hardware`` or the reference's)."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    fields["compute_eff"] = hw_mod.EfficiencyModel(
        **spec.compute_eff.to_dict())
    return hw_mod.HardwareSpec(**fields)


def jax_spec(spec):
    return _spec(spec, jax_hw)


V5E = _spec(jax_hw.TPU_V5E, hardware)


def _golden(fname):
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        return json.load(f)


def _assert_bit_identical(plans, golden):
    """Every float of every golden plan, bit for bit (as the reference's
    ``tests/test_plan_grid.py`` compares them)."""
    assert [p.mesh for p in plans] == [g["mesh"] for g in golden["plans"]]
    for p, g in zip(plans, golden["plans"]):
        d = plan_mod._plan_dict(p)
        for key, want in g.items():
            assert d[key] == want, (p.mesh, key, want, d[key])


# --- (a) the reference's goldens on its own spec's fields ----------------------


def test_golden_dlrm_mlp_chips16():
    g = _golden("plan_pr4_dlrm_mlp_c16.json")
    cfg = configs.get_config("dlrm-mlp")
    _assert_bit_identical(plan_mod.plan(cfg, V5E, 16, batch=g["batch"]), g)
    assert plan_mod.flip_points(cfg, V5E, 16, batch=g["batch"]) == \
        g["flip_points"]
    # goodput with the default (infinite-MTBF) model changes nothing
    _assert_bit_identical(plan_mod.plan(cfg, V5E, 16, batch=g["batch"],
                                        goodput=True), g)


def test_golden_qwen2_7b_chips32_pod16():
    """The golden's comparable slice, as the reference takes it: the rows
    with tp | n_kv_heads, the capacity check off."""
    g = _golden("plan_pr4_qwen2_7b_c32_pod16.json")
    cfg = configs.get_config("qwen2-7b")
    keep = [r for r in g["plans"] if cfg.n_kv_heads % r["tp"] == 0]
    assert 3 <= len(keep) < len(g["plans"])
    plans = plan_mod.plan(cfg, V5E, 32, batch=g["batch"], seq=g["seq"],
                          pod_size=g["pod_size"], check_capacity=False)
    _assert_bit_identical(plans, dict(g, plans=keep))
    assert not any(p.fits for p in plans)


def test_golden_zero_flip_qwen2_7b_chips16():
    g = _golden("plan_pr6_qwen2_7b_c16_zero.json")
    cfg = configs.get_config("qwen2-7b")
    plans = plan_mod.plan(cfg, V5E, 16, batch=g["batch"], seq=g["seq"],
                          zero_stages=tuple(g["zero_stages"]))
    _assert_bit_identical(plans, g)
    assert plans[0].zero_stage == 2 and plans[0].fits
    free = plan_mod.plan(cfg, V5E, 16, batch=g["batch"], seq=g["seq"],
                         check_capacity=False)[0]
    assert free.mesh == plans[0].mesh and not free.fits
    assert free.runtime < plans[0].runtime


def test_golden_moe_ep_qwen2_moe_chips16():
    g = _golden("plan_pr9_qwen2_moe_c16_ep.json")
    cfg = configs.get_config("qwen2-moe-a2.7b")
    plans = plan_mod.plan(cfg, V5E, 16, batch=g["batch"], seq=g["seq"],
                          max_pp=g["max_pp"], max_ep=g["max_ep"],
                          check_capacity=False)
    _assert_bit_identical(plans, g)
    assert sum(p.ep > 1 for p in plans) >= 10


def test_golden_goodput_flip():
    g = _golden("plan_pr10_goodput_flip.json")
    fm = FailureModel(mtbf_chip_s=g["failure"]["mtbf_chip_s"],
                      restart_s=g["failure"]["restart_s"],
                      reshard_s=g["failure"]["reshard_s"])
    cfg = configs.get_config(g["arch"])
    grid = pg.plan_grid(cfg, V5E, g["chips_grid"], g["batch_grid"],
                        max_pp=g["max_pp"], goodput=True, failure=fm)
    for pt in g["points"]:
        got = plan_mod._plan_dict(grid.best(pt["chips"], pt["batch"]))
        for key, want in pt["best"].items():
            assert got[key] == want, (pt["chips"], key, want, got[key])
    priced = grid.best_runtime_grid().ravel()
    healthy = pg.plan_grid(cfg, V5E, g["chips_grid"], g["batch_grid"],
                           max_pp=g["max_pp"]).best_runtime_grid().ravel()
    assert priced[0] < priced[1] and healthy[1] < healthy[0]


# --- (b) the port's presets: plan_grid array for array --------------------------


def assert_grids_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "explain_terms" and b is not None:
            for t in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, t.name),
                                              getattr(b, t.name),
                                              err_msg=t.name)
        elif f.name == "failure" and b is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


CASES = {
    "dlrm-mlp": ("dlrm-mlp", [1, 2, 4, 8, 16, 64], [256, 1024, 4096],
                 dict(max_pp=4, algorithms=("auto", "ring", "bidir", "tree"),
                      pod_size=8)),
    "qwen2-7b-pp8-zero": ("qwen2-7b", [8, 16, 64], [16, 256],
                          dict(seq=4096, max_pp=8, zero_stages=(0, 1, 2, 3),
                               pod_size=8, remat=True)),
    "qwen2-moe-ep": ("qwen2-moe-a2.7b", [8, 16], [16, 64],
                     dict(seq=512, max_pp=2, max_ep=4,
                          zero_stages=(0, 1, 2, 3), interleave=2)),
}


@pytest.mark.parametrize("preset", ["h100_sxm", "h100_sxm_fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_grid_on_the_h100_presets_equals_the_reference(case, preset):
    arch, chips, batch, kw = CASES[case]
    hw = hardware.get_hardware(preset)
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    fm = FailureModel.from_mtbf_hours(2000.0)
    jfm = JaxFailureModel.from_mtbf_hours(2000.0)
    for extra, jextra in (({}, {}),
                          (dict(explain=True, goodput=True, failure=fm),
                           dict(explain=True, goodput=True, failure=jfm))):
        got = pg.plan_grid(cfg, hw, chips, batch, **kw, **extra)
        want = jax_pg.plan_grid(jcfg, jax_spec(hw), chips, batch, **kw,
                                **jextra)
        assert_grids_equal(got, want)
        for c in chips:
            for b in batch:
                assert [plan_mod._plan_dict(p) for p in got.plans(c, b)] == \
                    [jax_plan._plan_dict(p) for p in want.plans(c, b)]
        assert plan_mod.format_grid_table(got, top=3) == \
            jax_plan.format_grid_table(want, top=3)
    plans = got.plans(chips[0], batch[0])
    assert plan_mod.format_plan_table(plans) == \
        jax_plan.format_plan_table(want.plans(chips[0], batch[0]))


def test_capacity_cut_on_the_card():
    """One 80 GB card: what the card trains fits; qwen3-moe's 122 GB of
    fp32 params do not, pruned by default and marked with the check off."""
    hw = hardware.H100_SXM
    for arch, batch, seq in (("dlrm-mlp", 4096, 1), ("smollm-135m", 8, 512)):
        (best,) = plan_mod.plan(configs.get_config(arch), hw, 1,
                                batch=batch, seq=seq)
        assert best.fits and best.hbm_bytes < hw.hbm_capacity_bytes
    q3 = configs.get_config("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="no candidate fits"):
        plan_mod.plan(q3, hw, 1, batch=8, seq=512)
    (what_if,) = plan_mod.plan(q3, hw, 1, batch=8, seq=512,
                               check_capacity=False)
    assert not what_if.fits and what_if.hbm_bytes > 16 * 30.5e9


def test_presets_carry_the_planner_fields():
    for hw in (hardware.H100_SXM, hardware.H100_SXM_FP32):
        assert hw.bandwidth_for("pod") == 50e9
        assert hw.ckpt_bw == 1_614_374_844 / 3.130
    p = plan_mod.plan(configs.get_config("dlrm-mlp"), hardware.H100_SXM, 16,
                      batch=512, pod_size=8)
    assert {q.dp_link for q in p if q.dp > 1} == {"pod"}   # 16 chips > 8
    assert {q.tp_link for q in p if q.tp > 8} == {"pod"}
    assert {q.tp_link for q in p if q.tp <= 8} == {"ici"}


# --- (c) the CLI against the reference's, handed the same specs ---------------


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """An isolated calibration registry holding one fitted fp32 entry, and
    the reference CLI taught to resolve the port's spec names."""
    fitted = dataclasses.replace(
        hardware.H100_SXM_FP32, name="h100_sxm_fp32_cal",
        peak_flops=4.4e13, hbm_bw=2.9e12, alpha_compute=6e-6,
        alpha_memory=3e-6, compute_eff=hardware.EfficiencyModel(
            f_half=3e9, p=1.1, eff_min=0.05))
    entry = {k: v for k, v in dataclasses.asdict(fitted).items()
             if k != "model_rel_error"}
    entry.update(schema=hardware.CALIBRATION_SCHEMA, base="h100_sxm_fp32",
                 validation={"median_abs_rel_error": 0.25})
    (tmp_path / "h100_sxm_fp32_cal.json").write_text(json.dumps(entry))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR", str(tmp_path))
    monkeypatch.setattr(
        jax_plan, "get_hardware",
        lambda name, calibrated=False: jax_spec(
            hardware.get_hardware(name, calibrated=calibrated)))
    monkeypatch.setattr(jax_plan, "list_hardware", hardware.list_hardware)
    return tmp_path


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


CLI = {
    "json": ["--arch", "dlrm-mlp", "--chips", "16", "--json"],
    "table": ["--arch", "dlrm-mlp", "--chips", "16"],
    "goodput": ["--arch", "dlrm-mlp", "--chips-grid", "16,64",
                "--batch-grid", "4096", "--pp", "2", "--goodput",
                "--mtbf-hours", "1", "--json"],
    "goodput-table": ["--arch", "qwen2-7b", "--chips", "16", "--batch",
                      "16", "--seq", "1024", "--goodput", "--mtbf-hours",
                      "2000"],
    "algo-all": ["--arch", "qwen2-7b", "--chips", "8", "--algo", "all",
                 "--top", "5", "--seq", "1024", "--batch", "16"],
    "list": ["--hardware", "list"],
    "list-json": ["--hardware", "list", "--json"],
    "pod-zero": ["--arch", "qwen2-7b", "--chips", "16", "--pod-size", "8",
                 "--zero", "auto", "--batch", "8", "--seq", "128"],
    "moe-ep": ["--arch", "qwen2-moe-a2.7b", "--chips", "16", "--ep", "4",
               "--batch", "16", "--seq", "512", "--zero", "auto", "--pp",
               "2"],
    "no-capacity-check": ["--arch", "qwen3-moe-30b-a3b", "--chips", "1",
                          "--batch", "8", "--seq", "512",
                          "--no-capacity-check", "--json"],
    "calibrated-grid": ["--arch", "dlrm-mlp", "--chips-grid", "1,2,4,8",
                        "--hardware", "h100_sxm_fp32", "--calibrated",
                        "--json"],
    "calibrated-table": ["--arch", "dlrm-mlp", "--chips", "4", "--hardware",
                         "h100_sxm_fp32", "--calibrated", "--top", "3"],
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_prints_what_the_reference_prints(case, registry):
    rc, out = _run(plan_mod.main, CLI[case])
    # the reference's --hardware defaults to its TPU: name the card
    jargv = CLI[case] + ([] if "--hardware" in CLI[case]
                         else ["--hardware", "h100_sxm"])
    jrc, jout = _run(jax_plan.main, jargv)
    assert rc == jrc == 0
    assert out == jout
    if CLI[case][-1] == "--json":
        doc = json.loads(out)
        if "list" in case:
            assert set(doc) == {"h100_sxm", "h100_sxm_fp32",
                                "h100_sxm_fp32_cal"}
            assert doc["h100_sxm"]["extra_links"] == {"pod": 50e9}
        else:
            assert doc["hardware"]["name"].startswith("h100_sxm")


def test_cli_defaults_to_the_card_and_exits_2_on_bad_input(registry,
                                                           capsys):
    rc, out = _run(plan_mod.main, ["--arch", "dlrm-mlp", "--chips", "16",
                                   "--json"])
    assert rc == 0 and json.loads(out)["hardware"]["name"] == "h100_sxm"
    assert json.loads(out)["hardware"]["source"] == "datasheet"
    assert plan_mod.main(["--arch", "nope", "--chips", "4"]) == 2
    assert "unknown arch" in capsys.readouterr().err
    assert plan_mod.main(["--arch", "dlrm-mlp", "--chips", "4",
                          "--hardware", "tpu_v5e"]) == 2
    assert "unknown hardware spec 'tpu_v5e'" in capsys.readouterr().err
    assert plan_mod.main(["--arch", "dlrm-mlp", "--chips", "7"]) == 2
    assert "no feasible (dp, tp, pp, ep)" in capsys.readouterr().err
    assert plan_mod.main(["--arch", "qwen3-moe-30b-a3b", "--chips", "1",
                          "--batch", "8", "--seq", "512"]) == 2
    assert "no candidate fits" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        plan_mod.main(["--arch", "dlrm-mlp", "--chips", "4",
                       "--algo", "quantum"])
