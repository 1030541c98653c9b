"""The port's calibration fit and registry against ``repro.measure.calibrate``.

Both packages fit the same synthetic measurement lists (made as
``to_dict`` records and read by each package's ``Measurement.from_dict``):
an exact α–β suite, a compute suite on a Hill efficiency curve, a network
suite over the primary link and a ``pod`` link, and a noisy suite under
both estimators.  The fitted peaks, α's, ``compute_eff``, per-link
parameters, sources and errors agree within 1e-9 relative (the arithmetic
is the same code on Python floats).
"""
import json
import math

import pytest

from repro.core import hardware as jax_hw
from repro.measure import calibrate as jax_cal
from repro.measure import microbench as jax_mb
from repro_torch.core import hardware
from repro_torch.measure import calibrate, microbench

TOL = 1e-9
BASE = dict(name="h100_test", peak_flops=67e12, hbm_bw=3.35e12,
            net_bw=450e9, vmem_bytes=228 * 1024, hbm_capacity_bytes=80e9)


def _rec(name, category, flops=0.0, mem=0.0, net=0.0, steps=0.0, *,
         seconds, best=None, link=None):
    return {"name": name, "flops": flops, "mem_bytes": mem, "net_bytes": net,
            "net_steps": steps, "seconds": seconds,
            "best_seconds": best if best is not None else seconds,
            "category": category, "rel_spread": 0.01, "backend": "synthetic",
            "meta": {"link": link} if link else {}}


def _gemm(s, t_of):
    f, b = 2.0 * s ** 3, 12.0 * s * s
    return _rec(f"matmul_{s}", "compute", f, b, seconds=t_of(f))


def _stream(mb, t_of):
    b = mb * 2 ** 20 * 3.0
    return _rec(f"saxpy_{mb}", "memory", b / 6, b, seconds=t_of(b))


def _steps():
    return [_rec("train_step_a", "step", 6.7e7, 1.5e7, seconds=4e-5),
            _rec("train_step_b", "step", 1.5e9, 9.6e7, seconds=2e-4),
            _rec("serve_step_c", "step", 2.0e6, 3.0e6, seconds=3e-3)]


SIZES = (64, 128, 256, 512, 1024, 2048)


def _alpha_beta():
    recs = [_gemm(s, lambda f: 5e-6 + f / 5e13) for s in SIZES]
    recs += [_stream(mb, lambda b: 3e-6 + b / 2e12) for mb in (0.0625, 32, 64)]
    return recs + _steps(), {}


def _hill():
    eff = jax_hw.EfficiencyModel(f_half=2e8, p=0.7)
    recs = [_gemm(s, lambda f: f / (4e13 * eff.eff(f))) for s in SIZES]
    recs += [_stream(mb, lambda b: b / 2.5e12) for mb in (32, 64, 128)]
    return recs + _steps(), {}


def _network():
    recs = [_gemm(s, lambda f: 2e-6 + f / 6e13) for s in SIZES]
    recs += [_stream(mb, lambda b: 1e-6 + b / 3e12) for mb in (0.0625, 32, 64)]
    for kb in (16, 64, 256, 4096, 16384):
        p = kb * 1024.0
        for n, link, alpha, bw in ((4, "net", 8e-6, 3.5e11),
                                   (2, "pod", 2.5e-5, 2e10)):
            wire, steps = 2.0 * (n - 1) / n * p, 2.0 * (n - 1)
            recs.append(_rec(f"allreduce_{kb}kb_{link}", "network", p / 4,
                             2 * p, wire, steps, link=link,
                             seconds=alpha * steps + wire / bw))
    return recs + _steps(), {"extra_links": {"pod": 25e9}}


def _noisy():
    recs = []
    for i, s in enumerate(SIZES):
        t = 3e-6 + 2.0 * s ** 3 / 5.5e13
        recs.append(_gemm(s, lambda f, t=t, i=i: t * (1.3 + 0.05 * i)))
        recs[-1]["best_seconds"] = t * (1.0 + 0.02 * (i % 3))
    for j, mb in enumerate((0.0625, 32, 64, 128)):
        t = 2e-6 + mb * 2 ** 20 * 3 / 2.8e12
        recs.append(_stream(mb, lambda b, t=t: 1.2 * t))
        recs[-1]["best_seconds"] = t * (1.0 + 0.03 * j)
    return recs + _steps(), {}


SUITES = {"alpha_beta": _alpha_beta, "hill": _hill, "network": _network,
          "noisy": _noisy}


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=1e-300), \
            (got, want)
    else:
        assert got == want


def _fit_both(suite, estimator):
    recs, extra = SUITES[suite]()
    jm = [jax_mb.Measurement.from_dict(r) for r in recs]
    tm = [microbench.Measurement.from_dict(r) for r in recs]
    want = jax_cal.fit_ceilings(jm, jax_hw.HardwareSpec(**BASE, **extra),
                                estimator=estimator)
    got = calibrate.fit_ceilings(tm, hardware.HardwareSpec(**BASE, **extra),
                                 estimator=estimator)
    return got, want


@pytest.mark.parametrize("estimator", ["best", "median"])
@pytest.mark.parametrize("suite", sorted(SUITES))
def test_fit_ceilings_matches_jax(suite, estimator):
    got, want = _fit_both(suite, estimator)
    _close([got.peak_flops, got.hbm_bw, got.net_bw],
           [want.peak_flops, want.hbm_bw, want.net_bw])
    _close(list(got.alphas), list(want.alphas))
    _close(got.compute_eff.to_dict(), want.compute_eff.to_dict())
    _close(dict(got.link_bws), dict(want.link_bws))
    _close(dict(got.link_alphas), dict(want.link_alphas))
    assert got.sources == want.sources
    _close(got.errors("all"), want.errors("all"))
    _close(got.error_summary("validation"), want.error_summary("validation"))
    gs, ws = got.spec(), want.spec()
    _close([gs.model_rel_error, *gs.extra_links.values()],
           [ws.model_rel_error, *ws.extra_links.values()])
    gd, wd = got.to_dict(), want.to_dict()
    for d in (gd, wd):
        d.pop("provenance")
    _close(gd, wd)


def test_the_suites_reach_every_branch_of_the_fit():
    """Each suite is there for a branch: the Hill curve wins only on
    ``hill``; the pod link is measured only on ``network``."""
    ab, _ = _fit_both("alpha_beta", "best")
    assert ab.compute_eff.is_identity and ab.alpha_compute > 0
    assert math.isclose(ab.peak_flops, 5e13, rel_tol=1e-9)
    assert math.isclose(ab.alpha_memory, 3e-6, rel_tol=1e-6)
    hill, _ = _fit_both("hill", "best")
    assert not hill.compute_eff.is_identity and hill.alpha_compute == 0.0
    net, _ = _fit_both("network", "best")
    assert net.sources["net_bw"] == "measured"
    assert net.sources["link:pod"] == "measured"
    assert math.isclose(net.link_bws["pod"], 2e10, rel_tol=1e-6)
    assert ab.sources["net_bw"] == "datasheet"


def test_to_dict_has_the_jax_keys():
    got, want = _fit_both("network", "best")
    gd, wd = got.to_dict(), want.to_dict()
    assert sorted(gd) == sorted(wd)
    assert sorted(gd["measurements"][0]) == sorted(wd["measurements"][0])
    assert gd["schema"] == wd["schema"] == hardware.CALIBRATION_SCHEMA
    assert {"torch", "device"} <= set(gd["provenance"])
    assert "jax" not in gd["provenance"]


def test_summary_matches_jax():
    got, want = _fit_both("network", "best")
    assert got.summary() == want.summary()


def test_registry_round_trip(tmp_path, monkeypatch):
    got, _ = _fit_both("hill", "best")
    path = got.save(str(tmp_path))
    assert path == str(tmp_path / "h100_test_cal.json")
    spec = hardware.get_hardware("h100_test", calibrated=True,
                                 registry_dir=str(tmp_path))
    assert spec == got.spec()
    assert calibrate.load_calibration_dict(
        "h100_test_cal", str(tmp_path))["name"] == "h100_test_cal"
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR", str(tmp_path))
    assert hardware.calibration_dir() == str(tmp_path)
    assert hardware.get_hardware("h100_test_cal") == spec
    assert hardware.list_hardware() == {"h100_sxm": "datasheet",
                                        "h100_sxm_fp32": "datasheet",
                                        "clx": "datasheet",
                                        "h100_test_cal": "calibrated"}
    with pytest.raises(KeyError, match="no calibration"):
        hardware.get_hardware("h100_sxm", calibrated=True)


def test_default_registry_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION_DIR", raising=False)
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", "/nonexistent")
    d = hardware.calibration_dir()
    assert d.endswith("artifacts/calibration_torch")
    assert d != jax_hw.calibration_dir(None)


def test_save_refuses_a_preset_name(tmp_path):
    got, _ = _fit_both("alpha_beta", "best")
    import dataclasses
    with pytest.raises(ValueError, match="shadows a datasheet preset"):
        dataclasses.replace(got, name="h100_sxm").save(str(tmp_path))


def test_cli_fits_and_writes(tmp_path, monkeypatch, capsys):
    recs, _ = _alpha_beta()
    monkeypatch.setattr(
        microbench, "default_suite",
        lambda **kw: [microbench.Measurement.from_dict(r) for r in recs])
    assert calibrate.main(["--device", "cpu", "--smoke", "--out",
                           str(tmp_path), "--figures",
                           str(tmp_path / "figs")]) == 0
    out = capsys.readouterr()
    assert "NET ceiling stays datasheet" in out.err
    d = json.loads((tmp_path / "h100_sxm_fp32_cal.json").read_text())
    assert d["base"] == "h100_sxm_fp32"
    assert d["sources"]["net_bw"] == "datasheet"
    assert d["validation"]["n"] == 3
    cells = sorted((tmp_path / "cells").iterdir())
    figs = sorted((tmp_path / "figs").iterdir())
    assert [p.name for p in cells] == [
        "serve_step_c__serve_step_c__1__measured.json",
        "train_step_a__train_step_a__1__measured.json",
        "train_step_b__train_step_b__1__measured.json"]
    assert [p.name for p in figs] == ["calibration_h100_sxm_fp32_cal.svg",
                                      "calibration_h100_sxm_fp32_cal.txt"]
    for p in [tmp_path / "h100_sxm_fp32_cal.json"] + cells + figs:
        assert f"wrote {p}" in out.out
    assert calibrate.main(["--hardware", "tpu_v5e", "--out",
                           str(tmp_path)]) == 2
    assert calibrate.main(["--name", "h100_sxm", "--out",
                           str(tmp_path)]) == 2


@pytest.mark.parametrize("q", [0.0, 1.0, 1e6, 2e8, 1e12, math.inf])
def test_efficiency_model_matches_jax(q):
    for kw in ({}, {"f_half": 2e8, "p": 0.7}, {"f_half": 1e9, "p": 1.0,
                                               "eff_min": 0.05}):
        assert hardware.EfficiencyModel(**kw).eff(q) == \
            jax_hw.EfficiencyModel(**kw).eff(q)


def test_measurement_round_trips_through_a_dict():
    r = _rec("allreduce_x", "network", 1.0, 2.0, 3.0, 2.0, seconds=1e-3,
             best=9e-4, link="pod")
    m = microbench.Measurement.from_dict(r)
    assert m.link == "pod" and m.best == 9e-4
    assert m.to_dict() == jax_mb.Measurement.from_dict(r).to_dict()
