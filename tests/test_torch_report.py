"""The port's cell reports and measured overlays against ``repro.core.report``
and ``repro.measure.overlay``; the calibrate CLI's cells and figures.

Both packages build reports from the same field values and fit the same
measurement records (made as ``to_dict`` records, read by each package's
``Measurement.from_dict``; network points included, so the plane has
points to draw).  JSON, tables, notes and figure text must be byte for
byte the reference's, and a report written by either package must load in
the other.
"""
import dataclasses
import json
import os
import pathlib
import xml.etree.ElementTree as ET

import pytest

from repro.core import hardware as jax_hw
from repro.core import hlo_analysis as jax_hlo
from repro.core import report as jax_report
from repro.measure import calibrate as jax_cal
from repro.measure import microbench as jax_mb
from repro.measure import overlay as jax_overlay
from repro_torch.core import hardware, report
from repro_torch.measure import calibrate, microbench, overlay

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = hardware.H100_SXM


def jax_spec(spec):
    """The reference's HardwareSpec with the port spec's field values."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(hardware.HardwareSpec)}
    fields["compute_eff"] = jax_hw.EfficiencyModel(**spec.compute_eff.to_dict())
    return jax_hw.HardwareSpec(**fields)


def _fields(i):
    return dict(
        arch="dlrm-mlp", shape=f"train_b{256 * 4 ** i}", mesh=f"dp{2 ** i}",
        step_kind="train_step", num_devices=2 ** i, hardware="h100_sxm",
        flops=1.97e11 * 4 ** i, mem_bytes=2.7e10 + 1e9 * i,
        wire_bytes=1.07e9 * i, wire_bytes_by_kind={"all-reduce": 1.07e9 * i},
        peak_memory_per_device=6.4e9, model_flops=2.06e11 * 4 ** i * 2 ** i,
        params_total=134254593.0, params_active=134254593.0,
        tokens_per_step=256.0 * 4 ** i, notes="eager" if i else "",
        variant="counted")


def _reports(mod, spec):
    return [mod.CellReport(**_fields(i)).finalize(spec) for i in range(3)]


def test_cell_report_json_is_byte_identical_and_loads_both_ways(tmp_path):
    got, want = _reports(report, H100), _reports(jax_report, jax_spec(H100))
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()
        overlay.attach_measurement(g, 0.0135, source="chip_smoke")
        jax_overlay.attach_measurement(w, 0.0135, source="chip_smoke")
        assert g.to_json() == w.to_json()
        g.save(str(tmp_path / "port"))
        w.save(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    from_jax = report.load_reports(str(tmp_path / "jax"))
    from_port = jax_report.load_reports(str(tmp_path / "port"))
    assert [r.to_json() for r in from_jax] == [r.to_json() for r in from_port]
    assert {r.to_json() for r in from_jax} == {g.to_json() for g in got}
    assert report.load_reports(str(tmp_path / "none")) == []
    a, ja = got[1].analysis(), want[1].analysis(jax_spec(H100))
    assert a.summary() == ja.summary()


def test_make_cell_report_and_tables_match_jax():
    ops = [jax_hlo.CollectiveOp("all-reduce", 5.4e8, 8, 9.4e8),
           jax_hlo.CollectiveOp("all-reduce", 4e3, 8, 7e3),
           jax_hlo.CollectiveOp("all-gather", 2e6, 8, 1.75e6)]
    by_kind = {k: b for k, (_, b) in
               jax_hlo.CollectiveSummary(ops).by_kind().items()}
    common = dict(arch="dlrm-mlp", shape="train_b1024", mesh="dp8",
                  step_kind="train_step", model_flops=6.6e12,
                  params_total=1.3e8, params_active=1.3e8,
                  tokens_per_step=8192.0, variant="counted",
                  notes="counted", wall_compile_s=0.5)
    costs = report.StepCosts(
        flops=7.9e11, mem_bytes=2.8e10, wire_bytes=sum(by_kind.values()),
        wire_bytes_by_kind=by_kind, peak_memory_per_device=6.4e9,
        num_devices=8)
    jcosts = jax_hlo.StepCosts(
        flops=7.9e11, mem_bytes=2.8e10, wire_bytes=sum(by_kind.values()),
        collectives=jax_hlo.CollectiveSummary(ops),
        peak_memory_per_device=6.4e9, num_devices=8)
    got = report.make_cell_report(costs=costs, hw=H100, **common)
    want = jax_report.make_cell_report(costs=jcosts, hw=jax_spec(H100),
                                       **common)
    assert got.to_json() == want.to_json()
    assert got.peak_memory_corrected == costs.peak_memory_per_device
    assert costs.total_flops == jcosts.total_flops
    reps = [got] + _reports(report, H100)
    jreps = [want] + _reports(jax_report, jax_spec(H100))
    assert report.roofline_table(reps) == jax_report.roofline_table(jreps)
    assert report.dryrun_table(reps) == jax_report.dryrun_table(jreps)


def _rec(name, category, flops, mem, net=0.0, steps=0.0, *, seconds,
         link=None, meta=None):
    return {"name": name, "flops": flops, "mem_bytes": mem, "net_bytes": net,
            "net_steps": steps, "seconds": seconds * 1.1,
            "best_seconds": seconds, "category": category,
            "rel_spread": 0.01, "backend": "synthetic",
            "meta": dict(meta or {}, **({"link": link} if link else {}))}


def _records(hill: bool):
    eff = jax_hw.EfficiencyModel(f_half=2e8, p=0.7)
    recs = [_rec(f"matmul_{s}", "compute", 2.0 * s ** 3, 12.0 * s * s,
                 seconds=(2.0 * s ** 3 / (4e13 * eff.eff(2.0 * s ** 3))
                          if hill else 3e-6 + 2.0 * s ** 3 / 5e13))
            for s in (64, 128, 256, 512, 1024, 2048)]
    recs += [_rec(f"saxpy_{mb}mb", "memory", mb * 2 ** 19, mb * 3.0 * 2 ** 20,
                  seconds=2e-6 + mb * 3.0 * 2 ** 20 / 3e12)
             for mb in (1, 32, 64)]
    for kb in (16, 256, 4096):
        p = kb * 1024.0
        for n, link, alpha, bw in ((4, "net", 8e-6, 3.5e11),
                                   (2, "pod", 2.5e-5, 2e10)):
            wire, steps = 2.0 * (n - 1) / n * p, 2.0 * (n - 1)
            recs.append(_rec(f"allreduce_{kb}kb_{link}", "network", p / 4,
                             2 * p, wire, steps, link=link,
                             seconds=alpha * steps + wire / bw))
    recs += [_rec("train_step_mlp_b64_w256x3", "step", 6.7e7, 1.5e7,
                  seconds=4e-5, meta={"kind": "train_step",
                                      "arch": "dlrm-mlp"}),
             _rec("train_step_mlp_b256_w512x4", "step", 1.5e9, 9.6e7,
                  seconds=2e-4, meta={"kind": "train_step",
                                      "arch": "dlrm-mlp"}),
             _rec("serve_step_smollm_b8", "step", 2.0e6, 3.0e6,
                  seconds=3e-3, meta={"kind": "serve_step",
                                      "arch": "smollm-135m"})]
    return recs


def _fit_both(hill):
    base = dict(name="h100_sxm_fp32", peak_flops=67e12, hbm_bw=3.35e12,
                net_bw=450e9, extra_links={"pod": 25e9},
                vmem_bytes=228 * 1024, hbm_capacity_bytes=80e9)
    recs = _records(hill)
    got = calibrate.fit_ceilings(
        [microbench.Measurement.from_dict(r) for r in recs],
        hardware.HardwareSpec(**base))
    want = jax_cal.fit_ceilings(
        [jax_mb.Measurement.from_dict(r) for r in recs],
        jax_hw.HardwareSpec(**base))
    return got, want


@pytest.mark.parametrize("hill", [False, True], ids=["alpha_beta", "hill"])
def test_overlay_matches_jax(hill, tmp_path):
    got, want = _fit_both(hill)
    assert got.compute_eff.is_identity is (not hill)
    assert overlay.point_notes(got) == jax_overlay.point_notes(want)
    cells = overlay.measured_cell_reports(got)
    jcells = jax_overlay.measured_cell_reports(want)
    assert len(cells) == 3
    assert [c.to_json() for c in cells] == [c.to_json() for c in jcells]
    for c, m in zip(cells, got.validation_measurements):
        assert c.measured_rel_error == got.rel_error(m)
    assert overlay.measured_table(cells) == jax_overlay.measured_table(jcells)
    paths = overlay.write_measured_cells(got, registry_dir=str(tmp_path / "p"))
    jpaths = jax_overlay.write_measured_cells(want,
                                              registry_dir=str(tmp_path / "j"))
    assert [pathlib.Path(p).read_text() for p in paths] == \
        [pathlib.Path(p).read_text() for p in jpaths]
    figs = overlay.write_calibration_figs(str(tmp_path / "pf"), got)
    jfigs = jax_overlay.write_calibration_figs(str(tmp_path / "jf"), want)
    assert [os.path.basename(p) for p in figs] == \
        ["calibration_h100_sxm_fp32_cal.svg",
         "calibration_h100_sxm_fp32_cal.txt"]
    for p, jp in zip(figs, jfigs):
        assert pathlib.Path(p).read_text() == pathlib.Path(jp).read_text()
    svg = pathlib.Path(figs[0]).read_text()
    ET.fromstring(svg)
    # the six all-reduces ride the wire; the single-chip benches sit at
    # x = B_M / B_N = inf, off the plane
    assert svg.count('class="measured"') == 6
    assert overlay.rel_error(2.0, 1.0) == jax_overlay.rel_error(2.0, 1.0)
    with pytest.raises(ValueError, match="non-positive"):
        overlay.rel_error(1.0, 0.0)


def _tree(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


def test_cli_writes_entry_cells_and_figures_on_the_cpu(tmp_path):
    before = _tree(ROOT / "artifacts")
    out, figs = tmp_path / "calibration_torch", tmp_path / "figures_torch"
    assert calibrate.main(["--device", "cpu", "--smoke", "--repeats", "1",
                           "--out", str(out), "--figures", str(figs)]) == 0
    assert _tree(ROOT / "artifacts") == before
    entry = json.loads((out / "h100_sxm_fp32_cal.json").read_text())
    steps = entry["validation_measurements"]
    assert [m["name"] for m in steps] == [
        "train_step_mlp_b64_w256x3", "train_step_mlp_b256_w512x4",
        "serve_step_smollm_b8"]
    cells = report.load_reports(str(out / "cells"))
    assert sorted(c.shape for c in cells) == sorted(m["name"] for m in steps)
    assert all(c.variant == "measured" and c.measured_runtime > 0
               for c in cells)
    assert sorted(os.listdir(figs)) == ["calibration_h100_sxm_fp32_cal.svg",
                                        "calibration_h100_sxm_fp32_cal.txt"]
    ET.fromstring((figs / "calibration_h100_sxm_fp32_cal.svg").read_text())
    txt = (figs / "calibration_h100_sxm_fp32_cal.txt").read_text()
    assert txt.startswith("Ridgeline plane for h100_sxm_fp32_cal")
    assert "calibration h100_sxm_fp32_cal (base h100_sxm_fp32" in txt


def test_cli_figure_directory_follows_the_reference_rule(
        tmp_path, monkeypatch):
    """Figures go beside the registry, into figures_torch/, when --out is not
    given; with --out and no --figures there are none (the reference's rule).
    """
    recs = _records(hill=True)
    monkeypatch.setattr(
        microbench, "default_suite",
        lambda **kw: [microbench.Measurement.from_dict(r) for r in recs])
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR",
                       str(tmp_path / "registry"))
    assert calibrate.main(["--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["figures_torch", "registry"]
    assert len(os.listdir(tmp_path / "figures_torch")) == 2
    assert len(os.listdir(tmp_path / "registry" / "cells")) == 3
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION_DIR")
    assert calibrate.main(["--device", "cpu", "--out",
                           str(tmp_path / "other")]) == 0
    assert sorted(os.listdir(tmp_path)) == ["figures_torch", "other",
                                            "registry"]
    assert sorted(os.listdir(tmp_path / "other")) == [
        "cells", "h100_sxm_fp32_cal.json"]
    assert len(os.listdir(tmp_path / "figures_torch")) == 2
