"""Measured overlays: empirical dots + model error on reports and figures.

A copy of ``repro.measure.overlay`` over the port's calibration.  The
analytic pipeline ends in two artifact kinds — per-cell ``CellReport``
JSONs (``core/report``) and Ridgeline plane figures (``core/ridgeline``
ascii/svg).  This module closes the loop by stamping measured wall times and
model-vs-measured relative error onto both:

  * :func:`attach_measurement` fills the ``measured_*`` fields of a
    CellReport (the schema carries them as zeros until a clock has run);
  * :func:`write_measured_cells` emits one measured CellReport per
    whole-model-step validation bench of a :class:`~.calibrate.Calibration`,
    under ``<registry dir>/cells/`` (by default the port's
    ``artifacts/calibration_torch/cells/``);
  * :func:`write_calibration_figs` renders the calibration's measurements on
    the *calibrated* spec's Ridgeline plane, with each point annotated
    ``meas <wall> vs model <projection> (±err%)`` — empirical dots next to
    analytic curves, per the time-based-roofline methodology.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from repro_torch.core.hardware import calibration_dir
from repro_torch.core.report import CellReport
from repro_torch.core.ridgeline import analyze, ascii_plot, svg_plot
from repro_torch.measure.calibrate import Calibration
from repro_torch.measure.microbench import Measurement


def rel_error(model_seconds: float, measured_seconds: float) -> float:
    """(model − measured) / measured; negative = model under-predicts."""
    if measured_seconds <= 0:
        raise ValueError(f"non-positive measurement {measured_seconds}")
    return (model_seconds - measured_seconds) / measured_seconds


def attach_measurement(report: CellReport, measured_seconds: float,
                       source: str = "measured") -> CellReport:
    """Stamp a wall-clock measurement (and model error) onto a CellReport."""
    report.measured_runtime = float(measured_seconds)
    report.measured_rel_error = rel_error(report.runtime, measured_seconds)
    report.measured_source = source
    return report


def _fmt(seconds: float) -> str:
    return f"{seconds * 1e6:.0f}us" if seconds < 1e-3 else \
        f"{seconds * 1e3:.2f}ms"


def point_notes(calib: Calibration,
                measurements: Optional[Sequence[Measurement]] = None
                ) -> Dict[str, str]:
    """name -> 'meas … vs model … (±err%)' annotations for the plotters.

    When the calibration fitted a size-dependent efficiency curve, each
    point also carries its achievable-PEAK fraction ``eff(F)`` — the
    figure then shows *why* the small points sit under the ceiling.
    """
    ms = measurements if measurements is not None else (
        calib.fit_measurements + calib.validation_measurements)
    eff = calib.compute_eff

    def note(m: Measurement) -> str:
        s = (f"meas {_fmt(calib.observed_seconds(m))} vs model "
             f"{_fmt(calib.model_seconds(m))} ({calib.rel_error(m):+.0%})")
        if not eff.is_identity and m.work.flops > 0:
            s += f" eff {eff.eff(m.work.flops):.0%}"
        return s

    return {m.work.name: note(m) for m in ms}


def measured_table(reports: Sequence[CellReport]) -> str:
    """Markdown table of model-vs-measured runtimes for measured cells."""
    head = ("| arch | shape | mesh | model runtime | measured | rel err | "
            "source |\n|---|---|---|---|---|---|---|")
    rows = [head]
    for r in reports:
        if not r.measured_runtime:
            continue
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {_fmt(r.runtime)} | "
            f"{_fmt(r.measured_runtime)} | {r.measured_rel_error:+.1%} | "
            f"{r.measured_source} |")
    return "\n".join(rows)


def measured_cell_reports(calib: Calibration) -> List[CellReport]:
    """One measured CellReport per whole-model-step validation bench."""
    hw = calib.spec()
    out = []
    for m in calib.validation_measurements:
        meta = dict(m.meta)
        rep = CellReport(
            arch=meta.get("arch", m.work.name), shape=m.work.name,
            mesh="1", step_kind=meta.get("kind", "step"),
            num_devices=1, hardware=hw.name,
            flops=m.work.flops, mem_bytes=m.work.mem_bytes,
            wire_bytes=m.work.net_bytes, wire_bytes_by_kind={},
            peak_memory_per_device=0.0,
            model_flops=m.work.flops, params_total=0.0, params_active=0.0,
            tokens_per_step=0.0, variant="measured",
            notes=f"microbench validation ({m.backend})")
        rep.finalize(hw)
        # same wall-time statistic as the registry/figures, so every
        # artifact of one calibration reports one consistent rel error
        attach_measurement(
            rep, calib.observed_seconds(m),
            source=f"calibrate:{calib.name}@{m.backend}/{calib.estimator}")
        out.append(rep)
    return out


def write_measured_cells(calib: Calibration,
                         registry_dir: Optional[str] = None) -> List[str]:
    """Persist measured CellReports under <calibration dir>/cells/."""
    cdir = os.path.join(calibration_dir(registry_dir), "cells")
    return [rep.save(cdir) for rep in measured_cell_reports(calib)]


def write_calibration_figs(outdir: str, calib: Calibration) -> List[str]:
    """Ridgeline plane of the measured points on the calibrated spec.

    Every measured point draws as a hollow marker with its wall time and
    model error; the analytic regions/ridges behind them come from the
    *calibrated* ceilings, so the figure is the measured machine, not the
    datasheet cartoon.
    """
    os.makedirs(outdir, exist_ok=True)
    hw = calib.spec()
    ms = list(calib.fit_measurements) + list(calib.validation_measurements)
    analyses = [analyze(m.work, hw) for m in ms]
    notes = point_notes(calib, ms)
    paths = []
    p = os.path.join(outdir, f"calibration_{calib.name}.svg")
    with open(p, "w") as f:
        f.write(svg_plot(analyses, hw, width=880, height=560,
                         point_notes=notes))
    paths.append(p)
    p = os.path.join(outdir, f"calibration_{calib.name}.txt")
    with open(p, "w") as f:
        f.write(ascii_plot(analyses, hw, point_notes=notes))
        f.write("\n\n" + calib.summary() + "\n")
    paths.append(p)
    return paths
