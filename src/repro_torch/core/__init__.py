"""Ridgeline core, copied from ``repro.core`` (the port imports nothing of
``repro``): the paper's 2D distributed roofline model on the H100.

Public API:
  HardwareSpec / H100_SXM / H100_SXM_FP32 — the card's resource books
  WorkUnit / analyze / RidgelineAnalysis — the model itself
  classify_by_quadrant / classify_by_times — the two (equivalent) classifiers
  StepCosts / CellReport / roofline_table — the cell report schema + emitters
  sweep / SweepResult — vectorized Ridgeline over whole scenario grids

The reference's HLO-derived work units (``core/hlo_analysis``) have no
counterpart: ``measure/counters`` counts F and B_M of the eager program.
"""
from repro_torch.core.hardware import (H100_SXM, H100_SXM_FP32, HardwareSpec,
                                       get_hardware)
from repro_torch.core.report import (CellReport, StepCosts, dryrun_table,
                                     load_reports, make_cell_report,
                                     roofline_table)
from repro_torch.core.ridgeline import (Resource, RidgelineAnalysis, WorkUnit,
                                        analyze, analyze_multilink, ascii_plot,
                                        classify_by_quadrant,
                                        classify_by_times, region_at, svg_plot)
from repro_torch.core import roofline, sweep
from repro_torch.core.sweep import SweepResult

__all__ = [
    "H100_SXM", "H100_SXM_FP32", "HardwareSpec", "get_hardware",
    "CellReport", "StepCosts", "dryrun_table", "load_reports",
    "make_cell_report", "roofline_table",
    "Resource", "RidgelineAnalysis", "WorkUnit", "analyze",
    "analyze_multilink", "ascii_plot", "classify_by_quadrant",
    "classify_by_times", "region_at", "svg_plot", "roofline",
    "sweep", "SweepResult",
]
