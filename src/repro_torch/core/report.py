"""Ridgeline reports: the per-cell artifact schema and markdown emitters.

A copy of ``repro.core.report``.  A *cell* = (architecture, input shape,
mesh).  A ``CellReport`` JSON carries one cell's per-device costs, its
Ridgeline placement and, once a clock has run, its measured time; the
JSON keys and text are the reference's, so a report written by either
package loads in the other.

The reference fills a report from XLA's compiled program
(``core/hlo_analysis.StepCosts``).  The port's :class:`StepCosts` holds the
same fields the report reads, filled by ``measure/counters.count`` (F and
B_M of the eager step) and the collectives' cost model (wire bytes); with
no XLA:CPU float-normalisation artifact to correct, a report's
``peak_memory_corrected`` is its raw peak.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.core.hardware import HardwareSpec, get_hardware
from repro_torch.core.ridgeline import RidgelineAnalysis, WorkUnit, analyze


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Per-device costs of one step, the fields a ``CellReport`` reads."""

    flops: float                     # per-device F
    mem_bytes: float                 # per-device B_M
    wire_bytes: float                # per-device collective wire bytes
    wire_bytes_by_kind: Mapping[str, float]   # collective kind -> wire bytes
    peak_memory_per_device: float    # bytes
    num_devices: int

    @property
    def total_flops(self) -> float:
        return self.flops * self.num_devices


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str                      # train_4k / prefill_32k / decode_32k / long_500k
    mesh: str                       # "16x16" | "2x16x16"
    step_kind: str                  # train_step | serve_step
    num_devices: int
    hardware: str
    # per-device terms
    flops: float
    mem_bytes: float
    wire_bytes: float
    wire_bytes_by_kind: Dict[str, float]
    peak_memory_per_device: float
    # model-level accounting
    model_flops: float              # 6*N*D (dense) or 6*N_active*D (MoE), total
    params_total: float
    params_active: float
    tokens_per_step: float
    # derived (filled by finalize)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_network: float = 0.0
    bottleneck: str = ""
    runtime: float = 0.0
    peak_fraction: float = 0.0
    useful_flops_ratio: float = 0.0   # MODEL_FLOPS / (per-dev flops * devices)
    i_arithmetic: float = 0.0
    i_memory: float = 0.0
    i_network: float = 0.0
    notes: str = ""
    variant: str = "baseline"       # baseline | <optimization tag>
    wall_compile_s: float = 0.0
    #: the reference's XLA:CPU-corrected peak memory; the port has no such
    #: artifact, so its reports carry the raw peak here
    peak_memory_corrected: float = 0.0
    # ---- empirical overlay (measure/overlay): 0/"" until a clock has run ----
    measured_runtime: float = 0.0     # wall seconds of the real step; the
                                      # statistic (best/median) is named in
                                      # measured_source
    measured_rel_error: float = 0.0   # (model runtime − measured) / measured
    measured_source: str = ""         # e.g. "calibrate:h100_sxm_fp32_cal@cpu/best"

    def finalize(self, hw: HardwareSpec) -> "CellReport":
        wu = WorkUnit(f"{self.arch}/{self.shape}", self.flops, self.mem_bytes,
                      self.wire_bytes)
        a = analyze(wu, hw)
        self.t_compute, self.t_memory, self.t_network = (
            a.t_compute, a.t_memory, a.t_network)
        self.bottleneck = a.bottleneck.value
        self.runtime = a.runtime
        self.peak_fraction = a.peak_fraction
        self.i_arithmetic = a.y
        self.i_memory = a.x
        self.i_network = wu.network_intensity
        total_flops = self.flops * self.num_devices
        self.useful_flops_ratio = (
            self.model_flops / total_flops if total_flops else 0.0)
        return self

    def analysis(self, hw: Optional[HardwareSpec] = None) -> RidgelineAnalysis:
        hw = hw or get_hardware(self.hardware)
        return analyze(
            WorkUnit(f"{self.arch}/{self.shape}@{self.mesh}",
                     self.flops, self.mem_bytes, self.wire_bytes), hw)

    # ---- persistence ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "CellReport":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(CellReport)}
        return CellReport(**{k: v for k, v in d.items() if k in known})

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"{self.arch}__{self.shape}__{self.mesh}__{self.variant}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        return path


def load_reports(directory: str) -> List[CellReport]:
    out: List[CellReport] = []
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".json"):
            with open(os.path.join(directory, fn)) as f:
                out.append(CellReport.from_json(f.read()))
    return out


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.3f}s"


def make_cell_report(
    *, arch: str, shape: str, mesh: str, step_kind: str,
    costs: StepCosts, hw: HardwareSpec, model_flops: float,
    params_total: float, params_active: float, tokens_per_step: float,
    variant: str = "baseline", notes: str = "", wall_compile_s: float = 0.0,
) -> CellReport:
    rep = CellReport(
        arch=arch, shape=shape, mesh=mesh, step_kind=step_kind,
        num_devices=costs.num_devices, hardware=hw.name,
        flops=costs.flops, mem_bytes=costs.mem_bytes,
        wire_bytes=costs.wire_bytes,
        wire_bytes_by_kind=dict(costs.wire_bytes_by_kind),
        peak_memory_per_device=costs.peak_memory_per_device,
        peak_memory_corrected=costs.peak_memory_per_device,
        model_flops=model_flops, params_total=params_total,
        params_active=params_active, tokens_per_step=tokens_per_step,
        variant=variant, notes=notes, wall_compile_s=wall_compile_s,
    )
    return rep.finalize(hw)


ROOFLINE_HEADER = (
    "| arch | shape | mesh | step | t_compute | t_memory | t_network | "
    "bottleneck | bound runtime | peak frac | useful/HLO | bytes/dev | notes |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
)


def roofline_row(r: CellReport) -> str:
    return (
        f"| {r.arch} | {r.shape} | {r.mesh} | {r.step_kind} | "
        f"{_fmt_s(r.t_compute)} | {_fmt_s(r.t_memory)} | {_fmt_s(r.t_network)} | "
        f"**{r.bottleneck}** | {_fmt_s(r.runtime)} | {100 * r.peak_fraction:.1f}% | "
        f"{r.useful_flops_ratio:.2f} | "
        f"{(r.peak_memory_corrected or r.peak_memory_per_device) / 2**30:.2f} GiB | "
        f"{r.notes} |"
    )


def roofline_table(reports: Sequence[CellReport]) -> str:
    rows = [ROOFLINE_HEADER]
    rows += [roofline_row(r) for r in reports]
    return "\n".join(rows)


def dryrun_table(reports: Sequence[CellReport]) -> str:
    head = (
        "| arch | shape | mesh | devices | HLO GFLOPs/dev | HBM GB/dev | "
        "wire GB/dev | peak mem GiB/dev | collectives |\n"
        "|---|---|---|---|---|---|---|---|---|"
    )
    rows = [head]
    for r in reports:
        kinds = ", ".join(
            f"{k}:{v / 2**30:.2f}GiB" for k, v in sorted(r.wire_bytes_by_kind.items()))
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.num_devices} | "
            f"{r.flops / 1e9:.1f} | {r.mem_bytes / 1e9:.2f} | "
            f"{r.wire_bytes / 1e9:.3f} | {r.peak_memory_per_device / 2**30:.2f} | "
            f"{kinds or '-'} |")
    return "\n".join(rows)
