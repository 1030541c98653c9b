"""The Ridgeline model (paper §II), copied from ``repro.core.ridgeline``.

A *work unit* is characterized by F (FLOPs), B_M (memory bytes) and B_N
(network bytes).  On a machine (``HardwareSpec``) its resource times are

    t_C = α_C + F / (PEAK · eff(F))   (α_C only when F > 0)
    t_M = α_M + B_M / HBM     (α_M only when B_M > 0)
    t_N = α_N · steps + B_N / NET

its bottleneck is the argmax (ties COMPUTE > MEMORY > NETWORK), and the
least time it can take is ``max(t_C, t_M, t_N)``.  The plane coordinates are
x = I_M = B_M / B_N and y = I_A = F / B_M.  ``eff`` is the spec's
``compute_eff`` curve: the identity on datasheet specs, fitted by the
calibration.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

from repro_torch.core.hardware import HardwareSpec


class Resource(enum.Enum):
    COMPUTE = "compute"
    MEMORY = "memory"
    NETWORK = "network"


def _safe_div(a: float, b: float) -> float:
    if b == 0:
        return math.inf if a > 0 else 0.0
    return a / b


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """The three Ridgeline characteristics of a kernel / step / program,
    per compute entity (per chip)."""

    name: str
    flops: float          # F
    mem_bytes: float      # B_M
    net_bytes: float      # B_N  (wire bytes per chip; 0 for single-chip work)
    net_steps: float = 0.0  # serialized network hops (the α multiplier)

    def __post_init__(self):
        if self.flops < 0 or self.mem_bytes < 0 or self.net_bytes < 0 \
                or self.net_steps < 0:
            raise ValueError(f"negative resource count in {self}")

    @property
    def arithmetic_intensity(self) -> float:
        """I_A = F / B_M (FLOP per memory byte) — the y axis."""
        return _safe_div(self.flops, self.mem_bytes)

    @property
    def memory_intensity(self) -> float:
        """I_M = B_M / B_N (memory byte per network byte) — the x axis."""
        return _safe_div(self.mem_bytes, self.net_bytes)

    @property
    def network_intensity(self) -> float:
        """I_N = F / B_N = I_A · I_M (FLOP per network byte)."""
        return _safe_div(self.flops, self.net_bytes)


@dataclasses.dataclass(frozen=True)
class RidgelineAnalysis:
    """Full placement of one WorkUnit on one machine."""

    work: WorkUnit
    hw: HardwareSpec
    t_compute: float                 # seconds
    t_memory: float
    t_network: float
    bottleneck: Resource
    runtime: float                   # max of the three times (projected bound)
    attained_flops: float            # F / runtime
    peak_fraction: float             # attained / peak == t_compute / runtime
    x: float                         # I_M
    y: float                         # I_A

    def summary(self) -> str:
        return (
            f"{self.work.name}: I_A={self.y:.3g} I_M={self.x:.3g} "
            f"I_N={self.work.network_intensity:.3g} | "
            f"t_C={self.t_compute:.3e}s t_M={self.t_memory:.3e}s "
            f"t_N={self.t_network:.3e}s -> {self.bottleneck.value.upper()} "
            f"bound, {100 * self.peak_fraction:.1f}% of peak"
        )


def resource_times(work: WorkUnit, hw: HardwareSpec,
                   link: Optional[str] = None
                   ) -> Tuple[float, float, float]:
    """The α-aware (t_C, t_M, t_N); α's of 0 give the paper's pure-β times.

    ``link`` names the network link the wire bytes rode (None = primary).
    The compute ceiling is ``PEAK · eff(F)`` (``hw.compute_eff``); the
    identity curve multiplies by exactly 1.0, so a spec without a fitted
    curve prices times as a constant ceiling does, bit for bit.
    """
    t_c = (hw.alpha_compute if work.flops > 0 else 0.0) + \
        _safe_div(work.flops,
                  hw.peak_flops * hw.compute_eff.eff(work.flops))
    t_m = (hw.alpha_memory if work.mem_bytes > 0 else 0.0) + \
        _safe_div(work.mem_bytes, hw.hbm_bw)
    t_n = hw.alpha_for(link) * work.net_steps + \
        _safe_div(work.net_bytes, hw.bandwidth_for(link))
    return t_c, t_m, t_n


def _classify_times(t_c: float, t_m: float, t_n: float) -> Resource:
    """Argmax of three times, COMPUTE > MEMORY > NETWORK on ties."""
    if t_c >= t_m:
        return Resource.COMPUTE if t_c >= t_n else Resource.NETWORK
    return Resource.MEMORY if t_m >= t_n else Resource.NETWORK


def analyze(work: WorkUnit, hw: HardwareSpec) -> RidgelineAnalysis:
    t_c, t_m, t_n = resource_times(work, hw)
    runtime = max(t_c, t_m, t_n)
    attained = _safe_div(work.flops, runtime) if runtime > 0 else 0.0
    return RidgelineAnalysis(
        work=work,
        hw=hw,
        t_compute=t_c,
        t_memory=t_m,
        t_network=t_n,
        bottleneck=_classify_times(t_c, t_m, t_n),
        runtime=runtime,
        attained_flops=attained,
        peak_fraction=_safe_div(attained, hw.peak_flops),
        x=work.memory_intensity,
        y=work.arithmetic_intensity,
    )
