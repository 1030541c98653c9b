"""Classic (single-node) Roofline model [Williams et al., CACM'09], copied
from ``repro.core.roofline``.

Kept as a separate module both because the paper builds on it (§I) and
because the Ridgeline reduces to it when B_N -> 0.  Includes the
"memory-network roofline" variant the paper introduces in Fig. 2b.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    name: str
    intensity: float          # FLOP / byte
    attainable_flops: float   # min(peak, intensity * bw)
    bound: str                # "compute" | "memory"


def attainable(intensity: float, hw: HardwareSpec) -> float:
    """Attainable FLOP/s at the given arithmetic intensity."""
    return min(hw.peak_flops, intensity * hw.hbm_bw)


def classify(intensity: float, hw: HardwareSpec) -> str:
    return "compute" if intensity >= hw.ridge_arithmetic else "memory"


def point(name: str, flops: float, mem_bytes: float, hw: HardwareSpec) -> RooflinePoint:
    i = flops / mem_bytes if mem_bytes else float("inf")
    return RooflinePoint(name, i, attainable(i, hw), classify(i, hw))


def memory_network_attainable(mem_intensity: float, hw: HardwareSpec) -> float:
    """Paper Fig. 2b: attainable *memory bandwidth* vs I_M = B_M/B_N.

    For low memory intensity the achievable memory throughput is limited by
    the network feeding it (I_M * net_bw); it saturates at hbm_bw.
    """
    return min(hw.hbm_bw, mem_intensity * hw.net_bw)


def memory_network_classify(mem_intensity: float, hw: HardwareSpec) -> str:
    return "memory" if mem_intensity >= hw.ridge_memory else "network"


def sweep(intensities: Sequence[float], hw: HardwareSpec) -> List[Tuple[float, float]]:
    return [(i, attainable(i, hw)) for i in intensities]
