"""Hardware resource book for Ridgeline analysis on the port's card.

A minimal copy of ``repro.core.hardware.HardwareSpec``: the per-chip peaks
the Ridgeline model divides by, the α (latency) terms of the α–β
extension, and the device-memory capacity.  The size-dependent efficiency
model of the reference is the identity here and is left out; calibrated
specs come with a later slice.

The presets are NVIDIA's datasheet numbers for one H100 SXM; each names its
source.  They are peaks at the card's full 700 W power limit: a card set
below it runs slower under load, so every measurement against them is
reported with the card's power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip resource peaks used as Ridgeline balance points.

    Attributes:
      name: identifier.
      peak_flops: peak compute throughput, FLOP/s, in the dtype of interest.
      hbm_bw: device-memory bandwidth, bytes/s.
      net_bw: primary network bandwidth, bytes/s per chip each way.
      extra_links: optional named slower links, bytes/s, keyed by mesh-axis
        tag.
      alpha_compute: fixed dispatch overhead per work-unit execution, s.
      alpha_memory: fixed per-execution memory-system overhead, s.
      alpha_network: per-hop network latency, s per serialized step.
      hbm_capacity_bytes: device-memory capacity per chip; 0 = unknown.
    """

    name: str
    peak_flops: float
    hbm_bw: float
    net_bw: float
    extra_links: Mapping[str, float] = dataclasses.field(default_factory=dict)
    alpha_compute: float = 0.0
    alpha_memory: float = 0.0
    alpha_network: float = 0.0
    hbm_capacity_bytes: float = 0.0

    # ---- machine balance points (paper §II, Fig. 2) -------------------------
    @property
    def ridge_arithmetic(self) -> float:
        """y* = Peak / HBM_bw: the classic roofline ridge (FLOP/mem-byte)."""
        return self.peak_flops / self.hbm_bw

    @property
    def ridge_memory(self) -> float:
        """x* = HBM_bw / Net_bw: memory-network balance (mem-byte/net-byte)."""
        return self.hbm_bw / self.net_bw

    @property
    def ridge_network(self) -> float:
        """k* = Peak / Net_bw: compute-network balance (FLOP/net-byte)."""
        return self.peak_flops / self.net_bw

    #: names that always resolve to the primary link
    PRIMARY_LINKS = (None, "ici", "net")

    def bandwidth_for(self, link: Optional[str] = None) -> float:
        """Bandwidth of a named link; unknown names raise with the options."""
        if link in self.PRIMARY_LINKS:
            return self.net_bw
        try:
            return float(self.extra_links[link])
        except KeyError:
            raise KeyError(
                f"hardware spec {self.name!r} has no network link {link!r}; "
                f"available links: primary ('net'/'ici'/None) plus "
                f"extra_links {sorted(self.extra_links) or '{}'}") from None

    def alpha_for(self, link: Optional[str] = None) -> float:
        """Per-hop α of a named link (every link shares ``alpha_network``)."""
        self.bandwidth_for(link)               # unknown link: actionable error
        return self.alpha_network


# --- Presets -----------------------------------------------------------------

#: NVIDIA H100 SXM5, datasheet (dense, no sparsity): 989 TFLOP/s bf16 tensor
#: core, 3.35 TB/s HBM3, 80 GB; NVLink 4 at 900 GB/s total = 450 GB/s each way.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    net_bw=450e9,
    hbm_capacity_bytes=80e9,
)

#: The same card priced for fp32 work outside the tensor cores (datasheet:
#: 67 TFLOP/s FP32), used for the fp32 calibration GEMMs.
H100_SXM_FP32 = dataclasses.replace(H100_SXM, name="h100_sxm_fp32",
                                    peak_flops=67e12)
