"""Sized microbenchmarks on the card, as (WorkUnit, seconds).

Every bench returns a :class:`Measurement`: the analytic Ridgeline
characteristics (F, B_M, B_N) of what ran, paired with a median wall time
from :mod:`repro_torch.measure.timers`.  ``Measurement.to_dict`` has the
keys of ``repro.measure.microbench.Measurement.to_dict``, so the two
packages' measurement files read alike.

  * ``matmul_benches`` — square fp32 GEMMs through ``kernels/ops.matmul``:
    the hand-written CUDA kernel on the card; the plain version only when
    the caller asks for the CPU.  Compute-bound at the larger sizes.
  * ``memory_benches`` — saxpy streams in plain PyTorch (the reference left
    them to XLA too).  Memory-bound by construction: 2 FLOP per 12 bytes.

Collective and whole-step benches come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.ridgeline import WorkUnit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.measure.timers import time_callable

#: bench categories, as in the reference (calibration splits on them)
CATEGORIES = ("compute", "memory", "network", "step")

#: small sizes expose the dispatch intercept, large ones the peak
SMOKE_MATMUL_SIZES = (64, 128, 256, 512, 768, 1024)
FULL_MATMUL_SIZES = (64, 128, 256, 512, 1024, 1536, 2048)
#: streams well above the 50 MB L2 measure device memory; the KB entries
#: are pure per-launch overhead
SMOKE_STREAM_MB = (32, 64)
FULL_STREAM_MB = (32, 64, 128, 256)
SMOKE_STREAM_KB = (64,)
FULL_STREAM_KB = (64, 256)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One (WorkUnit, measured seconds) pair plus provenance.

    ``seconds`` is the median wall time; ``best_seconds`` the fastest
    sample.  ``backend`` names the device the bench ran on.
    """

    work: WorkUnit
    seconds: float                   # median wall time of one execution
    category: str                    # one of CATEGORIES
    best_seconds: float = 0.0        # fastest sample; 0 -> falls back to median
    rel_spread: float = 0.0          # IQR / median from the timing harness
    backend: str = ""
    meta: Tuple[Tuple[str, str], ...] = ()   # extra key/value provenance

    def __post_init__(self):
        if self.category not in CATEGORIES:
            raise ValueError(
                f"category {self.category!r} not in {CATEGORIES}")
        if self.seconds <= 0:
            raise ValueError(f"non-positive measurement for {self.work.name}")

    @property
    def best(self) -> float:
        return self.best_seconds or self.seconds

    def to_dict(self) -> Dict:
        return {
            "name": self.work.name,
            "flops": self.work.flops,
            "mem_bytes": self.work.mem_bytes,
            "net_bytes": self.work.net_bytes,
            "net_steps": self.work.net_steps,
            "seconds": self.seconds,
            "best_seconds": self.best,
            "category": self.category,
            # a NaN spread (n<3) is not strict JSON; serialize it as null
            "rel_spread": None if math.isnan(self.rel_spread)
            else self.rel_spread,
            "backend": self.backend,
            "meta": dict(self.meta),
        }


def backend_name(dev: torch.device) -> str:
    """The device a measurement ran on: ``torch.cuda.get_device_name`` for a
    card, else the device type."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _measure(fn, work: WorkUnit, category: str, dev: torch.device, *,
             repeats: int, meta: Tuple[Tuple[str, str], ...] = ()
             ) -> Measurement:
    stats = time_callable(fn, device=dev, repeats=repeats, warmup=2)
    return Measurement(work=work, seconds=stats.median,
                       best_seconds=stats.best, category=category,
                       rel_spread=stats.rel_spread, backend=backend_name(dev),
                       meta=meta)


def matmul_benches(sizes: Sequence[int] = SMOKE_MATMUL_SIZES, *,
                   repeats: int = 5,
                   device: DeviceLike = None) -> List[Measurement]:
    """Square fp32 GEMMs through ``ops.matmul`` (the CUDA kernel on a card).

    F = 2·s³; B_M = one read of each operand + one write of the output;
    B_N = 0.  Inputs are N(0, 1) from fixed generator seeds.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    out = []
    for s in sizes:
        gen.manual_seed(s)
        a = torch.randn((s, s), generator=gen, device=dev)
        b = torch.randn((s, s), generator=gen, device=dev)
        work = WorkUnit(f"matmul_{s}x{s}x{s}", flops=2.0 * s * s * s,
                        mem_bytes=3.0 * s * s * a.element_size(),
                        net_bytes=0.0)
        out.append(_measure(lambda a=a, b=b: ops.matmul(a, b), work,
                            "compute", dev, repeats=repeats,
                            meta=(("via", "ops"),)))
    return out


def memory_benches(sizes_mb: Sequence[int] = SMOKE_STREAM_MB, *,
                   sizes_kb: Sequence[int] = SMOKE_STREAM_KB,
                   repeats: int = 5,
                   device: DeviceLike = None) -> List[Measurement]:
    """saxpy streams ``2x + y``: 2 FLOP and 12 bytes per fp32 element.

    The size is the bytes of one operand, as in the reference.
    """
    dev = resolve_device(device)
    out = []
    sizes = [(kb * 1024, f"saxpy_{kb}kb") for kb in sizes_kb]
    sizes += [(mb * 1024 * 1024, f"saxpy_{mb}mb") for mb in sizes_mb]
    for nbytes, name in sizes:
        n = max(1, nbytes // 4)
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        y = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
        work = WorkUnit(name, flops=2.0 * n, mem_bytes=3.0 * n * 4,
                        net_bytes=0.0)
        out.append(_measure(lambda x=x, y=y: 2.0 * x + y, work, "memory",
                            dev, repeats=repeats))
    return out
