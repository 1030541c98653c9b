"""The traced stretch of a ``--trace 1`` run: whole units run under
``torch.profiler`` after the window, read into what the per-layer metrics
take.

Each stretch begins and ends on a synchronised device, so every operation
its units launched ran inside it.  It records the device's activity alone,
which costs the host little: each device operation (kernels, copies, sets)
with its start and length; the device's busy time, the union of their
intervals, against the stretch's length on the host's clock; and the idle
gaps, each named by the operation that ended it.  The profile stays in
memory.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

#: gaps shorter than this (seconds) are the device's own launch spacing
MIN_GAP = 2e-6


@dataclasses.dataclass
class Trace:
    units: int                                   # whole units traced
    window_s: float                              # the stretch's length
    busy_s: float                                # union of device ops
    ops: List[Tuple[str, float, float]]          # (name, start s, seconds)
    idle_gaps: List[Tuple[str, float]]           # (what ended it, seconds)

    def seconds_of(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(d for n, _, d in self.ops if any(s in n for s in needles))

    def count_of(self, *needles: str) -> int:
        return sum(1 for n, _, _ in self.ops if any(s in n for s in needles))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, d in self.ops:
            by[name[:160]] += d
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]


class Stretch:
    """Profile the device from ``start()`` to ``stop()`` (on the CPU, which
    has no device, the host's operations, so that the path runs there)."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity
        self.device = device
        self.acts = [ProfilerActivity.CUDA if device.type == "cuda"
                     else ProfilerActivity.CPU]
        self.prof = None
        self.seconds = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import profile
        self._sync()
        self.prof = profile(activities=self.acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def device_ops(self) -> List[Tuple[str, float, float]]:
        """(name, start us, end us) of each device operation."""
        from torch.autograd import DeviceType
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in self.prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]

    def read(self, units: int) -> Trace:
        """The device stretch's trace."""
        raw = sorted(self.device_ops(), key=lambda x: x[1])
        t0 = raw[0][1] if raw else 0.0
        ops = [(n, (a - t0) / 1e6, (b - a) / 1e6) for n, a, b in raw]
        busy, gaps = _busy_and_gaps(ops)
        tail = max(self.seconds - busy - sum(g for _, g in gaps), 0.0)
        by: Dict[str, float] = defaultdict(float)
        for name, g in gaps:
            by[name] += g
        if tail > 0:
            by["host: before the first and after the last operation"] += tail
        return Trace(units=units, window_s=self.seconds, busy_s=busy,
                     ops=ops, idle_gaps=sorted(by.items(),
                                               key=lambda x: -x[1])[:10])


def _busy_and_gaps(ops: List[Tuple[str, float, float]]
                   ) -> Tuple[float, List[Tuple[str, float]]]:
    """(busy seconds, the gaps between operations, each named "before"
    the operation that ended it) of ops sorted by start."""
    busy, gaps, end = 0.0, [], None
    for name, s, d in ops:
        e = s + d
        if end is None or s > end:
            if end is not None and s - end >= MIN_GAP:
                gaps.append((f"before {name[:100]}", s - end))
            busy += d
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps
