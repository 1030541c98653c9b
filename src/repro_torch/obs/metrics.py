"""Process-wide metrics registry: counters, gauges, histograms, provenance.

A copy of ``repro.obs.metrics`` for the port.  One module-level
:data:`REGISTRY` serves the whole process (every consumer sees the same
instruments, which is what makes cross-layer attribution possible), with
per-registry instances available for tests.  All three
instrument kinds are thread-safe and stdlib-only:

  * :class:`Counter` — monotone event count (``inc``),
  * :class:`Gauge` — last-write-wins value (``set``) — section wall-clocks,
  * :class:`Histogram` — streaming count/sum/min/max plus quantiles over a
    bounded window of the most recent observations (``observe``); the
    ``time()`` context manager observes elapsed seconds, which is how a
    step loop feeds a per-step latency distribution.

``snapshot()`` exports everything as one JSON-clean dict, and
:func:`provenance` captures what produced the numbers — git sha, numpy,
torch and CUDA versions, the device, hostname, wall clock — stamped into
every calibration registry entry and trace file so a measurement can
always be traced back to the code and the machine that made it.
"""
from __future__ import annotations

import contextlib
import math
import os
import platform
import socket
import subprocess
import threading
import time
from datetime import datetime, timezone
from importlib import metadata
from typing import Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "provenance"]

Number = Union[int, float]


class Counter:
    """Monotone thread-safe event counter."""

    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0.0

    def inc(self, n: Number = 1) -> float:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc must be >= 0, got {n}")
        with self._lock:
            self._n += n
            return self._n

    @property
    def value(self) -> float:
        return self._n

    def snapshot(self) -> float:
        return self._n


class Gauge:
    """Last-write-wins value (None until first ``set``)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None

    def set(self, v: Number) -> float:
        self._value = float(v)
        return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value

    def snapshot(self) -> Optional[float]:
        return self._value


#: quantile window: snapshots compute p50/p90/p99 over the most recent
#: this-many observations (count/sum/min/max stay exact over everything)
_HIST_WINDOW = 4096


class Histogram:
    """Streaming distribution: exact count/sum/min/max, windowed quantiles."""

    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max",
                 "_window")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._window: List[float] = []

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            self._window.append(v)
            if len(self._window) > _HIST_WINDOW:
                del self._window[: len(self._window) - _HIST_WINDOW]

    @contextlib.contextmanager
    def time(self):
        """Observe the elapsed wall-clock seconds of the ``with`` body."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> Dict[str, float]:
        from repro_torch.measure.timers import _quantile
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            srt = sorted(self._window)
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "mean": self._sum / self._count,
                    "p50": _quantile(srt, 0.50),
                    "p90": _quantile(srt, 0.90),
                    "p99": _quantile(srt, 0.99)}


class MetricsRegistry:
    """Create-or-get instrument registry with one-call JSON export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict, name: str, cls):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = cls(name)
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    @contextlib.contextmanager
    def section(self, name: str):
        """Record the body's wall-clock seconds into gauge ``name`` —
        the per-section timing a regression is localized with."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.gauge(name).set(time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.snapshot() for n, c in sorted(counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }

    def reset(self) -> None:
        """Drop every instrument (tests; the process registry is additive)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: the process-wide registry every instrumented layer records into
REGISTRY = MetricsRegistry()


# --- run provenance -----------------------------------------------------------


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _dist_version(name: str) -> Optional[str]:
    try:
        return metadata.version(name)
    except metadata.PackageNotFoundError:
        return None


def provenance() -> Dict[str, Optional[str]]:
    """Who/what/when produced a run — stamped into persisted artifacts:
    the reference's record with ``torch``, ``cuda`` and the device in place
    of ``jax``.  The device is the card's name, or ``cpu`` without one."""
    import torch
    return {
        "git_sha": _git_sha(),
        "hostname": socket.gethostname(),
        "wall_clock_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "numpy": _dist_version("numpy"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
    }
