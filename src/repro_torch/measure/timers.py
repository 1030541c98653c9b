"""Robust timing on the card (and, when asked, on the CPU).

The discipline of ``repro.measure.timers``: warmup calls are timed and
discarded; the estimate is the median of the kept samples and the spread
their inter-quartile range.  What differs is the sync.  PyTorch's CUDA
calls return before the card finishes, and the reference's duck-typed
``block_until_ready`` does nothing on a tensor, so it would time only the
enqueue.  Here every sample ends in ``torch.cuda.synchronize()`` inside the
timed region (``time_callable``), or is bracketed by CUDA events
(``cuda_event_ms``, which times the card alone, without the host, and
``kernel_ms``, which also leaves out the gaps a slow host leaves between
the calls).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

#: fewer kept samples than this and an IQR is structurally ~0 — the spread
#: statistic is undefined, not "perfectly stable"
MIN_SAMPLES_FOR_SPREAD = 3

#: seconds of work the card does before a timed run: a card that sat idle
#: runs at a low clock, and a few short calls end before it has climbed back
WARM_S = 0.05


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an ascending sequence (numpy's
    default method)."""
    n = len(sorted_xs)
    if n == 0:
        raise ValueError("quantile of empty sample")
    if n == 1:
        return float(sorted_xs[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac)


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Median-of-k summary of one timed callable."""

    samples: Tuple[float, ...]       # kept samples, seconds, call order
    warmup_samples: Tuple[float, ...]  # discarded warmup calls
    median: float
    iqr: float                       # q75 − q25 of the kept samples
    mean: float
    best: float
    worst: float

    @property
    def rel_spread(self) -> float:
        """IQR / median; NaN below :data:`MIN_SAMPLES_FOR_SPREAD` samples."""
        if len(self.samples) < MIN_SAMPLES_FOR_SPREAD:
            return math.nan
        return self.iqr / self.median if self.median > 0 else 0.0

    def summary(self) -> str:
        s = (f"{self.median * 1e3:.3f}ms ±{self.iqr * 1e3:.3f}ms IQR "
             f"(n={len(self.samples)}, best {self.best * 1e3:.3f}ms)")
        if len(self.samples) < MIN_SAMPLES_FOR_SPREAD:
            s += " [n<3: spread not measurable]"
        return s


def robust_stats(samples: Sequence[float],
                 warmup: int = 0) -> TimingStats:
    """Median/IQR statistics over ``samples``, discarding the first ``warmup``."""
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    kept = [float(s) for s in samples[warmup:]]
    if not kept:
        raise ValueError(
            f"no samples left after discarding {warmup} warmup calls "
            f"(got {len(samples)} total)")
    srt = sorted(kept)
    return TimingStats(
        samples=tuple(kept),
        warmup_samples=tuple(float(s) for s in samples[:warmup]),
        median=_quantile(srt, 0.5),
        iqr=_quantile(srt, 0.75) - _quantile(srt, 0.25),
        mean=sum(kept) / len(kept),
        best=srt[0],
        worst=srt[-1],
    )


def _synchronizer(dev: torch.device) -> Callable[[], None]:
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def time_callable(fn: Callable, *args,
                  device: DeviceLike = None,
                  repeats: int = 7,
                  warmup: int = 2,
                  calls_per_sample: int = 1,
                  clock: Callable[[], float] = time.perf_counter,
                  **kwargs) -> TimingStats:
    """Host-clock time of ``fn(*args, **kwargs)`` on ``device``.

    Each of the ``warmup + repeats`` samples times ``calls_per_sample``
    back-to-back calls and ends in a device synchronize inside the timed
    region, so the card is charged for the work, not the enqueue.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if calls_per_sample < 1:
        raise ValueError(f"calls_per_sample must be >= 1, got {calls_per_sample}")
    sync = _synchronizer(resolve_device(device))
    samples = []
    sync()
    for _ in range(warmup + repeats):
        t0 = clock()
        for _ in range(calls_per_sample):
            fn(*args, **kwargs)
        sync()
        samples.append((clock() - t0) / calls_per_sample)
    return robust_stats(samples, warmup=warmup)


def cuda_event_ms(fn: Callable[[int], object], iters: int = 20,
                  warmup: int = 3) -> float:
    """Card time of one call, in ms: CUDA events around ``iters`` warm calls.

    ``fn(i)`` gets the call's index so a caller can rotate through inputs
    (e.g. one weight per layer, so no call finds its operands in L2 from
    the call before); ``_warm`` says what the warm-up is.  The time counts
    the card's idle gaps between calls, so it reads the host's pace where
    the host is slower.  Needs the card: there is no CPU version of an
    event.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    resolve_device("cuda")
    _warm(fn, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _warm(fn: Callable[[int], object], warmup: int) -> None:
    """At least ``warmup`` calls, and calls until the card has worked
    ``WARM_S`` seconds."""
    t0 = time.perf_counter()
    i = 0
    while i < warmup or time.perf_counter() - t0 < WARM_S:
        fn(i)
        i += 1
        if i % 8 == 0:                 # keep the host clock on the card's
            torch.cuda.synchronize()
    torch.cuda.synchronize()


def kernel_ms(fn: Callable[[int], object], iters: int = 20,
              warmup: int = 3) -> float:
    """Card time of one call's kernels, in ms, without the host's pace.

    The card sleeps (``torch.cuda._sleep``) while the host enqueues
    ``iters`` warm calls between two CUDA events, so it then runs them back
    to back: unlike ``cuda_event_ms``, a call whose host enqueue is slower
    than its kernels still reads the kernels' own time.  The sleep starts at
    0.2 ms a call and grows fourfold until the card is still asleep when the
    host has enqueued the last call.  ``fn(i)`` as for ``cuda_event_ms``.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    resolve_device("cuda")
    _warm(fn, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = max(1e-3, 2e-4 * iters)
    for _ in range(4):
        torch.cuda._sleep(int(2e9 * sleep_s))   # cycles: <= 2 GHz clocks
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        asleep = not start.query()
        end.synchronize()
        if asleep:
            return start.elapsed_time(end) / iters
        sleep_s *= 4
    raise RuntimeError(f"the host did not enqueue {iters} calls within "
                       f"{sleep_s / 4:.3f} s of the card's sleep")
