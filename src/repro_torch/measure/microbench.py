"""Sized microbenchmarks on the card, as (WorkUnit, seconds).

Every bench returns a :class:`Measurement`: the Ridgeline characteristics
(F, B_M, B_N) of what ran, paired with a median wall time from
:mod:`repro_torch.measure.timers`.  ``Measurement.to_dict`` has the keys of
``repro.measure.microbench.Measurement.to_dict``, so the two packages'
measurement files read alike; ``measure/calibrate`` fits ceilings on them.

  * ``matmul_benches`` — square fp32 GEMMs through ``kernels/ops.matmul``:
    the hand-written CUDA kernel (its ``f32`` variant) on the card; the
    plain version only when the caller asks for the CPU.  Compute-bound at
    the larger sizes.
  * ``memory_benches`` — saxpy streams, ``torch.add(y, x, alpha=2)``: one
    kernel, as XLA fuses the reference's ``2x + y``.  Memory-bound by
    construction: 2 FLOP per 12 bytes.
  * ``collective_benches`` — ``dist.all_reduce`` over the default process
    group (NCCL on cards, gloo on the CPU), ring-priced by
    ``distributed/collectives``; ``[]`` without a group of 2 or more.
  * ``step_benches`` — whole dlrm-mlp train steps (``train/loop``) in fp32,
    F and B_M counted while they run (``measure/counters``): validation
    points, which the fit does not see.  The reference's third point, a
    reduced smollm decode step (``serve_step_bench``), waits for the
    decode port (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ridgeline import WorkUnit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.measure.timers import (TimingStats, _synchronizer,
                                        time_callable)

#: bench categories, as in the reference (calibration splits on them)
CATEGORIES = ("compute", "memory", "network", "step")

#: small sizes expose the dispatch intercept and the sub-peak tail of
#: ``eff(F)``, large ones the peak
SMOKE_MATMUL_SIZES = (64, 128, 256, 512, 768, 1024)
FULL_MATMUL_SIZES = (64, 128, 256, 512, 1024, 1536, 2048)
#: streams well above the 50 MB L2 measure device memory; the KB entries
#: are pure per-launch overhead (the α_M intercept)
SMOKE_STREAM_MB = (32, 64)
FULL_STREAM_MB = (32, 64, 128, 256)
SMOKE_STREAM_KB = (64,)
FULL_STREAM_KB = (64, 256)
#: all-reduce payloads: the KB entries are nearly pure per-hop latency (α),
#: the MB entries bandwidth
SMOKE_COLLECTIVE_MB = (4, 16)
FULL_COLLECTIVE_MB = (4, 16, 64)
SMOKE_COLLECTIVE_KB = (16, 64, 256)
FULL_COLLECTIVE_KB = (16, 64, 256, 1024)


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

    @property
    def link(self) -> Optional[str]:
        """Network link tag this measurement exercised (None = primary)."""
        return dict(self.meta).get("link")

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

    @staticmethod
    def from_dict(d: Dict) -> "Measurement":
        spread = d.get("rel_spread", 0.0)
        return Measurement(
            work=WorkUnit(d["name"], d["flops"], d["mem_bytes"],
                          d["net_bytes"],
                          net_steps=d.get("net_steps", 0.0)),
            seconds=d["seconds"], category=d["category"],
            best_seconds=d.get("best_seconds", 0.0),
            rel_spread=math.nan if spread is None else spread,
            backend=d.get("backend", ""),
            meta=tuple(sorted(d.get("meta", {}).items())))


def backend_name(dev: torch.device) -> str:
    """The device a measurement ran on: ``torch.cuda.get_device_name`` for a
    card, else the device type."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


#: transient failures (allocator pressure, runtime hiccups) get this many
#: retries before the suite gives up on a bench
_BENCH_RETRIES = 2
#: backoff base between retries: base · 2^k, jittered per bench name
_BENCH_BACKOFF_S = 0.05
#: per-bench wall budget: a probe call projects the whole run, and the
#: repeats are clamped to fit it (at least 1)
_BENCH_TIMEOUT_S = 30.0
#: the retryable class: runtime errors, not programming errors
_TRANSIENT = (RuntimeError, OSError, MemoryError)


def _guarded_stats(name: str, fn, dev: torch.device, *, repeats: int,
                   warmup: int, retries: int = _BENCH_RETRIES,
                   timeout_s: float = _BENCH_TIMEOUT_S) -> TimingStats:
    """``time_callable`` with bounded retry and a per-bench budget.

    A timed probe call (synchronised; it doubles as warmup) projects the
    cost of the ``warmup + repeats`` run, and the repeats are clamped so
    the bench fits ``timeout_s``.  The guard cannot interrupt a hung
    kernel.
    """
    sync = _synchronizer(dev)
    for attempt in range(retries + 1):
        try:
            t0 = time.monotonic()
            fn()
            sync()
            probe_s = time.monotonic() - t0
            r = repeats
            if timeout_s > 0 and probe_s * (warmup + repeats) > timeout_s:
                r = max(1, int(timeout_s / probe_s) - warmup)
            return time_callable(fn, device=dev, repeats=r, warmup=warmup)
        except _TRANSIENT:  # noqa: PERF203
            if attempt >= retries:
                raise
            jitter = 1.0 + 0.1 * ((zlib.crc32(name.encode()) % 256) / 255.0
                                  - 0.5)
            time.sleep(_BENCH_BACKOFF_S * 2.0 ** attempt * jitter)
    raise AssertionError("unreachable")  # pragma: no cover


def _measure(fn, work: WorkUnit, category: str, dev: torch.device, *,
             repeats: int, meta: Tuple[Tuple[str, str], ...] = (),
             **guard) -> Measurement:
    stats = _guarded_stats(work.name, fn, dev, repeats=repeats, warmup=2,
                           **guard)
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
    """saxpy streams ``2x + y``: 2 FLOP and 12 bytes per fp32 element,
    in one kernel (``2.0 * x + y`` would be two, moving 20 bytes).

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
        out.append(_measure(lambda x=x, y=y: torch.add(y, x, alpha=2.0),
                            work, "memory", dev, repeats=repeats))
    return out


def collective_benches(sizes_mb: Sequence[int] = SMOKE_COLLECTIVE_MB, *,
                       sizes_kb: Sequence[int] = SMOKE_COLLECTIVE_KB,
                       repeats: int = 5, link: str = "net",
                       device: DeviceLike = None) -> List[Measurement]:
    """Ring-priced ``dist.all_reduce`` over the default process group.

    Returns ``[]`` unless ``torch.distributed`` is initialised with 2 or
    more ranks: there is no wire to measure.  Every rank must call it with
    the same arguments.  The payload is each rank's fp32 tensor (zeros, so
    repeated sums stay finite); wire bytes and hops follow
    ``distributed/collectives``' ring model.  ``link`` tags the mesh axis
    the collectives rode (the per-link fit groups by it).
    """
    from repro_torch.distributed import collectives

    if not (dist.is_available() and dist.is_initialized()):
        return []
    world = dist.get_world_size()
    if world < 2:
        return []
    dev = resolve_device(device)
    out = []
    sizes = [(kb * 1024, f"allreduce_{kb}kb_x{world}") for kb in sizes_kb]
    sizes += [(mb * 1024 * 1024, f"allreduce_{mb}mb_x{world}")
              for mb in sizes_mb]
    for nbytes, name in sizes:
        n = max(1, nbytes // 4)
        x = torch.zeros((n,), dtype=torch.float32, device=dev)
        payload = float(n) * 4.0
        cost = collectives.all_reduce(payload, world, "ring")
        # per-chip reduction flops and the staging traffic of touching the
        # payload twice, as in the reference
        work = WorkUnit(name, flops=float(n), mem_bytes=2.0 * payload,
                        net_bytes=float(cost.wire_bytes),
                        net_steps=float(cost.steps))
        # every rank must make the same calls: no retry and no clamp, which
        # each rank would decide on its own clock
        out.append(_measure(lambda x=x: dist.all_reduce(x), work, "network",
                            dev, repeats=repeats, meta=(("link", link),),
                            retries=0, timeout_s=0.0))
    return out


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 matmuls in IEEE fp32 on the card (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def train_step_bench(batch: int = 64, width: int = 256, layers: int = 3, *,
                     repeats: int = 3,
                     device: DeviceLike = None) -> Measurement:
    """One fp32 dlrm-mlp train step (loss, grad, SGD) at a small width; F
    and B_M counted while it runs (``measure/counters``)."""
    from repro_torch.configs import get_config
    from repro_torch.measure import counters
    from repro_torch.optim.optimizer import SGD
    from repro_torch.train.loop import (TrainStepConfig, build_train_step,
                                        init_train_state)

    dev = resolve_device(device)
    cfg = get_config("dlrm-mlp").replace(
        n_layers=layers, mlp_widths=(width,) * layers, d_model=width,
        compute_dtype=torch.float32)
    opt = SGD(learning_rate=1e-2)
    step = build_train_step(cfg, opt, TrainStepConfig())
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                             device=dev)
    gen = torch.Generator().manual_seed(1)
    batch_arrs = {"features": torch.randn((batch, width), generator=gen)
                  .to(dev),
                  "click": torch.zeros((batch,), device=dev)}
    name = f"train_step_mlp_b{batch}_w{width}x{layers}"
    with _ieee_fp32():
        flops, mem_bytes = counters.count(step, state, batch_arrs)
        stats = _guarded_stats(name, lambda: step(state, batch_arrs), dev,
                               repeats=repeats, warmup=2)
    return Measurement(work=WorkUnit(name, flops, mem_bytes, 0.0),
                       seconds=stats.median, category="step",
                       rel_spread=stats.rel_spread, backend=backend_name(dev),
                       meta=(("kind", "train_step"), ("arch", "dlrm-mlp")))


def step_benches(*, repeats: int = 3, passes: int = 2,
                 device: DeviceLike = None) -> List[Measurement]:
    """Whole-step validation points: the reference's two train points
    (``b64_w256x3``, ``b256_w512x4``).  Its decode points
    (``serve_step_bench``, one more in a full suite) wait for the decode
    port, ROADMAP Queue 1 item 7.

    Each bench runs ``passes`` times and keeps the pass with the fastest
    best-sample (:func:`merge_passes`).
    """
    def one_pass() -> List[Measurement]:
        return [train_step_bench(repeats=repeats, device=device),
                train_step_bench(batch=256, width=512, layers=4,
                                 repeats=repeats, device=device)]

    return merge_passes([one_pass() for _ in range(max(passes, 1))])


#: a pass best this far below the median-of-passes is treated as a fluke
_FLUKE_RATIO = 0.4


def merge_passes(passes: Sequence[List[Measurement]]) -> List[Measurement]:
    """Per bench, keep the fastest pass, unless it looks like a fluke (a
    best more than ``_FLUKE_RATIO`` below the median pass's: then the
    median pass)."""
    merged = []
    for group in zip(*passes):
        ranked = sorted(group, key=lambda m: m.best)
        fastest = ranked[0]
        median = ranked[(len(ranked) - 1) // 2]
        merged.append(fastest if fastest.best >= _FLUKE_RATIO * median.best
                      else median)
    return merged


def _global_warmup(dev: torch.device) -> None:
    """One discarded product, so the runtime's first touch (context, the
    library's handles, the clock's ramp) lands on no bench."""
    x = torch.ones((1024, 1024), dtype=torch.float32, device=dev)
    x @ x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def default_suite(*, smoke: bool = True, repeats: Optional[int] = None,
                  steps: bool = True, passes: int = 3,
                  device: DeviceLike = None) -> List[Measurement]:
    """The calibration suite: the micro fits and the step validation
    points, run ``passes`` times with the fastest best-sample kept per bench
    (:func:`merge_passes`)."""
    dev = resolve_device(device)
    r = repeats if repeats is not None else (9 if smoke else 11)
    _global_warmup(dev)

    def one_pass() -> List[Measurement]:
        # steps lead the pass, next to the micro clocks they are compared
        # against
        out: List[Measurement] = []
        if steps:
            out += step_benches(repeats=r, passes=1, device=dev)
        out += matmul_benches(
            SMOKE_MATMUL_SIZES if smoke else FULL_MATMUL_SIZES, repeats=r,
            device=dev)
        out += memory_benches(SMOKE_STREAM_MB if smoke else FULL_STREAM_MB,
                              sizes_kb=(SMOKE_STREAM_KB if smoke
                                        else FULL_STREAM_KB),
                              repeats=r, device=dev)
        out += collective_benches(
            SMOKE_COLLECTIVE_MB if smoke else FULL_COLLECTIVE_MB,
            sizes_kb=SMOKE_COLLECTIVE_KB if smoke else FULL_COLLECTIVE_KB,
            repeats=r, device=dev)
        return out

    return merge_passes([one_pass() for _ in range(max(passes, 1))])
