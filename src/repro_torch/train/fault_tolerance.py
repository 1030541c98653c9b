"""Fault-tolerant training runner: restart, retry, straggler detection, as
``repro.train.fault_tolerance``.

``ResilientRunner`` wraps a train-step callable with the operational layer a
1000-node job needs:

  * checkpoint/auto-resume — periodic (optionally async) saves through
    ``Checkpointer``; on (re)start it restores the latest committed step and
    fast-forwards the data pipeline (pure function of step — nothing else to
    replay);
  * bounded retry with re-init from checkpoint on step failure (the
    recoverable class: preemption, transient ICI timeout — simulated in
    tests with an injected failure hook);
  * straggler detection — per-step wall-time EWMA; a step slower than
    ``straggler_factor``× the EWMA raises a flag the orchestration layer
    consumes (on real fleets: re-schedule the slow host / exclude it at the
    next elastic restart).  Detection must live in the runner because only
    the runner sees wall time; mitigation is a callback.
  * exponential backoff with jitter between retries — a fleet restarting
    in lockstep after a shared-fate failure (power event, storage blip)
    would hammer the checkpoint store; each retry waits
    ``backoff_base_s · 2^(k−1)`` capped at ``backoff_max_s``, with a
    seeded ±``backoff_jitter`` spread so replicas desynchronize
    deterministically under test.

The one change from the reference: where it blocks on the loss
(``jax.block_until_ready``), the port synchronizes the loss's device, so the
timed window of a step is its card time plus the host's.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY


@dataclasses.dataclass
class RunnerConfig:
    ckpt_every: int = 50
    async_ckpt: bool = True
    max_retries: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    # retry backoff: base · 2^(k−1) seconds before the k-th retry of a
    # step, capped at the max, jittered ±jitter fraction (0 base = none)
    backoff_base_s: float = 0.1
    backoff_max_s: float = 5.0
    backoff_jitter: float = 0.1


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float


def _block_until_ready(x: torch.Tensor) -> None:
    """Wait until the device that holds ``x`` has computed it."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class ResilientRunner:
    def __init__(self, train_step: Callable, checkpointer: Checkpointer,
                 cfg: Optional[RunnerConfig] = None,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.train_step = train_step
        self.ckpt = checkpointer
        # RunnerConfig is mutable, so a shared default instance would leak
        # one runner's tweaks into every later runner; build per-instance
        self.cfg = cfg if cfg is not None else RunnerConfig()
        self.on_straggler = on_straggler
        self.failure_hook = failure_hook   # tests inject failures here
        self.stragglers: List[StragglerEvent] = []
        self._ewma: Optional[float] = None
        self._warmup = True
        # fixed seed: backoff jitter must replay identically under test
        self._backoff_rng = random.Random(0x5EED)

    def resume_or_init(self, state):
        """Restore the latest committed checkpoint if one exists."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        restored, step = self.ckpt.restore(state)
        # the first step after a restore is slow (the reference re-traces
        # and compiles; the allocator refills its cache) — re-arm the EWMA
        # warm-up skip so that step is not flagged as a straggler
        self._warmup = True
        return restored, step

    def _backoff(self, retries: int) -> float:
        """Seconds to wait before the ``retries``-th retry (jittered)."""
        base = self.cfg.backoff_base_s
        if base <= 0.0:
            return 0.0
        wait = min(base * 2.0 ** (retries - 1), self.cfg.backoff_max_s)
        return wait * (1.0 + self.cfg.backoff_jitter
                       * self._backoff_rng.uniform(-1.0, 1.0))

    def run(self, state, stream, n_steps: int,
            start_step: Optional[int] = None) -> Tuple[Any, List[Dict]]:
        """Run ``n_steps`` with retry-from-checkpoint on failure."""
        if start_step is None:
            state, start_step = self.resume_or_init(state)
        history: List[Dict] = []
        step = start_step
        retries = 0
        last_failed_step = -1
        step_hist = REGISTRY.histogram("train.step_seconds")
        with trace.span("train.run", n_steps=n_steps,
                        start_step=start_step) as run_sp:
            while step < n_steps:
                try:
                    t0 = time.monotonic()
                    if self.failure_hook is not None:
                        self.failure_hook(step)   # inside the timed window
                    batch = stream.batch(step)
                    state, metrics = self.train_step(state, batch)
                    _block_until_ready(metrics["loss"])
                    dt = time.monotonic() - t0
                    step_hist.observe(dt)
                    self._track_time(step, dt)
                    history.append(
                        {k: float(v) for k, v in metrics.items()}
                        | {"step": step})
                    step += 1
                    if step % self.cfg.ckpt_every == 0:
                        self.ckpt.save(step, state,
                                       async_=self.cfg.async_ckpt)
                except _RECOVERABLE as e:  # noqa: PERF203
                    # retries are counted PER FAILING STEP: a replay that
                    # makes progress and then fails at the same step again
                    # is the deterministic-failure case and must eventually
                    # give up (counting globally and resetting on success
                    # would loop forever on a persistent fault).
                    trace.count("train.recoverable_failures", 1)
                    if step == last_failed_step:
                        retries += 1
                    else:
                        retries, last_failed_step = 1, step
                    if retries > self.cfg.max_retries:
                        raise
                    wait_s = self._backoff(retries)
                    if wait_s > 0.0:
                        time.sleep(wait_s)
                    self.ckpt.wait()
                    state, step = self.resume_or_init(state)
            if trace.enabled():
                run_sp.set(steps_run=len(history),
                           n_stragglers=len(self.stragglers))
        self.ckpt.wait()
        self.ckpt.save(n_steps, state, async_=False)
        return state, history

    def _track_time(self, step: int, dt: float) -> None:
        # the first measured step carries the warm-up (compilation in the
        # reference, the allocator's first fills here) — seeding the EWMA
        # with it would mask real stragglers for many steps; skip it
        if self._warmup:
            self._warmup = False
            return
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma and step > 2:
            ev = StragglerEvent(step=step, step_time=dt, ewma=self._ewma)
            self.stragglers.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt


class SimulatedFailure(RuntimeError):
    """Raised by test failure hooks to model preemption/node loss."""


_RECOVERABLE = (SimulatedFailure,)
