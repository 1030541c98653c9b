"""Fault-injection replay: measure the goodput a fault plan actually costs,
as ``repro.resilience.harness``.

The analytic side (``resilience.failures``) *predicts* goodput from MTBF,
checkpoint cost, and cadence.  This harness *measures* it: a seeded
:class:`~repro.resilience.faults.FaultPlan` is driven through the real
``train.fault_tolerance.ResilientRunner`` — real train steps, real
checkpoint files, real restore-and-replay — and the replay's event
counters are priced in *virtual* time:

    wall  = executed·t_step + saves·t_ckpt + restarts·downtime
    goodput_measured = committed·t_step / wall

Virtual time (fixed seconds per step / checkpoint / restart) rather than
wall-clock keeps the measurement deterministic — the same plan replays to
the same goodput on any machine, which is what lets a test pin
``|measured − analytic| < tol`` without flaking on CI load.  The analytic
twin is evaluated at the replay's *actual* cadence (``ckpt_every · t_step``,
not the Young/Daly optimum) and its *empirical* failure rate, so the two
sides model the same job:

    mtbf = committed·t_step / n_restart_faults

The corrupt-checkpoint event exercises the integrity path end-to-end: it
flips bytes in the latest *committed* shard on disk, so the next restart's
restore must detect the bad crc32, quarantine the step, and fall back —
losing (and replaying) one extra checkpoint interval, which the accounting
attributes like any other rework.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import COMMIT_MARKER, Checkpointer
from repro_torch.resilience import failures
from repro_torch.resilience.faults import (CORRUPT_CKPT, LINK_FLAP,
                                           PREEMPTION, STRAGGLER, FaultPlan)
from repro_torch.train.fault_tolerance import (ResilientRunner, RunnerConfig,
                                               SimulatedFailure)


@dataclasses.dataclass(frozen=True)
class VirtualCosts:
    """Fixed virtual-seconds prices for the replay's accounting."""

    t_step_s: float = 1.0
    t_ckpt_s: float = 0.25
    downtime_s: float = 10.0


@dataclasses.dataclass
class ReplayResult:
    """Counters + priced goodput of one fault-plan replay."""

    n_steps: int                 # committed (useful) steps
    executed_steps: int          # every step that ran, incl. replays
    saves: int                   # checkpoints written
    restarts: int                # recoverable failures survived
    quarantined: int             # corrupt checkpoints detected + bypassed
    stragglers_flagged: int
    costs: VirtualCosts
    final_state: Any = None
    history: Optional[List[Dict]] = None

    @property
    def replayed_steps(self) -> int:
        return self.executed_steps - self.n_steps

    @property
    def wall_s(self) -> float:
        c = self.costs
        return (self.executed_steps * c.t_step_s + self.saves * c.t_ckpt_s
                + self.restarts * c.downtime_s)

    @property
    def useful_s(self) -> float:
        return self.n_steps * self.costs.t_step_s

    @property
    def goodput_measured(self) -> float:
        return self.useful_s / self.wall_s

    def goodput_analytic(self, ckpt_every: int,
                         n_restart_faults: int) -> float:
        """The ``resilience.failures`` prediction for this exact job:
        actual cadence (not Young/Daly), empirical failure rate."""
        c = self.costs
        interval_s = float(ckpt_every) * c.t_step_s
        mtbf_s = (self.useful_s / n_restart_faults
                  if n_restart_faults else float("inf"))
        ck, rw, rs = failures.failure_overhead_terms(
            c.t_step_s, c.t_ckpt_s, interval_s, mtbf_s, c.downtime_s)
        return float(failures.goodput_fraction(c.t_step_s, ck, rw, rs))


def _corrupt_latest(ckpt: Checkpointer) -> bool:
    """Flip bytes mid-file in the latest committed shard (silent
    corruption: size unchanged, commit marker intact — only the crc32
    knows).  Returns False when there is nothing committed yet."""
    step = ckpt.latest_step()
    if step is None:
        return False
    d = os.path.join(ckpt.root, f"step_{step:09d}")
    assert os.path.exists(os.path.join(d, COMMIT_MARKER))
    shards = sorted(n for n in os.listdir(d) if n.startswith("shard_"))
    path = os.path.join(d, shards[0])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        buf = f.read(64)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in buf))
    return True


class _CountingCheckpointer(Checkpointer):
    """Checkpointer that counts saves and quarantines (the replay's
    observables) without changing any behavior."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.n_saves = 0
        self.n_quarantined = 0

    def save(self, step, tree, async_=False):
        self.n_saves += 1
        return super().save(step, tree, async_=async_)

    def _quarantine(self, step):
        self.n_quarantined += 1
        return super()._quarantine(step)


def replay(train_step, state, stream, plan: FaultPlan, ckpt_dir: str, *,
           ckpt_every: int = 10, costs: VirtualCosts = VirtualCosts(),
           max_retries: int = 10, keep: int = 5,
           straggler_sleep_s: float = 0.0,
           keep_history: bool = False) -> ReplayResult:
    """Drive ``plan`` through a real ResilientRunner; return the priced
    accounting.

    Each restart-class event (preemption, link flap) raises
    ``SimulatedFailure`` from inside the timed step window exactly once —
    the replayed pass over the same step must succeed, as it would on a
    fleet.  A ``corrupt_ckpt`` event corrupts the latest committed shard
    on disk at its step; the damage stays dormant until the next
    restart restores through it.  ``straggler`` events optionally sleep
    ``slowdown × straggler_sleep_s`` real seconds so the runner's EWMA
    detector has something to flag (0 disables — pure-accounting runs).

    ``costs`` is frozen (immutable), so the shared default instance is
    safe.
    """
    events = plan.by_step()
    fired: set = set()

    ckpt = _CountingCheckpointer(ckpt_dir, keep=keep)

    def failure_hook(step: int) -> None:
        ev = events.get(step)
        if ev is None or step in fired:
            return
        fired.add(step)
        if ev.kind in (PREEMPTION, LINK_FLAP):
            raise SimulatedFailure(f"{ev.kind} at step {step}")
        if ev.kind == CORRUPT_CKPT:
            _corrupt_latest(ckpt)
        elif ev.kind == STRAGGLER and straggler_sleep_s > 0.0:
            import time
            time.sleep(ev.slowdown * straggler_sleep_s)

    runner = ResilientRunner(
        train_step, ckpt,
        RunnerConfig(ckpt_every=ckpt_every, async_ckpt=False,
                     max_retries=max_retries, backoff_base_s=0.0),
        failure_hook=failure_hook)
    final, history = runner.run(state, stream, n_steps=plan.n_steps)

    return ReplayResult(
        n_steps=plan.n_steps,
        executed_steps=len(history),
        saves=ckpt.n_saves,
        restarts=len(fired & {e.step for e in plan.events
                              if e.kind in (PREEMPTION, LINK_FLAP)}),
        quarantined=ckpt.n_quarantined,
        stragglers_flagged=len(runner.stragglers),
        costs=costs,
        final_state=final,
        history=list(history) if keep_history else None)


def predicted_goodput(plan: FaultPlan, *, ckpt_every: int,
                      costs: VirtualCosts = VirtualCosts()) -> float:
    """Analytic goodput for a plan before running it (same formulas the
    planner folds into ``--goodput`` rankings, at the job's cadence)."""
    interval_s = float(ckpt_every) * costs.t_step_s
    useful_s = plan.n_steps * costs.t_step_s
    n = plan.n_restart_faults
    mtbf_s = useful_s / n if n else float("inf")
    ck, rw, rs = failures.failure_overhead_terms(
        costs.t_step_s, costs.t_ckpt_s, interval_s, mtbf_s,
        costs.downtime_s)
    return float(failures.goodput_fraction(costs.t_step_s, ck, rw, rs))
