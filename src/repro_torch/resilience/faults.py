"""Deterministic seeded fault plans: the *inputs* to a resilience replay,
copied from ``repro.resilience.faults`` (numpy only, so a seed gives the
reference's events).

A :class:`FaultPlan` is a frozen, fully-enumerated schedule of fault events
against step numbers — no randomness at injection time, so a replay is
exactly reproducible from ``(seed, n_steps, rates)`` and a failing run can
be re-run bit-for-bit.  Event kinds mirror what a real fleet throws at a
training job:

* ``preemption`` — the node vanishes mid-step (spot reclaim, hardware
  loss); the runner loses uncommitted progress and restarts from the last
  committed checkpoint;
* ``link_flap`` — a transient interconnect timeout; same recoverable
  restart path as a preemption, distinct kind so replays can account it
  separately;
* ``straggler`` — the step completes but ``slowdown``× slower (thermal
  throttle, noisy neighbor); the runner's EWMA detector should flag it,
  not restart;
* ``corrupt_ckpt`` — silent data corruption lands in the *latest committed
  checkpoint* (bitrot, torn write behind a caching layer); nothing happens
  until a later restart tries to restore, which must quarantine the bad
  step and fall back (``checkpoint/checkpointer``).

Plans are generated by seeded draws without replacement over the step
range, so event steps never collide and every event fires exactly once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

PREEMPTION = "preemption"
LINK_FLAP = "link_flap"
STRAGGLER = "straggler"
CORRUPT_CKPT = "corrupt_ckpt"

KINDS = (PREEMPTION, LINK_FLAP, STRAGGLER, CORRUPT_CKPT)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str
    #: straggler slowdown multiplier (ignored by the other kinds)
    slowdown: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"valid: {KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of fault events for one replay."""

    seed: int
    n_steps: int
    events: Tuple[FaultEvent, ...]

    @classmethod
    def generate(cls, seed: int, n_steps: int, *, n_preemptions: int = 3,
                 n_link_flaps: int = 1, n_stragglers: int = 2,
                 n_corrupt_ckpts: int = 1,
                 straggler_slowdown: float = 8.0,
                 min_step: int = 1) -> "FaultPlan":
        """Draw a deterministic schedule from ``numpy`` PCG64 at ``seed``.

        Steps are sampled without replacement from ``[min_step, n_steps)``
        so no two events land on the same step (a preemption and a
        corruption on one step would make the replay's accounting
        ambiguous).  The same (seed, shape) always yields the same plan.
        """
        total = (n_preemptions + n_link_flaps + n_stragglers
                 + n_corrupt_ckpts)
        span = n_steps - min_step
        if total > span:
            raise ValueError(
                f"{total} events do not fit in steps [{min_step}, "
                f"{n_steps})")
        rng = np.random.default_rng(seed)
        steps = rng.choice(span, size=total, replace=False) + min_step
        kinds: List[str] = ([PREEMPTION] * n_preemptions
                            + [LINK_FLAP] * n_link_flaps
                            + [STRAGGLER] * n_stragglers
                            + [CORRUPT_CKPT] * n_corrupt_ckpts)
        events = tuple(sorted(
            (FaultEvent(step=int(s), kind=k,
                        slowdown=(straggler_slowdown if k == STRAGGLER
                                  else 1.0))
             for s, k in zip(steps, kinds)),
            key=lambda e: e.step))
        return cls(seed=seed, n_steps=n_steps, events=events)

    def by_step(self) -> Dict[int, FaultEvent]:
        return {e.step: e for e in self.events}

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    @property
    def n_restart_faults(self) -> int:
        """Events that cost a restart (preemptions + link flaps)."""
        return self.count(PREEMPTION) + self.count(LINK_FLAP)
