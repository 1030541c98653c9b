"""Failure-aware goodput: the analytic side of the resilience package, copied
from ``repro.resilience.failures``.

The Ridgeline prices a *healthy* step; at planner mesh sizes, failures are
a first-order cost.  This module prices the unhealthy remainder with three
classic results, all broadcast-vectorized so ``plan_grid`` applies them to
the whole candidate set in one pass:

* **mesh failure rate** — chips fail independently and exponentially with
  per-chip mean time between failures ``mtbf_chip_s``, so a ``chips``-wide
  mesh fails at rate ``λ = chips / mtbf_chip_s`` and its MTBF is
  ``mtbf_chip_s / chips`` (:func:`mesh_mtbf_s`);
* **checkpoint cost** — each chip persists its own shard of the training
  state (``launch/memory.WorkingSet.persisted``: params + optimizer states
  under the candidate's ZeRO/tp/pp/ep sharding) at ``HardwareSpec.ckpt_bw``
  bytes/s, so ``t_ckpt = persisted_bytes / ckpt_bw`` (:func:`ckpt_time_s`);
* **Young/Daly interval** — the overhead-minimizing checkpoint cadence is
  ``τ* = sqrt(2 · t_ckpt · MTBF)`` (:func:`young_daly_interval_s`).

:func:`failure_overhead_terms` amortizes those into three per-step seconds
terms — checkpoint overhead ``t_ckpt · t_step / τ``, expected rework
``(t_step / MTBF) · τ/2`` (on average half an interval of work replays
after a failure), and expected restart ``(t_step / MTBF) · restart_s``
(process respawn + elastic reshard) — and the goodput fraction

    goodput = t_step / (t_step + ckpt_overhead + E[rework] + E[restart])

is the delivered share of wall clock.  The MTBF = ∞ lane degenerates to
exact additive zeros (goodput ≡ 1), so a goodput-enabled plan with no
failure model stays bit-identical to the healthy ranking.

The empirical twin lives in ``repro_torch.resilience.harness``: a seeded fault
plan replayed through ``ResilientRunner`` must land its *measured* goodput
within tolerance of these formulas (the same model↔measurement discipline
the calibration stack applies to the Ridgeline itself).

Each kernel carries the reference's ``@shape_contract`` declaration
(``repro_torch.analysis.contracts``), checked at run time when
``REPRO_CHECK`` is set.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

from repro_torch.analysis.contracts import shape_contract

ArrayLike = Union[int, float, np.ndarray]

#: hours → seconds (scale constant, not a unit-carrying name)
SECONDS_PER_HOUR = 3600.0


def _as_f64(x: ArrayLike) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Mesh-level failure statistics from per-chip constants.

    Attributes:
      mtbf_chip_s: per-chip mean time between failures, seconds
        (``inf`` = failure-free: every overhead term degenerates to 0.0).
      restart_s: time from failure to training again — process respawn,
        runtime re-init, checkpoint read-back.
      reshard_s: additional elastic-reshard time when the restart resumes
        on a degraded mesh (``checkpoint/elastic.restore_on_mesh``);
        charged on every restart — the pessimistic single constant.
    """

    mtbf_chip_s: float = float("inf")
    restart_s: float = 60.0
    reshard_s: float = 30.0

    @classmethod
    def from_mtbf_hours(cls, mtbf_hours: float, *, restart_s: float = 60.0,
                        reshard_s: float = 30.0) -> "FailureModel":
        """CLI convenience: ``--mtbf-hours H`` is per-chip MTBF in hours."""
        return cls(mtbf_chip_s=float(mtbf_hours) * SECONDS_PER_HOUR,
                   restart_s=restart_s, reshard_s=reshard_s)

    @property
    def downtime_s(self) -> float:
        """Seconds of lost wall clock per failure, beyond rework."""
        return self.restart_s + self.reshard_s


@shape_contract("chips:(*g) -> (*g)")
def mesh_mtbf_s(chips: ArrayLike, mtbf_chip_s: float) -> np.ndarray:
    """Mesh MTBF under independent exponential chip failures.

    The union of ``chips`` independent Poisson failure processes is a
    Poisson process at the summed rate, so the mesh fails every
    ``mtbf_chip_s / chips`` seconds.  ``mtbf_chip_s = inf`` propagates to
    an infinite mesh MTBF (failure-free lanes stay exact).
    """
    chips = _as_f64(chips)
    return mtbf_chip_s / np.maximum(chips, 1.0)


@shape_contract("persisted_bytes:(*g) -> (*g)")
def ckpt_time_s(persisted_bytes: ArrayLike, ckpt_bw: float) -> np.ndarray:
    """Seconds to write one checkpoint: per-chip shard bytes over the
    spec's per-chip checkpoint bandwidth (shards write concurrently, so
    the slowest — largest — shard bounds; with the symmetric sharding the
    working-set model assumes, every shard is the same size).
    """
    if ckpt_bw <= 0.0:
        raise ValueError(
            "goodput planning needs HardwareSpec.ckpt_bw > 0 "
            "(the spec does not know its checkpoint bandwidth)")
    return _as_f64(persisted_bytes) / float(ckpt_bw)


@shape_contract("t_ckpt_s:(*g), mtbf_s:(*g) -> (*g)")
def young_daly_interval_s(t_ckpt_s: ArrayLike,
                          mtbf_s: ArrayLike) -> np.ndarray:
    """Young/Daly optimal checkpoint interval ``τ* = sqrt(2·t_ckpt·MTBF)``.

    Balances checkpoint overhead (∝ 1/τ) against expected rework after a
    failure (∝ τ/2).  An infinite MTBF yields an infinite interval —
    never checkpoint a machine that never fails — which the overhead
    terms downstream turn into exact zeros.
    """
    return np.sqrt(2.0 * _as_f64(t_ckpt_s) * _as_f64(mtbf_s))


@shape_contract("t_step_s:(*g), t_ckpt_s:(*g), interval_s:(*g), "
                "mtbf_s:(*g) -> (*g), (*g), (*g)")
def failure_overhead_terms(t_step_s: ArrayLike, t_ckpt_s: ArrayLike,
                           interval_s: ArrayLike, mtbf_s: ArrayLike,
                           downtime_s: float
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step expected overhead seconds: (ckpt_overhead, rework, restart).

    * ``ckpt_overhead = t_ckpt · t_step / interval`` — one checkpoint of
      cost ``t_ckpt`` per ``interval`` seconds of useful work, amortized
      onto each step;
    * ``rework = (t_step / mtbf) · interval/2`` — failures arrive at rate
      ``1/mtbf`` and replay on average half an interval of work;
    * ``restart = (t_step / mtbf) · downtime_s`` — each failure also pays
      the restart + elastic-reshard downtime.

    The ``mtbf = inf`` lane is repaired to exact 0.0 on every term (the
    intermediate ``inf/inf`` is deliberately suppressed and overwritten),
    so adding these to a healthy step time is a bitwise identity there.
    """
    t_step_s = _as_f64(t_step_s)
    t_ckpt_s = _as_f64(t_ckpt_s)
    interval_s = _as_f64(interval_s)
    mtbf_s = _as_f64(mtbf_s)
    finite = np.isfinite(mtbf_s) & (mtbf_s > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ckpt_overhead_s = np.where(
            interval_s > 0.0,
            t_ckpt_s * t_step_s / np.where(interval_s > 0.0, interval_s,
                                           1.0),
            0.0)
        fail_per_step = np.where(
            finite, t_step_s / np.where(finite, mtbf_s, 1.0), 0.0)
    ckpt_overhead_s = np.where(finite, ckpt_overhead_s, 0.0)
    rework_s = fail_per_step * 0.5 * np.where(finite, interval_s, 0.0)
    restart_s = fail_per_step * float(downtime_s)
    return ckpt_overhead_s, rework_s, restart_s


@shape_contract("t_step_s:(*g), ckpt_overhead_s:(*g), rework_s:(*g), "
                "restart_s:(*g) -> (*g)")
def goodput_fraction(t_step_s: ArrayLike, ckpt_overhead_s: ArrayLike,
                     rework_s: ArrayLike,
                     restart_s: ArrayLike) -> np.ndarray:
    """Delivered share of wall clock:
    ``t_step / (t_step + ckpt_overhead + E[rework] + E[restart])``.
    Exactly 1.0 wherever every overhead term is zero.
    """
    t_step_s = _as_f64(t_step_s)
    total_s = (t_step_s + _as_f64(ckpt_overhead_s) + _as_f64(rework_s)
               + _as_f64(restart_s))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(total_s > 0.0,
                       t_step_s / np.where(total_s > 0.0, total_s, 1.0),
                       1.0)
    return out


@shape_contract("t_step_s:(*g), persisted_bytes:(*g), chips:(*g) "
                "-> (*g), (*g), (*g), (*g), (*g)")
def goodput_terms(t_step_s: ArrayLike, persisted_bytes: ArrayLike,
                  chips: ArrayLike, *, ckpt_bw: float,
                  model: FailureModel
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """One-call composition for the planner: all goodput quantities.

    Returns ``(ckpt_overhead_s, rework_s, restart_s, interval_s, goodput)``
    elementwise over the broadcast candidate shape.  With an infinite
    ``model.mtbf_chip_s`` every overhead term is exactly 0.0 and goodput
    exactly 1.0 — the bit-identity lane the plan goldens pin.
    """
    mtbf_s = mesh_mtbf_s(chips, model.mtbf_chip_s)
    t_ckpt_s = ckpt_time_s(persisted_bytes, ckpt_bw)
    interval_s = young_daly_interval_s(t_ckpt_s, mtbf_s)
    ckpt_overhead_s, rework_s, restart_s = failure_overhead_terms(
        t_step_s, t_ckpt_s, interval_s, mtbf_s, model.downtime_s)
    good = goodput_fraction(t_step_s, ckpt_overhead_s, rework_s, restart_s)
    return ckpt_overhead_s, rework_s, restart_s, interval_s, good
