"""Analytic per-chip collective cost models (α–β accounting, vectorized),
copied from ``repro.distributed.collectives`` with its arithmetic unchanged.

The Ridgeline's ``B_N`` term is *wire bytes sent per chip*; this module is
the single source of those bytes for every collective the parallelism
strategies use.  All functions are NumPy-vectorized: ``payload_bytes`` and
``group_size`` broadcast against each other, so a whole sweep grid
(batch × mesh × algorithm) evaluates in one call.

Conventions (as in the literature, e.g. Chan et al. "Collective
communication: theory, practice, and experience" and the NCCL ring/tree
models):

  * ``payload_bytes`` is the *logical result/input size* of the collective:
    the full reduced tensor for all-reduce and reduce-scatter, the full
    gathered tensor for all-gather, and the per-chip resident buffer for
    all-to-all.
  * ``group_size`` ``n`` may be a float; ``math.inf`` gives the paper's
    large-n asymptote (the §III case study counts the ring all-reduce at
    exactly 2·payload, i.e. n→∞).  ``n == 1`` degenerates to zero bytes
    for every op/algorithm.
  * Per-chip bytes count what each chip *sends* on its busiest link; the
    bandwidth-optimal algorithms are link-balanced so this equals
    received bytes.

Per-chip wire bytes:

  all-reduce     ring    2·(n−1)/n · payload     (reduce-scatter + all-gather)
                 bidir   (n−1)/n · payload       (two half-payload rings)
                 tree    2·payload (n>1)         (send up + forward down)
  reduce-scatter ring    (n−1)/n · payload
  all-gather     ring    (n−1)/n · payload
  all-to-all     ring    (n−1)/n · payload

Latency ``steps`` are the serialized hop counts of each algorithm; together
with a per-hop latency α they give the α–β collective time

    t = α · steps + wire_bytes / link_bw

(:meth:`CollectiveCost.time`), which is what the α-aware Ridgeline
(``core/ridgeline``, ``core/sweep``) and the planner charge for network
work.  With α = 0 this degenerates to the paper's bandwidth-only model.

The vectorized functions carry the reference's ``@shape_contract``
declarations (``repro_torch.analysis.contracts``), checked at run time when
``REPRO_CHECK`` is set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analysis.contracts import shape_contract

ArrayLike = Union[float, np.ndarray]

#: supported all-reduce algorithm tags
ALGORITHMS = ("ring", "bidir_ring", "tree")

#: CLI-friendly short names accepted anywhere an algorithm tag is
ALGORITHM_ALIASES = {"bidir": "bidir_ring"}


def canonical_algorithm(name: str) -> str:
    """Resolve an algorithm tag or alias; unknown names raise with options."""
    name = ALGORITHM_ALIASES.get(name, name)
    if name not in ALGORITHMS:
        raise ValueError(f"unknown all-reduce algorithm {name!r}; "
                         f"have {ALGORITHMS} (aliases "
                         f"{sorted(ALGORITHM_ALIASES)})")
    return name


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Per-chip cost of one collective: bytes on the busiest link + hops."""

    wire_bytes: ArrayLike
    steps: ArrayLike

    def time(self, link_bw: float, alpha: float = 0.0) -> ArrayLike:
        """α–β time: ``alpha·steps + wire_bytes/link_bw`` (α defaults to 0,
        the bandwidth-only model)."""
        return (np.asarray(alpha, dtype=np.float64) * np.asarray(self.steps)
                + np.asarray(self.wire_bytes) / link_bw)

    def __add__(self, other: "CollectiveCost") -> "CollectiveCost":
        """Serial composition: bytes and hops both accumulate."""
        return CollectiveCost(
            np.asarray(self.wire_bytes) + np.asarray(other.wire_bytes),
            np.asarray(self.steps) + np.asarray(other.steps))

    def scaled(self, k: ArrayLike) -> "CollectiveCost":
        """``k`` back-to-back executions of this collective."""
        k = np.asarray(k, dtype=np.float64)
        return CollectiveCost(k * np.asarray(self.wire_bytes),
                              k * np.asarray(self.steps))


def _ring_factor(n: ArrayLike) -> np.ndarray:
    """(n−1)/n with n=1 → 0 and n=inf → 1, elementwise."""
    n = np.asarray(n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 - 1.0 / n
    return np.where(n <= 1.0, 0.0, f)


def _active(n: ArrayLike) -> np.ndarray:
    """1.0 where the group actually communicates (n > 1), else 0.0."""
    return np.where(np.asarray(n, dtype=np.float64) > 1.0, 1.0, 0.0)


def _log2_steps(n: ArrayLike) -> np.ndarray:
    n = np.asarray(n, dtype=np.float64)
    with np.errstate(divide="ignore", over="ignore"):
        return np.where(n > 1.0, np.ceil(np.log2(np.where(n > 1.0, n, 2.0))),
                        0.0)


@shape_contract("(*g), (*g) -> (*g)")
def all_reduce(payload_bytes: ArrayLike, group_size: ArrayLike,
               algorithm: str = "ring") -> CollectiveCost:
    p = np.asarray(payload_bytes, dtype=np.float64)
    n = np.asarray(group_size, dtype=np.float64)
    if algorithm == "ring":
        return CollectiveCost(2.0 * _ring_factor(n) * p,
                              2.0 * np.maximum(n - 1.0, 0.0))
    if algorithm == "bidir_ring":
        # the payload is split across the two ring directions
        return CollectiveCost(_ring_factor(n) * p, np.maximum(n - 1.0, 0.0))
    if algorithm == "tree":
        # pipelined binomial reduce + broadcast: each chip forwards the
        # whole payload up and down once — n-independent bytes, log-n hops
        return CollectiveCost(2.0 * _active(n) * p, 2.0 * _log2_steps(n))
    raise ValueError(f"unknown all-reduce algorithm {algorithm!r}; "
                     f"have {ALGORITHMS}")


def reduce_scatter(payload_bytes: ArrayLike,
                   group_size: ArrayLike) -> CollectiveCost:
    p = np.asarray(payload_bytes, dtype=np.float64)
    n = np.asarray(group_size, dtype=np.float64)
    return CollectiveCost(_ring_factor(n) * p, np.maximum(n - 1.0, 0.0))


def all_gather(payload_bytes: ArrayLike,
               group_size: ArrayLike) -> CollectiveCost:
    # identical wire profile to reduce-scatter (its mirror image)
    return reduce_scatter(payload_bytes, group_size)


@shape_contract("(*g), (*g) -> (*g)")
def all_to_all(payload_bytes: ArrayLike,
               group_size: ArrayLike) -> CollectiveCost:
    """payload = per-chip resident bytes; each chip keeps 1/n of it local."""
    return reduce_scatter(payload_bytes, group_size)


def all_reduce_bytes(payload_bytes: ArrayLike, group_size: ArrayLike,
                     algorithm: str = "ring") -> ArrayLike:
    return all_reduce(payload_bytes, group_size, algorithm).wire_bytes


# --- algorithm selection (α–β argmin over the algorithm menu) -----------------


def best_all_reduce(payload_bytes: float, group_size: float, bw: float,
                    alpha: float = 0.0,
                    algorithms: Sequence[str] = ALGORITHMS
                    ) -> Tuple[str, CollectiveCost]:
    """The α–β-fastest all-reduce algorithm for one payload on one link.

    Scalar argmin of ``CollectiveCost.time(bw, alpha)`` over ``algorithms``
    (Hashemi et al.: communication cost models are per-algorithm, so the
    *choice* is part of the cost model).  With α > 0 the log-step tree wins
    small payloads and a bandwidth-optimal ring wins large ones; with α = 0
    the fewest-wire-bytes algorithm always wins.  Ties resolve to the
    earlier entry of ``algorithms`` (deterministic).  ``group_size <= 1``
    degenerates to a zero cost — a size-1 group has no collective to run,
    so no α is paid either.
    """
    if not algorithms:
        raise ValueError("need at least one algorithm to choose from")
    best: Optional[Tuple[str, CollectiveCost, float]] = None
    for name in algorithms:
        algo = canonical_algorithm(name)
        cost = all_reduce(payload_bytes, group_size, algo)
        t = float(cost.time(bw, alpha))
        if best is None or t < best[2]:
            best = (algo, cost, t)
    return best[0], best[1]


@shape_contract("(*g), (*g), (*g), (*g) -> (*g), (*g), (*g)")
def best_all_reduce_grid(payload_bytes: ArrayLike, group_size: ArrayLike,
                         bw: ArrayLike, alpha: ArrayLike = 0.0,
                         algorithms: Sequence[str] = ALGORITHMS,
                         allowed: Optional[np.ndarray] = None,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized α–β argmin over the algorithm menu, elementwise.

    The grid twin of :func:`best_all_reduce`: every argument broadcasts
    against every other, so a whole planner candidate set — each element
    its own payload, group size, *and link* (per-element ``bw``/``alpha``)
    — selects in one pass.  Returns ``(wire_bytes, steps, algo_idx)``
    arrays of the broadcast shape, with ``algo_idx`` indexing into
    ``algorithms`` (canonicalized).  Ties resolve to the earliest menu
    entry, matching the scalar's strict-less-than scan bit-for-bit
    (property-tested in ``tests/test_plan_grid.py``).

    ``allowed`` optionally masks the menu per element — shape
    ``(len(algorithms), *broadcast_shape)`` of booleans — so a candidate
    set can mix "auto" rows (all True) with fixed-algorithm rows (one
    True) in the same pass; a disallowed entry prices at +inf and is
    never selected, and a column with no allowed entry at all raises
    (there is nothing valid to return for it).
    """
    if not algorithms:
        raise ValueError("need at least one algorithm to choose from")
    p = np.asarray(payload_bytes, dtype=np.float64)
    n = np.asarray(group_size, dtype=np.float64)
    bw = np.asarray(bw, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    shape = np.broadcast_shapes(p.shape, n.shape, bw.shape, alpha.shape)
    wire = np.empty((len(algorithms),) + shape, dtype=np.float64)
    steps = np.empty_like(wire)
    for a, name in enumerate(algorithms):
        cost = all_reduce(p, n, canonical_algorithm(name))
        wire[a] = np.broadcast_to(cost.wire_bytes, shape)
        steps[a] = np.broadcast_to(cost.steps, shape)
    times = alpha * steps + wire / bw          # same expression as .time()
    if allowed is not None:
        if not np.all(np.any(allowed, axis=0)):
            raise ValueError(
                "allowed mask excludes every algorithm for at least one "
                "element; each column needs one True entry")
        times = np.where(allowed, times, np.inf)
    idx = times.argmin(axis=0)                 # first minimum == menu order
    sel = np.expand_dims(idx, 0)
    return (np.take_along_axis(wire, sel, 0)[0],
            np.take_along_axis(steps, sel, 0)[0], idx)


def all_reduce_flip_payload(group_size: float, bw: float, alpha: float,
                            algorithms: Sequence[str] = ALGORITHMS
                            ) -> Optional[Tuple[float, str, str]]:
    """Payload where the best all-reduce algorithm flips, if it does.

    Each algorithm's time is affine in the payload,
    ``t(p) = α·steps(n) + slope(n)·p/bw``, so the argmin along payload is a
    lower envelope of lines: the minimum-intercept algorithm wins small
    payloads, the minimum-slope one wins large payloads, and the flip sits
    where their lines cross.  Returns ``(flip_payload_bytes, small_algo,
    large_algo)``, or None when one algorithm dominates (e.g. α = 0, a
    size-1 group, or n too small for the tree's log-step advantage).
    """
    n = float(group_size)
    if n <= 1.0 or not algorithms:
        return None
    lines = []
    for name in algorithms:
        algo = canonical_algorithm(name)
        unit = all_reduce(1.0, n, algo)              # per-payload-byte cost
        lines.append((algo, alpha * float(unit.steps),
                      float(unit.wire_bytes) / bw))
    small = min(lines, key=lambda l: (l[1], l[2]))   # min intercept
    large = min(lines, key=lambda l: (l[2], l[1]))   # min slope
    if small[0] == large[0] or small[2] <= large[2]:
        return None                                  # one line dominates
    flip = (large[1] - small[1]) / (small[2] - large[2])
    return flip, small[0], large[0]


# --- strategy-level accounting (what feeds WorkUnit.net_bytes/net_steps) ------


def dp_grad_sync(grad_bytes_per_chip: ArrayLike, dp: ArrayLike,
                 algorithm: str = "ring") -> CollectiveCost:
    """Data parallel: one all-reduce of the local gradient shard per step."""
    return all_reduce(grad_bytes_per_chip, dp, algorithm)


def dp_grad_sync_bytes(grad_bytes_per_chip: ArrayLike, dp: ArrayLike,
                       algorithm: str = "ring") -> ArrayLike:
    return dp_grad_sync(grad_bytes_per_chip, dp, algorithm).wire_bytes


@shape_contract("(*g), (*g), (*g) -> (*g)")
def zero_dp_sync(state_bytes_per_chip: ArrayLike, dp: ArrayLike,
                 stage: ArrayLike) -> CollectiveCost:
    """ZeRO-sharded dp-axis traffic per step (Rajbhandari et al.).

    ``state_bytes_per_chip`` is this chip's full parameter-block size (the
    gradient block is the same size in this repo's fp32 accounting).  With
    states sharded over dp, the ring all-reduce decomposes into its two
    halves plus — at stage 3 — one more gather:

      stage 1/2   reduce-scatter(grads) + all-gather(params)
                  = 2 · (dp−1)/dp · bytes,  2·(dp−1) hops
      stage 3     + a second params all-gather (forward re-gathers the
                  shard it no longer holds)
                  = 3 · (dp−1)/dp · bytes,  3·(dp−1) hops

    Stage 1/2 wire bytes equal the plain ring all-reduce (RS+AG *is* the
    ring), so pricing stays continuous with the zero-0 model; what changes
    is that the algorithm is structural — sharded state cannot ride a tree
    or bidirectional ring — so the planner pins these rows to this cost
    instead of the α–β argmin.  ``stage`` broadcasts; stage 0 prices as
    stage 1/2 (callers route stage-0 rows to the argmin path instead).
    """
    p = np.asarray(state_bytes_per_chip, dtype=np.float64)
    n = np.asarray(dp, dtype=np.float64)
    k = np.where(np.asarray(stage, dtype=np.float64) >= 3.0, 3.0, 2.0)
    return CollectiveCost(k * _ring_factor(n) * p,
                          k * np.maximum(n - 1.0, 0.0))


def tp_act_sync(act_bytes: ArrayLike, tp: ArrayLike,
                syncs_per_layer: ArrayLike, n_layers: ArrayLike,
                algorithm: str = "ring") -> CollectiveCost:
    """Tensor parallel: activation all-reduces at block boundaries.

    Megatron-style transformers sync 4×/layer (f+g, fwd+bwd over attn and
    mlp blocks); a plain MLP tower syncs 2×/layer (fwd + bwd).  The syncs
    are serialized by data dependence, so hops accumulate too.
    """
    per = all_reduce(act_bytes, tp, algorithm)
    return per.scaled(np.asarray(syncs_per_layer, np.float64)
                      * np.asarray(n_layers, np.float64))


def tp_act_sync_bytes(act_bytes: ArrayLike, tp: ArrayLike,
                      syncs_per_layer: ArrayLike, n_layers: ArrayLike,
                      algorithm: str = "ring") -> ArrayLike:
    return tp_act_sync(act_bytes, tp, syncs_per_layer, n_layers,
                       algorithm).wire_bytes


@shape_contract("(*g), (*g) -> (*g)")
def ep_dispatch_combine(payload_bytes: ArrayLike,
                        ep: ArrayLike) -> CollectiveCost:
    """Expert parallel: dispatch + combine all-to-alls, per MoE layer.

    ``payload_bytes`` is the per-chip routed-token buffer (tokens · k ·
    capacity_factor · width · act bytes, after any routing-imbalance
    derate); each MoE layer pays one all-to-all to scatter tokens to
    their experts' chips and a second to bring the expert outputs home —
    2·(ep−1)/ep · payload wire bytes, 2·(ep−1) serialized hops.  A size-1
    ep group runs no collective and costs exactly zero (wire and steps).
    """
    return all_to_all(payload_bytes, ep).scaled(2.0)


@shape_contract("(*g), (*g) -> (*g)")
def pp_boundary_bytes(act_bytes: ArrayLike, pp: ArrayLike) -> ArrayLike:
    """Pipeline parallel: point-to-point activations at stage boundaries.

    A middle stage sends the boundary activation forward and its gradient
    backward each step: 2·act_bytes of sends per chip, zero when pp == 1.
    """
    return 2.0 * _active(pp) * np.asarray(act_bytes, dtype=np.float64)
