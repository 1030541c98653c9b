"""Grid-scale vectorized planning engine: the planner's evaluation core,
copied from ``repro.launch.plan_grid`` with its arithmetic unchanged.

``plan_grid(cfg, hw, chips_list, batch_list, ...)`` evaluates the full
cartesian candidate space

    (dp × tp × pp × ep) × microbatch × collective-algorithm × batch × chips

in NumPy broadcast passes — no per-candidate Python loop anywhere on the
evaluation path.  Candidate enumeration (divisor lists, feasibility
filters) is plain integer bookkeeping; everything priced — collective
wire bytes, α–β link times, algorithm argmins, the Ridgeline sweep — runs
on flat float64 arrays over the whole candidate set at once, which is
what turns N separate ``plan()`` calls into one pass at ≥10⁵
candidates/s (see ``BENCH_ridgeline.json`` → ``planner_grid_*``).

``repro_torch.launch.plan.plan`` is a thin slice of this engine (one chips, one
batch, ``max_pp=1``), so there is exactly one evaluation core; its
``pp = 1`` output is regression-pinned bit-identical to the per-candidate
planner (the ``tests/golden/plan_pr*.json`` goldens).

**Mesh layout.**  Axes nest tp-inner / ep-next / pp-middle / dp-outer,
so a ring over the tp axis has stride 1, the ep axis stride tp, the pp
axis stride tp·ep, and the dp axis stride tp·ep·pp.  With ``pod_size``
set, any axis whose extent (size · stride) exceeds the pod is priced at
the spec's ``pod`` link — the slowest hop bounds a ring — expressed here
as a boolean mask per candidate with the link bandwidth/α gathered
elementwise.

**Expert parallelism.**  ``max_ep > 1`` admits an ep axis for
MoE configs: ep must divide the padded expert count
``E_pad = max(n_experts, pad_experts_to)`` (mirroring the GQA
head-divisibility gate), the routed expert weights/grads/optimizer
states shard over ep (``launch/memory`` and the streamed-weights term
here), and every MoE layer pays a capacity-factor-aware dispatch +
combine all-to-all on the ep axis's own pod-routed link
(``collectives.ep_dispatch_combine``, α·steps + bytes/bw like every
other axis).  Top-k routing imbalance enters as a ``max_load/mean_load``
derate (:func:`moe_routing_derate`) multiplying both the per-chip expert
FLOPs and the dispatch wire bytes; dense blocks (attention, router,
shared experts) are priced as replicated across ep — the conservative
GShard accounting, where ep buys expert-side compute/memory sharding at
the price of all-to-all traffic.  Every ep = 1 lane is overlaid with
``np.where``/additive-zero identities, so the default ``max_ep = 1``
search stays bit-identical to the three-axis goldens.

**Pipeline parallelism (1F1B).**  A pp-way candidate splits the layer
stack into ``pp`` stages (``pp ≤ n_layers``; when pp ∤ n_layers the
stack ceil-splits unevenly and the widest ``ceil(L/pp)``-layer stage
sets the critical path — per-stage work scales by
``ceil(L/pp)·pp/L ≥ 1``, exactly 1.0 when pp divides L) and the per-dp
batch into ``m`` microbatches (m must divide ``batch/dp``).  The 1F1B
schedule keeps ``pp − 1`` microbatch slots of bubble at the ramp, so the
step time inflates by the bubble factor

    t_step ≈ (m + pp − 1)/m · t_microbatch_work

equivalently ``t_step = (m + pp − 1) · t_microbatch`` — with each
microbatch additionally paying 2 point-to-point activation hops
(boundary activation forward, its gradient backward) priced α–β on the
link the pp axis rides.  The fill factor ``m + pp − 1`` enters the
Ridgeline sweep as a per-candidate *derating of the machine peaks*
(peak/fill, hbm/fill, α·fill against per-microbatch work), so
classification and projected runtime stay one ``core.sweep`` call; at
pp = m = 1 the fill is exactly 1.0 and every number is bit-for-bit the
non-pipelined model.  The dp gradient
all-reduce runs once per step (after the last microbatch) and is not
bubbled.  Per-microbatch memory re-streams the stage weights
(weights + boundary activations per traversal), which reduces exactly to
the non-pipelined accounting at pp = m = 1.  ``interleave = v > 1`` prices the
interleaved-1F1B schedule: each chip holds ``v_eff = min(v, L // pp)``
virtual stage chunks, shrinking the ramp bubble to ``(pp − 1)/v_eff``
microbatch slots at the cost of ``v_eff×`` the boundary p2p traffic
(every chunk boundary crosses chips).  ``interleave = 1`` (default) is
the classic schedule, bit-for-bit.

**Memory feasibility.**  Before any pricing pass, every
candidate's per-chip working set (``launch/memory``: params + grads +
optimizer states over tp·pp, activations × in-flight 1F1B microbatches) is
checked against ``hw.hbm_capacity_bytes``; candidates that cannot fit are
pruned from the struct-of-arrays — they shrink every downstream broadcast
pass instead of being ranked as "fastest".  ``zero_stages`` adds ZeRO
sharding as a candidate axis: stage 1/2/3 shard optimizer states /
gradients / parameters across dp, shrinking the footprint while the dp
sync is repriced as reduce-scatter + all-gather traffic
(``collectives.zero_dp_sync`` — structural, not an algorithm choice).
``remat=True`` halves the saved-activation footprint at +1/3 recompute
FLOPs.  The default ``zero_stages=(0,)``/``remat=False`` keeps the
zero-0 slice bit-identical to the capacity-free goldens; a spec with capacity 0
(unknown — every custom spec's default) disables the cut entirely.

The vectorized functions carry the reference's ``@shape_contract``
declarations (``repro_torch.analysis.contracts``), checked at run time when
``REPRO_CHECK`` is set.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analysis.contracts import shape_contract
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.hardware import HardwareSpec, get_hardware
from repro_torch.distributed import collectives
from repro_torch.launch import memory as memory_mod
from repro_torch.obs import trace
from repro_torch.resilience.failures import FailureModel
from repro_torch.resilience import failures as failures_mod

if TYPE_CHECKING:  # torch-backed; planning itself is numpy-only
    from repro_torch.models.config import ModelConfig

#: families with attention/MoE blocks -> Megatron-style 4 syncs per layer
_ATTENTION_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

#: display shorthand for algorithm tags (table column stays narrow)
_ALGO_SHORT = {"ring": "ring", "bidir_ring": "bidir", "tree": "tree"}

#: mesh-axis tag of the inter-pod link in ``HardwareSpec.extra_links``
POD_LINK = "pod"

#: the ZeRO stages a candidate axis may take (0 = unsharded states)
ZERO_STAGES = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One ranked candidate: the mesh, its terms, and its projection."""

    dp: int
    tp: int
    algorithm: str               # requested: a concrete tag or "auto"
    flops: float                 # per chip, per step
    mem_bytes: float
    net_bytes: float             # wire bytes across all axes
    t_compute: float
    t_memory: float
    t_network: float             # α–β time, per-axis links (+ pipeline bubble)
    runtime: float               # projected step time (bound); under
    #                              goodput planning the failure overhead
    #                              terms are folded in (effective step time)
    bottleneck: str
    peak_fraction: float
    net_steps: float = 0.0       # serialized hops across all axes
    dp_link: str = "ici"         # link the dp grad sync rides
    tp_link: str = "ici"         # link the tp act syncs ride
    dp_algo: str = "ring"        # algorithm the dp grad sync uses ("-" when
    #                              the axis is size 1: no collective runs)
    tp_algo: str = "ring"        # algorithm the tp act syncs use
    runtime_lo: float = 0.0      # runtime·(1−e), e = hw.model_rel_error
    runtime_hi: float = 0.0      # runtime·(1+e); lo == hi == runtime when
    #                              the spec carries no measured error
    pp: int = 1                  # pipeline stages (1 = no pipeline axis)
    microbatches: int = 1        # 1F1B microbatch count m
    pp_link: str = "ici"         # link the pp boundary p2p rides
    zero_stage: int = 0          # ZeRO: 1/2/3 shard opt/grads/params over dp
    hbm_bytes: float = 0.0       # modeled per-chip working set
    fits: bool = True            # hbm_bytes <= hw.hbm_capacity_bytes (or
    #                              the spec carries no capacity: trivially True)
    remat: bool = False          # activations rematerialized (+1/3 FLOPs)
    ep: int = 1                  # expert-parallel axis (1 = no ep axis)
    ep_link: str = "ici"         # link the ep dispatch/combine a2a rides
    vstages: int = 1             # interleaved-1F1B virtual stages per chip
    goodput: float = 1.0         # delivered share of wall clock (1.0 when
    #                              failures are unmodeled or MTBF = inf)
    ckpt_overhead_s: float = 0.0  # per-step amortized checkpoint write
    rework_s: float = 0.0        # per-step expected replayed work
    restart_s: float = 0.0       # per-step expected restart + reshard
    ckpt_interval_s: float = 0.0  # Young/Daly τ* (0 when failure-free)

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pp * self.ep

    @property
    def hbm_used_gb(self) -> float:
        """The working set in decimal gigabytes (display convenience)."""
        return self.hbm_bytes / 1e9

    @property
    def mesh(self) -> str:
        base = f"dp{self.dp}xtp{self.tp}"
        return (base + (f"xpp{self.pp}" if self.pp > 1 else "")
                + (f"xep{self.ep}" if self.ep > 1 else ""))

    @property
    def bubble_fraction(self) -> float:
        """Fraction of the pipelined step spent in the 1F1B ramp bubble
        (interleaving divides the ramp by the virtual-stage count)."""
        ramp = (self.pp - 1.0) / self.vstages
        return ramp / (self.microbatches + ramp)

    @property
    def algo_label(self) -> str:
        """Selected algorithms, compact: one tag when the axes agree."""
        axes = [_ALGO_SHORT.get(a, a) for a in (self.dp_algo, self.tp_algo)
                if a != "-"]
        if not axes:
            return "-"
        if len(set(axes)) == 1:
            return axes[0]
        return "+".join(axes)


@functools.lru_cache(maxsize=None)
def _divisors(n: int) -> Tuple[int, ...]:
    """All divisors of n, ascending, by O(√n) enumeration."""
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return tuple(small + large[::-1])


def _factor_pairs(chips: int) -> List[Tuple[int, int]]:
    """(chips//t, t) for every divisor t, t ascending — O(√chips)."""
    return [(chips // t, t) for t in _divisors(chips)]


def _model_width(cfg: ModelConfig) -> int:
    return cfg.mlp_widths[0] if cfg.family == "mlp" else cfg.d_model


@functools.lru_cache(maxsize=None)
def param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) parameter counts; closed-form for the MLP family.

    The MLP tower is counted in closed form; every other family defers to
    the exact accounting in ``launch/specs``, which runs the model's own
    ``init_*`` on fake tensors.  Memoized on the (frozen, hashable) config,
    so that init runs once per model per process no matter how many
    ``plan``/``plan_grid`` calls follow.
    """
    if cfg.family == "mlp":
        widths = cfg.mlp_widths
        n = 0.0
        for i, w in enumerate(widths):
            d_in = widths[i - 1] if i else widths[0]
            n += d_in * w + w
        n += widths[-1] * 1 + 1                     # head
        return n, n
    from repro_torch.launch.specs import param_counts as exact
    return exact(cfg)


def _tp_ok(tp: int, width: int, n_heads: int, n_kv_heads: int) -> bool:
    """Can a tp-way split actually shard the model (integer form)?

    Beyond ``tp | width``, attention models split Megatron-TP by *heads*:
    tp must divide ``n_heads``, and — where GQA defines a smaller KV head
    count — ``n_kv_heads`` too, or the sharding layer
    (the JAX package's ``launch/dryrun._rules_for`` /
    ``distributed.sharding.gqa_safe_rules``)
    falls back to a different layout than the one the planner prices.
    Head-less families (``n_heads == 0``, e.g. the MLP tower) only need
    the width check.
    """
    if width % tp:
        return False
    if tp <= 1 or not n_heads:
        return True
    if n_heads % tp:
        return False
    return not (0 < n_kv_heads < n_heads and n_kv_heads % tp)


def feasible_meshes(cfg: ModelConfig, chips: int,
                    batch: int) -> List[Tuple[int, int]]:
    """(dp, tp) with dp·tp == chips, dp | batch, tp | width (and heads)."""
    width = _model_width(cfg)
    return [(dp, tp) for dp, tp in _factor_pairs(chips)
            if batch % dp == 0
            and _tp_ok(tp, width, cfg.n_heads, cfg.n_kv_heads)]


def pp_choices(cfg: ModelConfig, chips: int, max_pp: int) -> List[int]:
    """Pipeline sizes: divide the chip budget, fit inside the layer stack.

    Stage counts need not divide ``n_layers`` — the stack ceil-splits,
    with the widest stage setting the critical path — but a stage count
    beyond the layer count would leave empty stages, so ``pp ≤ n_layers``.
    """
    return [p for p in _divisors(chips)
            if p <= max_pp and p <= cfg.n_layers]


def _padded_experts(cfg: ModelConfig) -> int:
    """E_pad = max(n_experts, pad_experts_to); 0 for expert-less configs."""
    if getattr(cfg, "n_experts", 0) <= 0:
        return 0
    return max(cfg.n_experts, cfg.pad_experts_to)


def ep_choices(cfg: ModelConfig, chips: int, max_ep: int) -> List[int]:
    """Expert-parallel sizes: divide the chip budget and the padded expert
    count ``E_pad`` (padding experts buy divisibility; a shard boundary
    through an expert tensor would not).  ep = 1 is always feasible."""
    e_pad = _padded_experts(cfg)
    return [e for e in _divisors(chips)
            if e <= max_ep and (e == 1 or (e_pad > 0 and e_pad % e == 0))]


def microbatch_choices(batch_per_dp: int, pp: int) -> Tuple[int, ...]:
    """1F1B microbatch counts m: divisors of the per-dp batch with m ≥ pp.

    A pp = 1 candidate has no pipeline to fill, so splitting the batch
    only adds dispatch α without changing any bandwidth term — m is
    pinned to 1 there (which is also what keeps the pp = 1 slice
    bit-identical to the pre-grid planner).  For pp > 1, m < pp describes
    a pipeline that never fills — the 1F1B schedule holds
    ``m + pp − 1`` slots but fewer than pp stages ever run concurrently,
    and the fill algebra would price phantom overlap — so those divisors
    are excluded (possibly leaving no choice at all, which removes the
    (dp, pp) pair from the candidate space).
    """
    if pp <= 1:
        return (1,)
    return tuple(m for m in _divisors(batch_per_dp) if m >= pp)


# --- the broadcast evaluation core --------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExplainTerms:
    """Additive attribution terms, elementwise-aligned with the grid arrays.

    Computed only under ``plan_grid(..., explain=True)``; every array has
    length ``n_candidates``.  The splits are exact complements of the
    engine's own numbers — ``comp_flops_s = t_compute − comp_alpha_s``
    etc. — so whichever resource bound a candidate, that resource's terms
    sum to the priced time (``repro_torch.obs.explain`` builds the per-candidate
    ``breakdown`` from these; the network side sums to ``t_network`` only
    within float tolerance, because the engine folds the α–β axis times
    through a net_bw multiply/divide round-trip).

    Every field is SECONDS (the ``_s`` suffix is a units-lint declaration):
    the ``*_bytes_s``/``*_flops_s`` halves are the traffic-over-bandwidth /
    work-over-ceiling *times*, not the raw traffic.
    """

    comp_alpha_s: np.ndarray             # α_C·fill dispatch share of t_compute
    comp_flops_s: np.ndarray             # F/(peak·eff) share (t_compute − α)
    mem_alpha_s: np.ndarray
    mem_bytes_s: np.ndarray
    net_dp_alpha_s: np.ndarray           # dp grad sync: α·steps (once/step)
    net_dp_bytes_s: np.ndarray           # dp grad sync: wire/bw
    net_tp_alpha_s: np.ndarray           # tp act syncs: fill·α·steps
    net_tp_bytes_s: np.ndarray           # tp act syncs: fill·wire/bw
    net_pp_alpha_s: np.ndarray           # pp boundary p2p: fill·α·hops
    net_pp_bytes_s: np.ndarray           # pp boundary p2p: fill·bytes/bw
    net_ep_alpha_s: np.ndarray           # ep dispatch a2a: fill·α·hops
    net_ep_bytes_s: np.ndarray           # ep dispatch a2a: fill·wire/bw


@dataclasses.dataclass(frozen=True)
class PlanGrid:
    """Flat struct-of-arrays result of one ``plan_grid`` pass.

    Every field of length ``n_candidates`` lines up elementwise;
    ``chips_idx``/``batch_idx`` map each candidate back to its grid point.
    ``plans(chips, batch)`` materializes ranked :class:`MeshPlan` rows for
    one point (that is the only per-candidate Python in the module, and it
    is display-path only); ``best_runtime_grid()`` reduces the whole grid
    without materializing anything.
    """

    cfg_name: str
    hardware: str
    chips_list: Tuple[int, ...]
    batch_list: Tuple[int, ...]
    seq: int
    pod_size: Optional[int]
    max_pp: int
    max_ep: int
    interleave: int                      # interleaved-1F1B virtual stage cap
    algorithms: Tuple[str, ...]          # requested, raw (may include "auto")
    zero_stages: Tuple[int, ...]         # searched ZeRO stages
    remat: bool
    hbm_capacity_bytes: float            # the budget candidates were cut by
    check_capacity: bool                 # False: infeasible rows kept, marked

    chips_idx: np.ndarray                # int, index into chips_list
    batch_idx: np.ndarray                # int, index into batch_list
    dp: np.ndarray
    tp: np.ndarray
    pp: np.ndarray
    ep: np.ndarray
    microbatches: np.ndarray
    zero: np.ndarray                     # per-candidate ZeRO stage
    req_idx: np.ndarray                  # index into `algorithms`
    dp_algo_idx: np.ndarray              # into collectives.ALGORITHMS
    tp_algo_idx: np.ndarray
    dp_pod: np.ndarray                   # bool: axis priced at the pod link
    tp_pod: np.ndarray
    pp_pod: np.ndarray
    ep_pod: np.ndarray
    vstages: np.ndarray                  # interleaved virtual stages (int)

    flops: np.ndarray                    # per chip per step
    mem_bytes: np.ndarray
    net_bytes: np.ndarray
    net_steps: np.ndarray
    t_compute: np.ndarray
    t_memory: np.ndarray
    t_network: np.ndarray
    runtime: np.ndarray
    bottleneck: np.ndarray               # int8 codes into sweep.RESOURCE_ORDER
    peak_fraction: np.ndarray
    runtime_lo: np.ndarray
    runtime_hi: np.ndarray

    hbm_bytes: np.ndarray                # per-candidate working set (memory.py)
    fits: np.ndarray                     # bool; all True after a capacity cut
    n_enumerated: int                    # candidates before the capacity cut
    n_pruned: np.ndarray                 # (n_chips, n_batch) cut per point
    min_zero_to_fit: np.ndarray          # (n_chips, n_batch) smallest surviving
    #                                      ZeRO stage per point (the
    #                                      "infeasible without ZeRO-k" k)

    # attribution payload — populated only under explain=True (obs.explain)
    explain_terms: Optional[ExplainTerms] = None
    prune_reasons: Optional[Dict[Tuple[int, int], Dict[str, int]]] = None
    #                                    ^ (ci, bi) -> enumeration prune counts

    # failure-aware goodput overlay — populated only under goodput=True
    # (repro_torch.resilience.failures); `runtime` then carries the overhead
    # terms additively: runtime = max(t_C, t_M, t_N) + ckpt + rework +
    # restart, which is what flips rankings toward smaller meshes
    failure: Optional[FailureModel] = None
    goodput: Optional[np.ndarray] = None
    ckpt_overhead_s: Optional[np.ndarray] = None
    rework_s: Optional[np.ndarray] = None
    restart_s: Optional[np.ndarray] = None
    ckpt_interval_s: Optional[np.ndarray] = None

    @property
    def n_candidates(self) -> int:
        return int(self.runtime.size)

    @property
    def pruned_fraction(self) -> float:
        """Share of enumerated candidates the capacity mask removed."""
        if self.n_enumerated <= 0:
            return 0.0
        return 1.0 - self.n_candidates / self.n_enumerated

    def labels(self) -> np.ndarray:
        return sweep_mod._LABELS[self.bottleneck]

    def _point(self, chips: Optional[int], batch: Optional[int]
               ) -> Tuple[int, int]:
        ci = 0 if chips is None else self.chips_list.index(chips)
        bi = 0 if batch is None else self.batch_list.index(batch)
        return ci, bi

    def point_indices(self, chips: Optional[int] = None,
                      batch: Optional[int] = None) -> np.ndarray:
        ci, bi = self._point(chips, batch)
        return np.nonzero((self.chips_idx == ci)
                          & (self.batch_idx == bi))[0]

    def _mesh_plan(self, i: int) -> MeshPlan:
        dp, tp, pp = int(self.dp[i]), int(self.tp[i]), int(self.pp[i])
        zero = int(self.zero[i])
        algs = collectives.ALGORITHMS
        return MeshPlan(
            dp=dp, tp=tp,
            algorithm=self.algorithms[int(self.req_idx[i])],
            flops=float(self.flops[i]),
            mem_bytes=float(self.mem_bytes[i]),
            net_bytes=float(self.net_bytes[i]),
            t_compute=float(self.t_compute[i]),
            t_memory=float(self.t_memory[i]),
            t_network=float(self.t_network[i]),
            runtime=float(self.runtime[i]),
            bottleneck=str(self.labels()[i]),
            peak_fraction=float(self.peak_fraction[i]),
            net_steps=float(self.net_steps[i]),
            dp_link=POD_LINK if self.dp_pod[i] else "ici",
            tp_link=POD_LINK if self.tp_pod[i] else "ici",
            # ZeRO's RS+AG dp sync is structural, not an algorithm choice
            dp_algo="-" if dp <= 1 else
            ("rs+ag" if zero >= 1 else algs[int(self.dp_algo_idx[i])]),
            tp_algo="-" if tp <= 1 else algs[int(self.tp_algo_idx[i])],
            runtime_lo=float(self.runtime_lo[i]),
            runtime_hi=float(self.runtime_hi[i]),
            pp=pp, microbatches=int(self.microbatches[i]),
            pp_link=POD_LINK if self.pp_pod[i] else "ici",
            zero_stage=zero, hbm_bytes=float(self.hbm_bytes[i]),
            fits=bool(self.fits[i]), remat=self.remat,
            ep=int(self.ep[i]),
            ep_link=POD_LINK if self.ep_pod[i] else "ici",
            vstages=int(self.vstages[i]),
            goodput=(1.0 if self.goodput is None
                     else float(self.goodput[i])),
            ckpt_overhead_s=(0.0 if self.ckpt_overhead_s is None
                             else float(self.ckpt_overhead_s[i])),
            rework_s=(0.0 if self.rework_s is None
                      else float(self.rework_s[i])),
            restart_s=(0.0 if self.restart_s is None
                       else float(self.restart_s[i])),
            ckpt_interval_s=(0.0 if self.ckpt_interval_s is None
                             else float(self.ckpt_interval_s[i])))

    def plans(self, chips: Optional[int] = None,
              batch: Optional[int] = None) -> List[MeshPlan]:
        """Ranked candidates of one grid point (runtime, then smaller tp)."""
        idx = self.point_indices(chips, batch)
        order = sorted(idx.tolist(),
                       key=lambda i: (self.runtime[i], self.tp[i],
                                      self.zero[i]))
        return [self._mesh_plan(i) for i in order]

    def best(self, chips: Optional[int] = None,
             batch: Optional[int] = None) -> MeshPlan:
        idx = self.point_indices(chips, batch)
        i = min(idx.tolist(), key=lambda i: (self.runtime[i], self.tp[i],
                                             self.zero[i]))
        return self._mesh_plan(i)

    def best_runtime_grid(self) -> np.ndarray:
        """min projected step time per grid point — (n_chips, n_batch)."""
        out = np.full((len(self.chips_list), len(self.batch_list)), np.inf)
        np.minimum.at(out, (self.chips_idx, self.batch_idx), self.runtime)
        return out


@functools.lru_cache(maxsize=4096)
def _point_candidates(width: int, n_heads: int, n_kv_heads: int,
                      n_layers: int, e_pad: int, chips: int, batch: int,
                      max_pp: int, max_ep: int) -> Tuple[np.ndarray, ...]:
    """(dp, tp, pp, ep, m) arrays for one grid point — pure integer work.

    Keyed on the integers that actually determine feasibility (model
    width, head counts, layer count, padded expert count, chip budget,
    batch, pp/ep caps), so repeated grid points — N ``plan()`` calls over
    the same configs, or overlapping grids — enumerate once per process.
    Callers must treat the returned arrays as immutable (they are shared
    cache entries).  The ep gate mirrors the GQA head gate: ep must
    divide ``e_pad`` (an ep > 1 axis on an expert-less config is never
    feasible); ep = 1 is always kept, so ``max_ep = 1`` reproduces the
    three-axis candidate space exactly.
    """
    dp_l: List[int] = []
    tp_l: List[int] = []
    pp_l: List[int] = []
    ep_l: List[int] = []
    m_l: List[int] = []
    for pp in _divisors(chips):
        if pp > max_pp or pp > n_layers:
            continue
        for ep in _divisors(chips // pp):
            if ep > max_ep:
                continue
            if ep > 1 and (e_pad <= 0 or e_pad % ep):
                continue
            for dp, tp in _factor_pairs(chips // pp // ep):
                if batch % dp or not _tp_ok(tp, width, n_heads, n_kv_heads):
                    continue
                for m in microbatch_choices(batch // dp, pp):
                    dp_l.append(dp)
                    tp_l.append(tp)
                    pp_l.append(pp)
                    ep_l.append(ep)
                    m_l.append(m)
    return (np.asarray(dp_l, dtype=np.int64),
            np.asarray(tp_l, dtype=np.int64),
            np.asarray(pp_l, dtype=np.int64),
            np.asarray(ep_l, dtype=np.int64),
            np.asarray(m_l, dtype=np.int64))


@functools.lru_cache(maxsize=4096)
def _point_prune_stats(width: int, n_heads: int, n_kv_heads: int,
                       n_layers: int, e_pad: int, chips: int, batch: int,
                       max_pp: int, max_ep: int
                       ) -> Tuple[Tuple[str, int], ...]:
    """Why raw tuples fell out of one grid point's enumeration, by gate.

    The shadow of :func:`_point_candidates`: walks the same divisor space
    but counts what each feasibility gate rejected instead of keeping the
    survivors — the structured half of ``--explain``'s prune account (the
    capacity cut is the other half; it happens downstream on enumerated
    candidates and is reported from ``PlanGrid.n_pruned``).  Units: the
    two pp gates count (dp, tp) pairs under the rejected pp (at ep = 1);
    the two ep gates count (dp, tp) pairs under the rejected (pp, ep);
    the dp/tp gates count (dp, tp, pp, ep) tuples; ``microbatch_lt_pp``
    counts (dp, tp, pp, ep, m) tuples whose 1F1B pipeline would never
    fill (m < pp); ``kept_mesh_tuples`` counts the (dp, tp, pp, ep, m)
    tuples that reached pricing — before the zero/algorithm axes are
    tiled on.  Cached alongside the candidate cache; kept separate so the
    hot enumeration path never pays for bookkeeping it only needs under
    ``explain=True``.
    """
    stats = {"pp_exceeds_max_pp": 0, "pp_exceeds_layers": 0,
             "ep_exceeds_max_ep": 0, "ep_expert_indivisible": 0,
             "batch_dp_indivisible": 0, "tp_shard_infeasible": 0,
             "microbatch_lt_pp": 0, "kept_mesh_tuples": 0}
    for pp in _divisors(chips):
        n_pairs = len(_divisors(chips // pp))
        if pp > max_pp:
            stats["pp_exceeds_max_pp"] += n_pairs
            continue
        if pp > n_layers:
            stats["pp_exceeds_layers"] += n_pairs
            continue
        for ep in _divisors(chips // pp):
            n_sub = len(_divisors(chips // pp // ep))
            if ep > max_ep:
                stats["ep_exceeds_max_ep"] += n_sub
                continue
            if ep > 1 and (e_pad <= 0 or e_pad % ep):
                stats["ep_expert_indivisible"] += n_sub
                continue
            for dp, tp in _factor_pairs(chips // pp // ep):
                if batch % dp:
                    stats["batch_dp_indivisible"] += 1
                    continue
                if not _tp_ok(tp, width, n_heads, n_kv_heads):
                    stats["tp_shard_infeasible"] += 1
                    continue
                if pp > 1:
                    divs = _divisors(batch // dp)
                    stats["microbatch_lt_pp"] += sum(1 for m in divs
                                                     if m < pp)
                    stats["kept_mesh_tuples"] += sum(1 for m in divs
                                                     if m >= pp)
                else:
                    stats["kept_mesh_tuples"] += 1
    return tuple(sorted(stats.items()))


def _enumerate_candidates(cfg: ModelConfig, chips_list: Sequence[int],
                          batch_list: Sequence[int], max_pp: int,
                          algo_codes: Sequence[int],
                          zero_stages: Sequence[int] = (0,),
                          max_ep: int = 1) -> Dict[str, np.ndarray]:
    """Flat candidate index arrays over the whole grid.

    Per-point enumeration is cached integer bookkeeping
    (:func:`_point_candidates`); the ZeRO axis, the algorithm axis, and
    the grid-point index columns are tiled on with numpy, so the warm
    path does no per-candidate Python at all.  Ordering is mesh-major,
    zero-middle, algorithm-minor; a zero > 0 row with dp == 1 would be
    numerically identical to its zero = 0 twin (nothing to shard over a
    size-1 axis), so those duplicates are dropped here.  Raises when a
    grid point has no feasible mesh, naming the point.
    """
    width = _model_width(cfg)
    e_pad = _padded_experts(cfg)
    n_req = len(algo_codes)
    req_range = np.arange(n_req, dtype=np.intp)
    zs = np.asarray(zero_stages, dtype=np.int64)
    cols: List[List[np.ndarray]] = [[] for _ in range(9)]
    for ci, chips in enumerate(chips_list):
        for bi, batch in enumerate(batch_list):
            dp_a, tp_a, pp_a, ep_a, m_a = _point_candidates(
                width, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, e_pad,
                int(chips), int(batch), max_pp, max_ep)
            if dp_a.size == 0:
                raise ValueError(
                    f"no feasible (dp, tp, pp, ep) for chips={chips}, "
                    f"batch={batch}, width={width}"
                    + (f" (tp must divide n_heads={cfg.n_heads}"
                       + (f", n_kv_heads={cfg.n_kv_heads}"
                          if 0 < cfg.n_kv_heads < cfg.n_heads else "")
                       + ")" if cfg.n_heads else ""))
            # cross mesh rows with the ZeRO axis, dropping dp = 1 dupes
            dp_z = np.repeat(dp_a, zs.size)
            z_col = np.tile(zs, dp_a.size)
            keep = (dp_z > 1) | (z_col == zs[0]) \
                if (zs > 0).any() else slice(None)
            dp_z = dp_z[keep]
            tp_z = np.repeat(tp_a, zs.size)[keep]
            pp_z = np.repeat(pp_a, zs.size)[keep]
            ep_z = np.repeat(ep_a, zs.size)[keep]
            m_z = np.repeat(m_a, zs.size)[keep]
            z_col = z_col[keep]
            n = dp_z.size * n_req
            cols[0].append(np.full(n, ci, dtype=np.intp))
            cols[1].append(np.full(n, bi, dtype=np.intp))
            # mesh-major, algorithm-minor — the scalar planner's order
            cols[2].append(np.repeat(dp_z, n_req))
            cols[3].append(np.repeat(tp_z, n_req))
            cols[4].append(np.repeat(pp_z, n_req))
            cols[5].append(np.repeat(ep_z, n_req))
            cols[6].append(np.repeat(m_z, n_req))
            cols[7].append(np.repeat(z_col, n_req))
            cols[8].append(np.tile(req_range, dp_z.size))
    names = ("chips_idx", "batch_idx", "dp", "tp", "pp", "ep",
             "microbatches", "zero", "req_idx")
    return {name: np.concatenate(parts)
            for name, parts in zip(names, cols)}


def _capacity_error(cfg: ModelConfig, capacity: float, chips: int,
                    batch: int, seq: int, max_pp: int, remat: bool,
                    zero_stages: Sequence[int],
                    max_ep: int = 1) -> ValueError:
    """Actionable error for a grid point the capacity cut emptied."""
    width = _model_width(cfg)
    dp_a, tp_a, pp_a, ep_a, m_a = _point_candidates(
        width, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers,
        _padded_experts(cfg), int(chips), int(batch), max_pp, max_ep)
    need = memory_mod.min_zero_stage(
        cfg, capacity, batch=batch, seq=seq, dp=dp_a, tp=tp_a, pp=pp_a,
        ep=ep_a, microbatches=m_a, remat=remat)
    k = int(need.min()) if need.size else 4
    if k <= 3:
        hint = (f"infeasible without ZeRO-{k}: pass zero_stages "
                f"including {k} (CLI: --zero auto)")
    else:
        hint = ("no candidate fits even at ZeRO-3; try remat=True, "
                "more chips, or a smaller batch")
    return ValueError(
        f"no candidate fits in hbm_capacity_bytes={capacity:.3g} for "
        f"chips={chips}, batch={batch} "
        f"(searched zero_stages={tuple(zero_stages)}, remat={remat}) — "
        + hint)


@shape_contract("dp:(*g), tp:(*g), pp:(*g), ep:(*g) "
                "-> (*g), (*g), (*g), (*g)")
def _pod_masks(dp: np.ndarray, tp: np.ndarray, pp: np.ndarray,
               ep: np.ndarray, pod_size: Optional[int]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Which mesh axes spill past the pod boundary onto the pod link.

    Extents along the chip grid: tp rides stride 1, ep stride tp, pp
    stride tp·ep, dp stride tp·ep·pp — an axis routes over the pod link
    when its outermost chip index exceeds ``pod_size``.  Returns
    ``(dp_pod, tp_pod, pp_pod, ep_pod)`` boolean masks of the broadcast
    candidate shape; ``pod_size=None`` (single-pod machine) keeps every
    axis on the primary link.  At ep = 1 every mask reduces exactly to
    the pre-ep three-axis layout.
    """
    if pod_size is None:
        z = np.zeros(np.broadcast_shapes(np.shape(dp), np.shape(tp),
                                         np.shape(pp), np.shape(ep)),
                     dtype=bool)
        return z, z, z, z
    dp_pod = (dp > 1) & (dp * tp * pp * ep > pod_size)
    pp_pod = (pp > 1) & (pp * ep * tp > pod_size)
    ep_pod = (ep > 1) & (ep * tp > pod_size)
    tp_pod = (tp > 1) & (tp > pod_size)
    return dp_pod, tp_pod, pp_pod, ep_pod


@shape_contract("ep:(*g), tokens_mb:(*g) -> (*g)")
def moe_routing_derate(ep: np.ndarray, tokens_mb: np.ndarray, *,
                       n_experts: int, pad_experts: int, top_k: int,
                       capacity_factor: float) -> np.ndarray:
    """Top-k routing-imbalance derate: expected max_load/mean_load per chip.

    Two multiplicative terms, both dimensionless and ≥ 1:

    * **padding skew** — experts shard ``E_pad / ep`` per chip but only
      ``E`` of them ever receive routing mass, so the most-loaded chip
      hosts up to ``min(E_pad/ep, E)`` live experts against a mean of
      ``E/ep``: derate ``min(E_pad/ep, E) · ep / E`` (exactly 1.0 when
      ``E_pad == E``).
    * **stochastic skew** — balanced routing still leaves balls-in-bins
      variance across ep chips; with ``λ = tokens_mb·k/ep`` expected
      choices per chip, ``max/mean ≈ 1 + sqrt(2·ln(ep)·(1 − 1/ep)/λ)``
      (Gaussian maximum of ep near-independent Poisson loads), capped by
      ``max(capacity_factor, 1.0)`` — the dispatch buffers physically
      drop anything beyond capacity.

    Every ep = 1 lane returns exactly 1.0 (``np.where`` overlay), so the
    derate is bit-invisible to non-ep candidates.
    """
    e = float(max(n_experts, 1))
    e_pad = float(max(n_experts, pad_experts, 1))
    k = float(max(top_k, 1))
    pad_derate = np.minimum(e_pad / ep, e) * ep / e
    lam = np.maximum(tokens_mb * k / ep, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        stoch = 1.0 + np.sqrt(2.0 * np.log(ep) * (1.0 - 1.0 / ep) / lam)
    stoch = np.minimum(stoch, max(float(capacity_factor), 1.0))
    return np.where(ep > 1.0, pad_derate * stoch, 1.0)


def plan_grid(cfg: ModelConfig, hw: Union[HardwareSpec, str],
              chips_list: Sequence[int], batch_list: Sequence[int], *,
              seq: int = 1, algorithms: Sequence[str] = ("auto",),
              pod_size: Optional[int] = None, max_pp: int = 1,
              max_ep: int = 1, interleave: int = 1,
              zero_stages: Sequence[int] = (0,), remat: bool = False,
              check_capacity: bool = True, explain: bool = False,
              goodput: bool = False,
              failure: Optional[FailureModel] = None) -> PlanGrid:
    """Evaluate every (dp × tp × pp × ep) × m × zero × algorithm × batch
    × chips candidate in one broadcast pass.

    ``algorithms`` entries are concrete collective tags (including the
    ``bidir`` alias) or ``"auto"`` (per-axis α–β argmin over the full
    menu); each entry is its own candidate row, exactly like the scalar
    planner.  ``max_pp = 1`` (the default) reproduces the three-axis candidate
    space bit-for-bit; larger values add every pipeline size that divides
    the chip budget and fits the layer stack (``pp ≤ n_layers``; an
    uneven ceil-split prices pp ∤ n_layers), crossed with every 1F1B
    microbatch count dividing the per-dp batch.  ``max_ep > 1`` admits
    expert-parallel sizes dividing both the chip budget and the padded
    expert count; ``interleave = v > 1`` prices the interleaved-1F1B
    schedule (ramp bubble ÷ ``min(v, L // pp)`` virtual stages at v×
    boundary p2p traffic).

    ``zero_stages`` adds ZeRO sharding stages as a candidate axis (the
    default ``(0,)`` searches none); ``remat=True`` rematerializes
    activations everywhere (half the saved-activation footprint, +1/3
    FLOPs).  When the spec carries a positive ``hbm_capacity_bytes`` and
    ``check_capacity`` is True, every candidate's working set
    (``launch/memory``) is priced first and infeasible candidates are
    pruned *before* the broadcast pricing passes; a grid point left with
    no feasible candidate raises a ValueError naming the point and the
    smallest ZeRO stage (or remat) that would save it.
    ``check_capacity=False`` keeps infeasible rows, merely marking
    ``fits``/``hbm_bytes`` — the what-if view.

    ``explain=True`` additionally carries the attribution payload:
    per-candidate additive term splits (:class:`ExplainTerms`) and
    per-point prune-reason counts (:func:`_point_prune_stats`), consumed
    by ``repro_torch.obs.explain`` / CLI ``--explain``.  The flag never touches
    the priced numbers — every array the default path returns is
    bit-identical either way.

    ``goodput=True`` prices failures on top of the healthy step
    (``repro_torch.resilience.failures``): each candidate's persisted
    checkpoint bytes (params + optimizer states under its ZeRO/tp/pp/ep
    sharding) over ``hw.ckpt_bw`` give its checkpoint cost, the Young/Daly
    interval sets the cadence, and the amortized per-step overheads —
    checkpoint write, expected rework, expected restart — are *added to*
    ``runtime`` before ranking, so a smaller mesh with a cheaper failure
    bill can beat the healthy winner.  ``failure`` supplies the mesh
    failure statistics (default: infinite per-chip MTBF, under which
    every overhead term is exactly 0.0 and the ranking is bit-identical
    to ``goodput=False``).

    Every pass runs under named trace spans (``plan_grid`` →
    ``enumerate`` / ``feasibility`` / ``price_collectives`` /
    ``sweep_classify``; see :mod:`repro_torch.obs.trace`) that are no-ops
    unless tracing is enabled.
    """
    with trace.span("plan_grid", arch=getattr(cfg, "name", "?"),
                    n_chips=len(chips_list), n_batch=len(batch_list),
                    max_pp=max_pp, explain=explain) as sp:
        grid = _plan_grid_impl(
            cfg, hw, chips_list, batch_list, seq=seq, algorithms=algorithms,
            pod_size=pod_size, max_pp=max_pp, max_ep=max_ep,
            interleave=interleave, zero_stages=zero_stages,
            remat=remat, check_capacity=check_capacity, explain=explain,
            goodput=goodput, failure=failure)
        if trace.enabled():
            sp.set(n_enumerated=grid.n_enumerated,
                   n_candidates=grid.n_candidates,
                   n_pruned=int(grid.n_pruned.sum()))
            trace.count("planner.candidates_enumerated", grid.n_enumerated)
            trace.count("planner.candidates_evaluated", grid.n_candidates)
        return grid


def _plan_grid_impl(cfg: ModelConfig, hw: Union[HardwareSpec, str],
                    chips_list: Sequence[int], batch_list: Sequence[int], *,
                    seq: int, algorithms: Sequence[str],
                    pod_size: Optional[int], max_pp: int, max_ep: int,
                    interleave: int, zero_stages: Sequence[int],
                    remat: bool, check_capacity: bool, explain: bool,
                    goodput: bool = False,
                    failure: Optional[FailureModel] = None) -> PlanGrid:
    if isinstance(hw, str):
        hw = get_hardware(hw)
    if not chips_list or not batch_list:
        raise ValueError("chips_list and batch_list must be non-empty")
    if not algorithms:
        raise ValueError("need at least one algorithm (or 'auto')")
    if max_ep < 1:
        raise ValueError(f"max_ep must be >= 1, got {max_ep}")
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if not zero_stages:
        raise ValueError("need at least one ZeRO stage (0 = unsharded)")
    bad = [z for z in zero_stages if z not in ZERO_STAGES]
    if bad:
        raise ValueError(f"unknown ZeRO stage(s) {bad}; valid: "
                         f"{ZERO_STAGES}")
    menu = collectives.ALGORITHMS
    algo_codes = [-1 if a == "auto"
                  else menu.index(collectives.canonical_algorithm(a))
                  for a in algorithms]

    with trace.span("plan_grid.enumerate") as sp:
        cand = _enumerate_candidates(cfg, chips_list, batch_list, max_pp,
                                     algo_codes, tuple(int(z) for z in
                                                       zero_stages),
                                     max_ep=max_ep)
        n_enumerated = int(cand["dp"].size)
        sp.set(n_enumerated=n_enumerated)
    point_shape = (len(chips_list), len(batch_list))
    n_pruned = np.zeros(point_shape, dtype=np.int64)

    # --- memory feasibility: price the working set, cut before pricing -------
    with trace.span("plan_grid.feasibility") as sp:
        capacity = float(hw.hbm_capacity_bytes)
        batch_arr = np.asarray(batch_list, dtype=np.float64)
        ws = memory_mod.training_working_set(
            cfg, batch=batch_arr[cand["batch_idx"]], seq=seq,
            dp=cand["dp"], tp=cand["tp"], pp=cand["pp"], ep=cand["ep"],
            microbatches=cand["microbatches"], zero_stage=cand["zero"],
            remat=remat)
        hbm = ws.total
        # checkpoint bytes ride along so the goodput overlay (if any)
        # prices each surviving candidate's own sharded persisted state
        persisted = ws.persisted + np.zeros_like(hbm)
        fits = hbm <= capacity if capacity > 0 else \
            np.ones(hbm.shape, dtype=bool)
        if check_capacity and capacity > 0 and not fits.all():
            np.add.at(n_pruned, (cand["chips_idx"][~fits],
                                 cand["batch_idx"][~fits]), 1)
            survivors = np.zeros(point_shape, dtype=np.int64)
            np.add.at(survivors, (cand["chips_idx"], cand["batch_idx"]),
                      fits.astype(np.int64))
            if (survivors == 0).any():
                ci, bi = np.argwhere(survivors == 0)[0]
                raise _capacity_error(cfg, capacity, chips_list[ci],
                                      batch_list[bi], seq, max_pp, remat,
                                      zero_stages, max_ep=max_ep)
            cand = {k: v[fits] for k, v in cand.items()}
            hbm = hbm[fits]
            persisted = persisted[fits]
            fits = np.ones(hbm.shape, dtype=bool)
        min_zero_to_fit = np.full(point_shape, np.iinfo(np.int64).max)
        np.minimum.at(min_zero_to_fit,
                      (cand["chips_idx"], cand["batch_idx"]),
                      np.where(fits, cand["zero"],
                               np.iinfo(np.int64).max))
        sp.set(n_pruned=int(n_pruned.sum()), n_kept=int(cand["dp"].size))

    _sp_price = trace.span("plan_grid.price_collectives")
    _sp_price.__enter__()
    dp = cand["dp"].astype(np.float64)
    tp = cand["tp"].astype(np.float64)
    pp = cand["pp"].astype(np.float64)
    ep = cand["ep"].astype(np.float64)
    m = cand["microbatches"].astype(np.float64)
    zero = cand["zero"]
    code = np.asarray(algo_codes, dtype=np.int64)[cand["req_idx"]]
    batch = batch_arr[cand["batch_idx"]]

    n_total, n_active = param_counts(cfg)
    width = _model_width(cfg)
    tokens = batch if cfg.family == "mlp" else batch * float(seq)
    act_dtype = 4 if cfg.family == "mlp" else 2     # fp32 MLP, bf16 LMs
    syncs = 4.0 if cfg.family in _ATTENTION_FAMILIES else 2.0
    params_bytes = n_total * 4.0                    # fp32 master weights

    # --- per-candidate work terms (step- and microbatch-level) ---------------
    # ceil: when pp ∤ n_layers the widest stage sets the pipeline critical
    # path, inflating per-stage work by ceil(L/pp)·pp/L (exactly 1.0, and
    # bit-identical, when pp divides L)
    stage_layers = np.ceil(float(cfg.n_layers) / pp)
    uneven = stage_layers * pp / float(cfg.n_layers)
    flops_step = 6.0 * n_active * tokens / (dp * tp * pp) * uneven
    if remat:   # backward recomputes the forward: 6·N·tokens → 8·N·tokens
        flops_step = flops_step * memory_mod.REMAT_FLOPS_FACTOR
    # ep shards the routed experts: each chip holds E_pad/ep experts and
    # computes only its shard's routed FLOPs, derated by routing imbalance
    # (expert FLOPs are exp_share of active; the dense remainder — attention,
    # router, shared experts — replicates over ep).  The overlay leaves
    # every ep = 1 lane bit-untouched.
    ep_mask = ep > 1.0
    e_total = 0.0
    derate = 1.0
    if ep_mask.any():
        from repro_torch.launch.specs import expert_param_counts
        e_total, e_active = expert_param_counts(cfg)
        tokens_mb = tokens / (dp * m)
        derate = moe_routing_derate(
            ep, tokens_mb, n_experts=cfg.n_experts,
            pad_experts=cfg.pad_experts_to, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor)
        exp_flops = 6.0 * e_active * tokens / (dp * tp * pp) * uneven
        if remat:
            exp_flops = exp_flops * memory_mod.REMAT_FLOPS_FACTOR
        flops_step = np.where(
            ep_mask, flops_step + exp_flops * (derate / ep - 1.0),
            flops_step)
    flops_mb = flops_step / m
    act_bytes = (tokens / dp) * width * act_dtype   # one boundary activation
    act_mb = act_bytes / m
    # ep also shards the streamed expert weights (fp32 master copies)
    params_stream = params_bytes
    if ep_mask.any() and e_total > 0.0:
        params_stream = np.where(
            ep_mask, params_bytes - e_total * 4.0 + e_total * 4.0 / ep,
            params_bytes)
    mem_mb = params_stream / (tp * pp) + 2.0 * stage_layers * act_mb

    # --- per-axis link routing as boolean masks ------------------------------
    dp_pod, tp_pod, pp_pod, ep_pod = _pod_masks(dp, tp, pp, ep, pod_size)
    if pod_size is not None and \
            bool(dp_pod.any() | pp_pod.any() | tp_pod.any()
                 | ep_pod.any()):
        hw.bandwidth_for(POD_LINK)  # actionable KeyError if spec has none
    bw_pri, a_pri = hw.bandwidth_for(None), hw.alpha_for(None)
    if pod_size is not None and POD_LINK in hw.extra_links:
        bw_pod, a_pod = hw.bandwidth_for(POD_LINK), hw.alpha_for(POD_LINK)
    else:
        bw_pod, a_pod = bw_pri, a_pri
    dp_bw = np.where(dp_pod, bw_pod, bw_pri)
    dp_alpha = np.where(dp_pod, a_pod, a_pri)
    tp_bw = np.where(tp_pod, bw_pod, bw_pri)
    tp_alpha = np.where(tp_pod, a_pod, a_pri)
    pp_bw = np.where(pp_pod, bw_pod, bw_pri)
    pp_alpha = np.where(pp_pod, a_pod, a_pri)
    ep_bw = np.where(ep_pod, bw_pod, bw_pri)
    ep_alpha = np.where(ep_pod, a_pod, a_pri)

    # --- collective algorithm selection, per axis, whole grid at once --------
    # "auto" rows see the full menu; fixed rows see exactly their algorithm
    allowed = (code[None, :] < 0) | \
        (np.arange(len(menu))[:, None] == code[None, :])
    dp_wire, dp_steps, dp_sel = collectives.best_all_reduce_grid(
        params_stream / (tp * pp), dp, dp_bw, dp_alpha, menu,
        allowed=allowed)
    tp_wire, tp_steps, tp_sel = collectives.best_all_reduce_grid(
        act_mb, tp, tp_bw, tp_alpha, menu, allowed=allowed)
    # ZeRO rows pin the dp sync to the structural RS+AG schedule — the
    # np.where overlay leaves every zero = 0 element bit-untouched, and
    # the guard skips the pass entirely on the default (0,) search
    zmask = zero >= 1
    if zmask.any():
        zcost = collectives.zero_dp_sync(params_stream / (tp * pp), dp,
                                         zero)
        dp_wire = np.where(zmask, zcost.wire_bytes, dp_wire)
        dp_steps = np.where(zmask, zcost.steps, dp_steps)
    dp_time = dp_alpha * dp_steps + dp_wire / dp_bw
    tp_scale = syncs * stage_layers                 # syncs per microbatch
    tp_wire_mb = tp_scale * tp_wire
    tp_steps_mb = tp_scale * tp_steps
    tp_time = tp_alpha * tp_steps_mb + tp_wire_mb / tp_bw

    # pp boundary p2p: 2 hops (act fwd + grad bwd) per microbatch; the
    # interleaved schedule multiplies boundary traffic by its virtual
    # stage count (every chunk boundary crosses chips)
    pp_bytes_mb = collectives.pp_boundary_bytes(act_mb, pp)
    pp_steps_mb = 2.0 * np.where(pp > 1.0, 1.0, 0.0)
    if interleave > 1:
        vstages = np.where(
            pp > 1.0,
            np.maximum(1.0, np.minimum(float(interleave),
                                       np.floor(float(cfg.n_layers) / pp))),
            1.0)
        pp_bytes_mb = pp_bytes_mb * vstages
        pp_steps_mb = pp_steps_mb * vstages
    else:
        vstages = np.ones_like(pp)
    pp_time = pp_alpha * pp_steps_mb + pp_bytes_mb / pp_bw

    # ep dispatch + combine: one capacity-factor-sized all-to-all pair per
    # MoE layer on the ep axis's own link, wire bytes derated by routing
    # imbalance.  Scalar zeros on an ep-less grid keep every downstream
    # sum bit-identical (x + 0.0 is bitwise identity for finite x ≥ 0).
    if bool(np.any(ep_mask)):
        payload_mb = act_mb * float(cfg.moe_top_k) * float(
            cfg.capacity_factor)
        ecost = collectives.ep_dispatch_combine(payload_mb, ep)
        ep_wire_mb = stage_layers * ecost.wire_bytes * derate
        ep_steps_mb = stage_layers * ecost.steps
        ep_time = ep_alpha * ep_steps_mb + ep_wire_mb / ep_bw
    else:
        ep_wire_mb = ep_steps_mb = ep_time = 0.0
    _sp_price.set(n_candidates=int(dp.size))
    _sp_price.__exit__(None, None, None)

    # --- 1F1B pipeline fill + one Ridgeline sweep over the candidate set -----
    # The serialized critical path holds m + pp − 1 microbatch slots
    # (t_step = (m + pp − 1) · t_microbatch = (m + pp − 1)/m · t_work), so
    # each per-microbatch resource time scales by `fill`; expressed as a
    # per-candidate derating of the machine peaks (peak/fill, α·fill) so
    # one vectorized sweep prices and classifies everything.  At
    # pp = m = 1 the fill is exactly 1.0 and every number is bit-for-bit
    # the non-pipelined model.
    # interleaving shrinks the ramp to (pp − 1)/vstages microbatch slots;
    # the default interleave = 1 branch keeps the classic expression (and
    # its bit-exact association) untouched
    if interleave > 1:
        fill = m + (pp - 1.0) / vstages
    else:
        fill = m + pp - 1.0
    # dp grad sync runs once per step (after the last backward), unfilled;
    # per-axis α–β times fold into primary-link-equivalent bytes
    t_net_step = fill * (tp_time + pp_time + ep_time) + dp_time
    eff_net_bytes = t_net_step * hw.net_bw
    with trace.span("plan_grid.sweep_classify", n_candidates=int(dp.size)):
        res = sweep_mod.sweep(
            flops_mb, mem_mb, eff_net_bytes, hw,
            peak_flops=hw.peak_flops / fill, hbm_bw=hw.hbm_bw / fill,
            alpha_compute=hw.alpha_compute * fill,
            alpha_memory=hw.alpha_memory * fill, net_steps=0.0)

    # --- attribution payload (explain=True only; never touches the numbers) --
    explain_terms = prune_reasons = None
    if explain:
        comp_alpha_s = np.where(flops_mb > 0, hw.alpha_compute * fill, 0.0)
        mem_alpha_s = np.where(mem_mb > 0, hw.alpha_memory * fill, 0.0)
        explain_terms = ExplainTerms(
            comp_alpha_s=comp_alpha_s,
            comp_flops_s=res.t_compute - comp_alpha_s,
            mem_alpha_s=mem_alpha_s,
            mem_bytes_s=res.t_memory - mem_alpha_s,
            net_dp_alpha_s=dp_alpha * dp_steps,
            net_dp_bytes_s=dp_wire / dp_bw,
            net_tp_alpha_s=fill * tp_alpha * tp_steps_mb,
            net_tp_bytes_s=fill * tp_wire_mb / tp_bw,
            net_pp_alpha_s=fill * pp_alpha * pp_steps_mb,
            net_pp_bytes_s=fill * pp_bytes_mb / pp_bw,
            net_ep_alpha_s=(np.zeros_like(dp_time)
                            if np.isscalar(ep_steps_mb)
                            else fill * ep_alpha * ep_steps_mb),
            net_ep_bytes_s=(np.zeros_like(dp_time)
                            if np.isscalar(ep_wire_mb)
                            else fill * ep_wire_mb / ep_bw))
        prune_reasons = {
            (ci, bi): dict(_point_prune_stats(
                width, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers,
                _padded_experts(cfg), int(c), int(b), max_pp, max_ep))
            for ci, c in enumerate(chips_list)
            for bi, b in enumerate(batch_list)}

    attained = np.where(res.runtime > 0,
                        sweep_mod._safe_div(flops_step, res.runtime), 0.0)

    # --- failure-aware goodput overlay (goodput=True only) ------------------
    # Folds the amortized failure bill into the effective step time the
    # ranking sees.  Every overhead term is exactly +0.0 under an infinite
    # MTBF, so the default FailureModel keeps runtime (and therefore the
    # committed plan goldens) bit-identical.
    runtime = res.runtime
    fmodel = goodput_arr = ckpt_ov_s = rework_arr_s = restart_arr_s = None
    interval_arr_s = None
    if goodput:
        fmodel = failure if failure is not None else FailureModel()
        with trace.span("plan_grid.goodput", n_candidates=int(dp.size)):
            (ckpt_ov_s, rework_arr_s, restart_arr_s, interval_arr_s,
             goodput_arr) = failures_mod.goodput_terms(
                res.runtime, persisted, dp * tp * pp * ep,
                ckpt_bw=hw.ckpt_bw, model=fmodel)
        runtime = res.runtime + ckpt_ov_s + rework_arr_s + restart_arr_s

    err = max(float(hw.model_rel_error), 0.0)
    return PlanGrid(
        cfg_name=cfg.name, hardware=hw.name,
        chips_list=tuple(int(c) for c in chips_list),
        batch_list=tuple(int(b) for b in batch_list),
        seq=seq, pod_size=pod_size, max_pp=max_pp, max_ep=max_ep,
        interleave=interleave,
        algorithms=tuple(algorithms),
        zero_stages=tuple(int(z) for z in zero_stages), remat=remat,
        hbm_capacity_bytes=capacity, check_capacity=check_capacity,
        chips_idx=cand["chips_idx"], batch_idx=cand["batch_idx"],
        dp=cand["dp"], tp=cand["tp"], pp=cand["pp"], ep=cand["ep"],
        microbatches=cand["microbatches"], zero=cand["zero"],
        req_idx=cand["req_idx"],
        dp_algo_idx=dp_sel, tp_algo_idx=tp_sel,
        dp_pod=dp_pod, tp_pod=tp_pod, pp_pod=pp_pod, ep_pod=ep_pod,
        vstages=vstages.astype(np.int64),
        flops=flops_step, mem_bytes=m * mem_mb,
        net_bytes=dp_wire + m * tp_wire_mb + m * pp_bytes_mb
        + m * ep_wire_mb,
        net_steps=dp_steps + m * tp_steps_mb + m * pp_steps_mb
        + m * ep_steps_mb,
        t_compute=res.t_compute, t_memory=res.t_memory,
        t_network=res.t_network, runtime=runtime,
        bottleneck=res.bottleneck,
        peak_fraction=sweep_mod._safe_div(attained, hw.peak_flops),
        runtime_lo=np.maximum(runtime * (1.0 - err), 0.0),
        runtime_hi=runtime * (1.0 + err),
        hbm_bytes=hbm, fits=fits, n_enumerated=n_enumerated,
        n_pruned=n_pruned, min_zero_to_fit=min_zero_to_fit,
        explain_terms=explain_terms, prune_reasons=prune_reasons,
        failure=fmodel, goodput=goodput_arr, ckpt_overhead_s=ckpt_ov_s,
        rework_s=rework_arr_s, restart_s=restart_arr_s,
        ckpt_interval_s=interval_arr_s)
