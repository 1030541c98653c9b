"""Per-chip working-set model: what a candidate mesh must *hold*, in bytes,
copied from ``repro.launch.memory``.

The Ridgeline bounds a candidate's step *time*; this module bounds whether
the candidate can execute at all.  ``HardwareSpec.hbm_capacity_bytes`` is
the per-chip budget, and the planner (``launch/plan_grid``) prunes every
(dp × tp × pp × m × zero) candidate whose modeled footprint exceeds it —
*before* the broadcast pricing passes, so infeasible candidates cost
nothing downstream.

Training footprint per chip (fp32 master weights + AdamW, matching
``models/common`` / ``optim/optimizer``):

    params      4 B/param · N_ep / (tp·pp)         [/ dp at ZeRO-3]
    grads       4 B/param · N_ep / (tp·pp)         [/ dp at ZeRO-2+]
    optimizer   8 B/param · N_ep / (tp·pp)  (μ+ν)  [/ dp at ZeRO-1+]
    activations coeff · ceil(L/pp) · tokens/(dp·m) · width · act_B / tp
                  · min(m, pp)  in-flight 1F1B microbatches

where ``N_ep = (N − N_experts) + N_experts/ep``: the routed expert
tensors (``launch/specs.expert_param_counts``) shard across the
expert-parallel axis while the dense remainder replicates over it, and
``ceil(L/pp)`` charges the widest stage when pp ∤ n_layers (uneven
ceil-split; exact L/pp when pp divides the stack).

where ``coeff`` is 2 saved boundary tensors per layer, dropping to 1 under
rematerialization (only the block boundary survives; everything else is
recomputed in backward at +1/3 step FLOPs — the planner's ``--remat``
moves candidates along the ridgeline, trading this footprint for compute).
The activation term shards by tp because the sharding layer runs
Megatron-SP (the JAX package's ``launch/dryrun._rules_for``: saved residual-stream
activations shard their seq axis over the model axis).

ZeRO stages shard *state* across the dp axis (Rajbhandari et al.):
stage 1 the optimizer moments, stage 2 also the gradients, stage 3 also
the parameters.  The wire-byte price of the extra all-gather /
reduce-scatter traffic lives in ``distributed/collectives.zero_dp_sync``;
this module only accounts the bytes *resident*.

Decode (serving) footprint per chip: bf16 weights ``2·N/(tp·pp)`` plus the
KV cache ``(L/pp) · (batch/dp) · seq · 2 · kv_dim · 2 B / tp`` — no grads,
no optimizer states.

Everything is NumPy-vectorized: every mesh argument broadcasts, so the
whole planner candidate set prices its footprint in one pass, aligned
elementwise with ``plan_grid``'s struct-of-arrays.

Each function the reference decorates with
``repro.analysis.contracts.shape_contract`` carries that contract in its
docstring (``Shape contract: ...``); the port has no ``analysis`` package
yet, and ROADMAP Queue 1 item 13 brings the runtime check back.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Union

import numpy as np

if TYPE_CHECKING:  # torch-backed; the accounting itself is numpy-only
    from repro_torch.models.config import ModelConfig

ArrayLike = Union[int, float, np.ndarray]

#: bytes per parameter, training (fp32 master weights — models/common keeps
#: param_dtype fp32; mixed precision casts activations, not weights)
PARAM_BYTES = 4.0
#: bytes per gradient element (optim/optimizer casts grads to fp32)
GRAD_BYTES = 4.0
#: bytes of AdamW optimizer state per parameter (μ + ν, both fp32)
OPT_BYTES = 8.0
#: bytes per parameter when serving (bf16 inference weights)
SERVE_PARAM_BYTES = 2.0
#: KV-cache element bytes (bf16 K and V)
KV_BYTES = 2.0

#: saved boundary activations per layer: 2 normally, 1 under remat
ACT_COEFF = 2.0
ACT_COEFF_REMAT = 1.0

#: extra step FLOPs under remat: backward recomputes the forward, taking
#: the classic 6·N·tokens accounting to 8·N·tokens
REMAT_FLOPS_FACTOR = 4.0 / 3.0


def _as_f64(x: ArrayLike) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _act_bytes_per_token(cfg: ModelConfig) -> float:
    """Activation element bytes: fp32 MLP tower, bf16 everything else
    (mirrors the planner's ``act_dtype`` traffic accounting)."""
    return 4.0 if cfg.family == "mlp" else 2.0


def _model_width(cfg: ModelConfig) -> int:
    return cfg.mlp_widths[0] if cfg.family == "mlp" else cfg.d_model


def _tokens(cfg: ModelConfig, batch: np.ndarray, seq: float) -> np.ndarray:
    return batch if cfg.family == "mlp" else batch * float(seq)


@dataclasses.dataclass(frozen=True)
class WorkingSet:
    """Per-chip resident bytes, decomposed; every field broadcasts."""

    params: np.ndarray
    grads: np.ndarray
    opt: np.ndarray
    activations: np.ndarray
    kv_cache: np.ndarray

    @property
    def total(self) -> np.ndarray:
        return (self.params + self.grads + self.opt + self.activations
                + self.kv_cache)

    @property
    def persisted(self) -> np.ndarray:
        """Per-chip bytes a checkpoint must write: params + optimizer
        states (grads and activations are transient — the checkpointer
        saves exactly the ``TrainState`` leaves that survive a restart).
        Under ZeRO/tp/pp/ep sharding each chip persists only its own
        shard, which is what makes checkpoint time mesh-dependent
        (``repro_torch.resilience.failures.ckpt_time_s``)."""
        return self.params + self.opt


def training_working_set(cfg: ModelConfig, *, batch: ArrayLike,
                         seq: int = 1, dp: ArrayLike = 1, tp: ArrayLike = 1,
                         pp: ArrayLike = 1, ep: ArrayLike = 1,
                         microbatches: ArrayLike = 1,
                         zero_stage: ArrayLike = 0,
                         remat: bool = False) -> WorkingSet:
    """Per-chip training footprint of a (dp, tp, pp, ep, m, zero) candidate.

    Shape contract: ``batch:(*g), dp:(*g), tp:(*g), pp:(*g), ep:(*g),
    microbatches:(*g), zero_stage:(*g) -> (*g)``.

    All mesh arguments broadcast elementwise (the planner passes its flat
    candidate arrays); scalars price one candidate.  ``zero_stage`` shards
    optimizer states (≥1), gradients (≥2), parameters (≥3) across dp.
    ``ep`` shards the routed expert tensors (and their grads/optimizer
    states, via the same ``shard`` slice) across the expert-parallel axis;
    the dense remainder — attention, router, shared experts — replicates
    over ep exactly as before, so ep = 1 reproduces the prior accounting
    bit-for-bit.
    """
    from repro_torch.launch.plan_grid import param_counts
    n_total, _ = param_counts(cfg)
    dp = _as_f64(dp)
    tp = _as_f64(tp)
    pp = _as_f64(pp)
    ep = _as_f64(ep)
    m = _as_f64(microbatches)
    zero = _as_f64(zero_stage)
    batch = _as_f64(batch)

    shard = n_total / (tp * pp)                 # this chip's model slice
    if (ep > 1.0).any():
        from repro_torch.launch.specs import expert_param_counts
        e_total, _ = expert_param_counts(cfg)
        if e_total > 0.0:
            # the np.where overlay leaves every ep = 1 lane bit-untouched
            shard = np.where(
                ep > 1.0,
                ((n_total - e_total) + e_total / ep) / (tp * pp), shard)
    params = PARAM_BYTES * shard / np.where(zero >= 3, dp, 1.0)
    grads = GRAD_BYTES * shard / np.where(zero >= 2, dp, 1.0)
    opt = OPT_BYTES * shard / np.where(zero >= 1, dp, 1.0)

    tokens = _tokens(cfg, batch, seq)
    coeff = ACT_COEFF_REMAT if remat else ACT_COEFF
    inflight = np.minimum(m, pp)                # 1F1B holds ≤ pp microbatches
    # ceil: when pp ∤ n_layers the widest (first) stages bound the budget
    acts = (coeff * np.ceil(float(cfg.n_layers) / pp)
            * (tokens / (dp * m)) * float(_model_width(cfg))
            * _act_bytes_per_token(cfg) / tp * inflight)
    zeros = np.zeros(np.broadcast_shapes(params.shape, acts.shape))
    return WorkingSet(params=params + zeros, grads=grads + zeros,
                      opt=opt + zeros, activations=acts + zeros,
                      kv_cache=zeros)


def decode_working_set(cfg: ModelConfig, *, batch: ArrayLike, seq: int,
                       dp: ArrayLike = 1, tp: ArrayLike = 1,
                       pp: ArrayLike = 1) -> WorkingSet:
    """Per-chip serving footprint: bf16 weights + the decode KV cache.

    Shape contract: ``batch:(*g), dp:(*g), tp:(*g), pp:(*g) -> (*g)``.

    The cache shards its batch over dp, its layers over pp, and (SP-decode,
    see the JAX package's ``launch/dryrun``) its seq axis over tp.  Families without
    attention KV (``kv_dim == 0``, e.g. the MLP tower) carry no cache.
    """
    from repro_torch.launch.plan_grid import param_counts
    n_total, _ = param_counts(cfg)
    dp = _as_f64(dp)
    tp = _as_f64(tp)
    pp = _as_f64(pp)
    batch = _as_f64(batch)

    params = SERVE_PARAM_BYTES * n_total / (tp * pp)
    kv_dim = float(cfg.kv_dim) if cfg.n_heads else 0.0
    kv = ((float(cfg.n_layers) / pp) * (batch / dp) * float(seq)
          * 2.0 * kv_dim * KV_BYTES / tp)
    zeros = np.zeros(np.broadcast_shapes(params.shape, kv.shape))
    return WorkingSet(params=params + zeros, grads=zeros, opt=zeros,
                      activations=zeros, kv_cache=kv + zeros)


def min_zero_stage(cfg: ModelConfig, capacity_bytes: float, *,
                   batch: ArrayLike, seq: int = 1, dp: ArrayLike = 1,
                   tp: ArrayLike = 1, pp: ArrayLike = 1, ep: ArrayLike = 1,
                   microbatches: ArrayLike = 1,
                   remat: bool = False) -> np.ndarray:
    """Smallest ZeRO stage at which each candidate fits; 4 when none does.

    Shape contract: ``batch:(*g), dp:(*g), tp:(*g), pp:(*g), ep:(*g),
    microbatches:(*g) -> (*g)``.

    Footprint is non-increasing in the stage (each stage shards strictly
    more state across dp), so the answer is the first of 0..3 that fits.
    ``capacity_bytes <= 0`` (unknown) makes everything stage 0.
    """
    shape = np.broadcast_shapes(*(np.shape(_as_f64(a)) for a in
                                  (batch, dp, tp, pp, ep, microbatches)))
    if capacity_bytes <= 0:
        return np.zeros(shape, dtype=np.int64)
    totals = np.stack([
        training_working_set(cfg, batch=batch, seq=seq, dp=dp, tp=tp, pp=pp,
                             ep=ep, microbatches=microbatches,
                             zero_stage=stage, remat=remat).total
        for stage in range(4)])
    fits = totals <= capacity_bytes
    return np.where(fits.any(axis=0), fits.argmax(axis=0), 4).astype(np.int64)
