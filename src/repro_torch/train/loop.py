"""Train-step construction, as ``repro.train.loop``, for every family:
mlp, dense, moe, hybrid, ssm, enc-dec and VLM.

``build_train_step(cfg, optimizer)`` returns ``train_step(state, batch) ->
(state, metrics)``; a batch is a dict of tensors (``features`` and
``click`` for the mlp family, ``tokens`` and ``labels`` for the decoder
LMs, with ``frames`` for enc-dec and ``patches`` for a VLM, whose loss
covers the text positions only).  The decoder LMs' loss is the reference's
``lm_loss``: the CE plus ``cfg.router_aux_weight`` times the MoE layers'
load-balance loss (0 for the families without a router), with ``ce`` and
``aux`` in the metrics.  The step is functional: it returns a new state and
leaves the old one as it was (``TrainStepConfig.donate`` writes the new one
into the old one's buffers instead, where the device cannot hold both).

Gradient sync.  The JAX step's sync is implicit in its global-mean loss
(the SPMD lowering all-reduces the grads).  Here, when ``torch.distributed``
is initialised with a world above 1, each rank's step takes its own shard
of the batch and all-reduces every grad (SUM, then ÷ world) before the
optimizer; with equal shards that is the gradient of the global mean, and
the reported loss is averaged the same way.  With one process the step is
unchanged.  The params are a dict of tensors, not a ``Module``, so the sync
is plain ``dist.all_reduce``, not ``DistributedDataParallel``.

Under a mesh (the state laid out as DTensors by ``distributed.sharding``,
the batch sharded on its ``"batch"`` axes) the sync is DTensor's, as the
reference's is GSPMD's: each grad leaves autograd as a partial sum and is
reduced once into its optimizer state's layout (an all-reduce, or a
reduce-scatter where ZeRO shards the moments), and each updated param is
gathered back to its own layout.

Gradient compression (``TrainStepConfig.compression``, e.g.
``optim.compression.StatelessRoundTrip``) round-trips the grads after the
microbatch mean and, with a world above 1, after the all-reduce: the
reference's SPMD step compresses the global-mean gradient, and this order
keeps that arithmetic.  It sees the grads in the reference's layout, where
a model's blocks are stacked on a leading layer axis (``stack_blocks``), so
an int8 chunk spans the same elements, and takes the same scale, in both
packages.  The kernels are forward-only: a config
with ``use_flash`` or ``use_kernel_matmul`` trains on the CPU's plain
versions and raises on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mlp_dlrm as mlp_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models import vlm as vlm_mod
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace
from repro_torch.optim.optimizer import apply_updates, global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor                     # int32 scalar
    rng: Optional[torch.Generator]


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """Loss over one (micro)batch: ``(params, batch) -> (loss, metrics)``."""

    def lm_loss(params, batch):
        logits, aux = lm_mod.forward(params, batch["tokens"], cfg)
        ce = softmax_cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def encdec_loss(params, batch):
        logits, aux = encdec_mod.forward(params, batch["tokens"],
                                         batch["frames"], cfg)
        ce = softmax_cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux}

    def vlm_loss(params, batch):
        logits, aux = vlm_mod.forward(params, batch["tokens"],
                                      batch["patches"], cfg)
        ce = softmax_cross_entropy(logits[:, cfg.visual_tokens:],
                                   batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def mlp_loss(params, batch):
        loss = mlp_mod.loss_fn(params, batch["features"], batch["click"], cfg)
        return loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)}

    return {"encdec": encdec_loss, "vlm": vlm_loss,
            "mlp": mlp_loss}.get(cfg.family, lm_loss)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1                  # gradient-accumulation microbatches
    compression: Optional[Any] = None  # optim.compression round trip
    #: write the new params and optimizer state into the input state's
    #: buffers (the optimizer's ``update_in_place``; the reference's
    #: ``donate_argnums=(0,)``): the caller must not read the state it passed
    #: in.  Same values as the functional step; off a mesh only
    donate: bool = False


def _world() -> int:
    """Ranks that share the step (1 without an initialised process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _stacked(key: str, cfg: ModelConfig) -> bool:
    """Whether the reference stacks the per-layer trees under ``key``: an
    enc-dec model's always (``jax.vmap`` of the block init), the others'
    ``blocks`` with ``scan_layers`` (an xLSTM's never: its blocks differ)."""
    if key in ("enc_blocks", "dec_blocks"):
        return True
    return key == "blocks" and cfg.scan_layers and cfg.family != "ssm"


def stack_blocks(tree: Any, cfg: ModelConfig) -> Any:
    """``tree`` (params or grads) in the reference's layout: each list of
    per-layer trees that the reference stacks becomes one tree whose leaves
    have a leading layer axis."""
    if not isinstance(tree, dict):
        return tree
    return {k: (tree_map(lambda *xs: torch.stack(xs), *v)
                if isinstance(v, list) and _stacked(k, cfg)
                else stack_blocks(v, cfg))
            for k, v in tree.items()}


def unstack_blocks(stacked: Any, like: Any) -> Any:
    """``stack_blocks`` undone: ``stacked`` in the structure of ``like``."""
    if not isinstance(like, dict):
        return stacked
    return {k: ([tree_map(lambda x, i=i: x[i], stacked[k])
                 for i in range(len(v))]
                if isinstance(v, list) and not isinstance(stacked[k], list)
                else unstack_blocks(stacked[k], v))
            for k, v in like.items()}


def _on_mesh(params: Any) -> bool:
    """Whether the params are DTensors (laid out on a mesh of more than
    one device; on one device they stay local tensors)."""
    from torch.distributed.tensor import DTensor
    return isinstance(tree_leaves(params)[0], DTensor)


def _full(x):
    """A DTensor metric as the whole tensor; a local one as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _to_layout(x, like):
    """DTensor ``x`` redistributed to ``like``'s placements."""
    if tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def _state_layout(state: "TrainState", params: Any) -> Any:
    """The tree whose layout the grads take: the optimizer's first moment
    (AdamW's ``mu``, SGD's ``momentum``), else the params."""
    opt = state.opt_state
    return getattr(opt, "mu", getattr(opt, "momentum", params))


def build_train_step(cfg: ModelConfig, optimizer,
                     ts_cfg: TrainStepConfig = TrainStepConfig()):
    loss_fn = make_loss_fn(cfg)
    if ts_cfg.n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {ts_cfg.n_micro}")

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        # the metrics cloned: the mlp loss is its own "ce", and the world's
        # in-place all-reduce must not reach one storage twice
        return (loss.detach(),
                {k: v.detach().clone() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        n = ts_cfg.n_micro
        if n > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % n:
                raise ValueError(f"batch of {rows} does not split into "
                                 f"{n} equal microbatches")
            size = rows // n
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(n):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss, _, g = grads_of(params, mb)
                grads = tree_map(lambda a, b: a + b, grads, g)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = None
        else:
            loss, metrics, grads = grads_of(params, batch)

        if _on_mesh(params):
            # autograd leaves each grad a partial sum over the batch's mesh
            # axes: reduce it once into its optimizer state's layout (an
            # all-reduce; a reduce-scatter where the state is DP-sharded)
            grads = tree_map(_to_layout, grads, _state_layout(state, params))
            loss = loss.full_tensor()
            metrics = metrics and {k: _full(v) for k, v in metrics.items()}
        elif _world() > 1:
            world = _world()
            for x in (tree_leaves(grads) + [loss]
                      + list((metrics or {}).values())):
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
                x.div_(world)
        if metrics is None:
            # as the reference's scan over microbatches reports them
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        if ts_cfg.compression is not None:
            grads = unstack_blocks(ts_cfg.compression.round_trip(
                stack_blocks(grads, cfg)), grads)

        if ts_cfg.donate and not _on_mesh(params):
            opt_state = optimizer.update_in_place(grads, state.opt_state,
                                                  params)
        else:
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  params)
            new_params = apply_updates(params, updates)
            params = (tree_map(_to_layout, new_params, params)
                      if _on_mesh(params) else new_params)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads),
                       step=state.step)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1, rng=state.rng)
        return new_state, metrics

    return train_step


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     optimizer, device: DeviceLike = None) -> TrainState:
    """Params from ``generator`` (``init_mlp``, ``init_encdec``,
    ``init_vlm``, or ``init_lm`` for the decoder LMs), a fresh optimizer
    state and step 0 on ``device`` (None: the card)."""
    init = {"mlp": mlp_mod.init_mlp, "encdec": encdec_mod.init_encdec,
            "vlm": vlm_mod.init_vlm}.get(cfg.family, lm_mod.init_lm)
    with trace.span("train.init_state", arch=cfg.name, family=cfg.family):
        params = init(cfg, generator, device=device)
        return TrainState(
            params=params, opt_state=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
            rng=generator)


def model_param_specs(cfg: ModelConfig):
    """The logical specs of the params ``init_train_state`` builds, for
    every family: per-layer lists, as the port's params are."""
    if cfg.family == "encdec":
        return encdec_mod.encdec_specs(cfg)
    if cfg.family == "vlm":
        return vlm_mod.vlm_specs(cfg)
    if cfg.family == "mlp":
        return mlp_mod.mlp_specs(cfg)
    return lm_mod.lm_specs(cfg)
