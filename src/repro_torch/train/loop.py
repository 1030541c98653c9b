"""Train-step construction, as ``repro.train.loop``, for the mlp family.

``build_train_step(cfg, optimizer)`` returns ``train_step(state, batch) ->
(state, metrics)``; a batch is a dict of tensors (``features`` and
``click`` for the mlp family).  The step is functional: it returns a new
state and leaves the old one as it was.

Gradient sync.  The JAX step's sync is implicit in its global-mean loss
(the SPMD lowering all-reduces the grads).  Here, when ``torch.distributed``
is initialised with a world above 1, each rank's step takes its own shard
of the batch and all-reduces every grad (SUM, then ÷ world) before the
optimizer; with equal shards that is the gradient of the global mean, and
the reported loss is averaged the same way.  With one process the step is
unchanged.  The params are a dict of tensors, not a ``Module``, so the sync
is plain ``dist.all_reduce``, not ``DistributedDataParallel``.

The other families, and gradient compression, raise naming the ROADMAP
Queue 1 item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.models import mlp_dlrm as mlp_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizer import apply_updates, global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

#: where each family that is not ported yet waits (ROADMAP Queue 1)
_WAITS = {"dense": 7, "moe": 8, "ssm": 9, "hybrid": 9, "encdec": 10,
          "vlm": 10}


def _mlp_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "mlp":
        item = _WAITS.get(cfg.family)
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family ({cfg.name}) is not "
            f"ported yet" + (f": ROADMAP Queue 1 item {item}" if item
                             else "") + "; the port trains the mlp family")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor                     # int32 scalar
    rng: Optional[torch.Generator]


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """Loss over one (micro)batch: ``(params, batch) -> (loss, metrics)``."""
    _mlp_only(cfg, "the train loss")

    def mlp_loss(params, batch):
        loss = mlp_mod.loss_fn(params, batch["features"], batch["click"], cfg)
        return loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)}

    return mlp_loss


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1                  # gradient-accumulation microbatches
    compression: Optional[Any] = None  # not ported: ROADMAP Queue 1 item 11


def _world() -> int:
    """Ranks that share the step (1 without an initialised process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def build_train_step(cfg: ModelConfig, optimizer,
                     ts_cfg: TrainStepConfig = TrainStepConfig()):
    loss_fn = make_loss_fn(cfg)
    if ts_cfg.compression is not None:
        raise NotImplementedError(
            "gradient compression (optim/compression.py) is not ported yet: "
            "ROADMAP Queue 1 item 11")
    if ts_cfg.n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {ts_cfg.n_micro}")

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

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
        else:
            loss, _, grads = grads_of(params, batch)

        world = _world()
        if world > 1:
            for x in tree_leaves(grads) + [loss]:
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
                x.div_(world)
        metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}

        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads),
                       step=state.step)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1, rng=state.rng)
        return new_state, metrics

    return train_step


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     optimizer, device: DeviceLike = None) -> TrainState:
    """Params from ``generator`` (``init_mlp``), a fresh optimizer state and
    step 0 on ``device`` (None: the card)."""
    _mlp_only(cfg, "the train state")
    params = mlp_mod.init_mlp(cfg, generator, device=device)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device),
                      rng=generator)


def model_param_specs(cfg: ModelConfig):
    _mlp_only(cfg, "param specs")
    return mlp_mod.mlp_specs(cfg)
