"""AdamW and SGD-momentum over parameter trees, as ``repro.optim.optimizer``.

The functional API of the reference: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, with
``apply_updates(params, updates)``; optimizer state is fp32 whatever the
params' dtype.  The arithmetic is written out, because ``torch.optim``'s
differs in ways the reference's users see:

  * the learning rate and both bias corrections use the step *after* the
    increment, so ``warmup_cosine``, which is 0 at step 0, gives the first
    update ``peak / warmup``;
  * the global-norm clip sits inside ``update`` (AdamW clips at 1.0 by
    default, SGD not at all);
  * AdamW's defaults are ``b2 = 0.95`` and ``weight_decay = 0.1``, and the
    decay joins the normalised step before ``-lr`` multiplies both;
  * SGD's momentum is ``μ·m + g``, with no dampening;
  * each update is cast to its param's dtype.

Every quantity stays a tensor on the params' device, the step counter too,
so an update on the card makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _zeros_f32(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _clip(grads: Params, clip_norm: float) -> Params:
    """fp32 grads scaled by ``min(1, clip_norm / (‖g‖ + 1e-9))``."""
    grads = tree_map(lambda g: g.float(), grads)
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    return grads


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Schedule, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> AdamWState:
        return AdamWState(step=_step0(params), mu=_zeros_f32(params),
                          nu=_zeros_f32(params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return torch.as_tensor(self.learning_rate(step),
                                   dtype=torch.float32, device=step.device)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState]:
        step = state.step + 1
        grads = _clip(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Params


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: Union[Schedule, float] = 1e-2
    momentum: float = 0.9
    clip_norm: float = 0.0

    def init(self, params: Params) -> SGDState:
        return SGDState(step=_step0(params), momentum=_zeros_f32(params))

    def update(self, grads: Params, state: SGDState, params: Params
               ) -> Tuple[Params, SGDState]:
        step = state.step + 1
        grads = _clip(grads, self.clip_norm)
        mom = tree_map(lambda m, g: self.momentum * m + g,
                       state.momentum, grads)
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else self.learning_rate)
        updates = tree_map(lambda m, p: (-lr * m).to(p.dtype), mom, params)
        return updates, SGDState(step=step, momentum=mom)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``floor · peak_lr`` at ``total_steps``; ``step`` is a tensor."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
