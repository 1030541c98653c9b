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

``update_in_place(grads, state, params) -> state`` is ``update`` and
``apply_updates`` written into the state's and the params' buffers a leaf at
a time, the reference's donated step (``donate_argnums``): the same
arithmetic, one leaf's temporaries in place of a second state.

Every quantity stays a tensor on the params' device, the step counter too,
so an update on the card makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _zeros_f32(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _clip_scale(grads: Params, clip_norm: float) -> Optional[torch.Tensor]:
    """``min(1, clip_norm / (‖g‖ + 1e-9))`` over every grad; None without a
    clip."""
    if clip_norm <= 0:
        return None
    return torch.clamp(clip_norm / (global_norm(grads) + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    g = g.float()
    return g if scale is None else g * scale


def _leafwise(leaf: Callable, grads: Params, moments: Tuple[Params, ...],
              params: Params) -> list:
    """``leaf(g, *moments, p) -> (*moments, update)`` over the trees' leaves:
    the new moments' trees and the updates' tree."""
    rows = [leaf(*xs) for xs in zip(*(tree_leaves(t)
                                      for t in (grads, *moments, params)))]
    return [tree_unflatten(params, list(col)) for col in zip(*rows)]


def _leafwise_in_place(leaf: Callable, grads: Params,
                       moments: Tuple[Params, ...], params: Params) -> None:
    """``_leafwise`` written into ``moments``' and ``params``' buffers a leaf
    at a time (``params += update``): the device holds one leaf's
    temporaries where ``_leafwise`` holds new moments and every update."""
    for xs in zip(*(tree_leaves(t) for t in (grads, *moments, params))):
        *new, update = leaf(*xs)
        for buf, x in zip(xs[1:-1], new):
            buf.copy_(x)
        xs[-1].add_(update)


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

    def _leaf(self, grads: Params, step: torch.Tensor) -> Callable:
        """The update of one leaf at ``step`` (after the increment), clipped
        by ``grads``' global norm: ``(g, mu, nu, p) -> (mu, nu, update)``."""
        scale = _clip_scale(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def leaf(g, m, v, p):
            g = _clipped(g, scale)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return m, v, (-lr * u).to(p.dtype)
        return leaf

    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState]:
        step = state.step + 1
        mu, nu, updates = _leafwise(self._leaf(grads, step), grads,
                                    (state.mu, state.nu), params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    def update_in_place(self, grads: Params, state: AdamWState,
                        params: Params) -> AdamWState:
        """``update`` and ``apply_updates`` written into ``state``'s moments
        and ``params``' buffers, bit for bit: the caller's old state is
        gone."""
        step = state.step + 1
        _leafwise_in_place(self._leaf(grads, step), grads,
                           (state.mu, state.nu), params)
        return state._replace(step=step)


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

    def _leaf(self, grads: Params, step: torch.Tensor) -> Callable:
        """``(g, momentum, p) -> (momentum, update)`` at ``step``."""
        scale = _clip_scale(grads, self.clip_norm)
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else self.learning_rate)

        def leaf(g, m, p):
            m = self.momentum * m + _clipped(g, scale)
            return m, (-lr * m).to(p.dtype)
        return leaf

    def update(self, grads: Params, state: SGDState, params: Params
               ) -> Tuple[Params, SGDState]:
        step = state.step + 1
        mom, updates = _leafwise(self._leaf(grads, step), grads,
                                 (state.momentum,), params)
        return updates, SGDState(step=step, momentum=mom)

    def update_in_place(self, grads: Params, state: SGDState,
                        params: Params) -> SGDState:
        """As ``AdamW.update_in_place``."""
        step = state.step + 1
        _leafwise_in_place(self._leaf(grads, step), grads, (state.momentum,),
                           params)
        return state._replace(step=step)


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
