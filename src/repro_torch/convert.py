"""Parameters and train states from the JAX package's layout, as numpy,
to the port's.

The layouts are the same (weights ``(d_in, d_out)``, as ``dense_init``
makes them), so nothing is transposed: each leaf becomes a tensor of the
same dtype on the target device.  ``opt_state_from_numpy`` and
``train_state_from_numpy`` carry a run over mid-way, so both packages can
go on from one state at a step where the bias correction matters.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import Params
from repro_torch.optim.optimizer import AdamWState, SGDState
from repro_torch.train.loop import TrainState
from repro_torch.tree import tree_map


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=dev)


def mlp_params_from_numpy(tree: Mapping, device: DeviceLike = None) -> Params:
    """``{"layers": [{"w", "b"}, ...], "head": {"w", "b"}}`` of numpy arrays."""
    dev = resolve_device(device)
    return {
        "layers": [{"w": _tensor(lyr["w"], dev), "b": _tensor(lyr["b"], dev)}
                   for lyr in tree["layers"]],
        "head": {"w": _tensor(tree["head"]["w"], dev),
                 "b": _tensor(tree["head"]["b"], dev)},
    }


def _tree(x: Any, dev: torch.device) -> Any:
    return tree_map(lambda a: _tensor(a, dev), x)


def _fields(x: Any) -> dict:
    """A NamedTuple (the JAX package's states) or a mapping, as a dict."""
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def _step(x: Any, dev: torch.device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)


def opt_state_from_numpy(state: Any, device: DeviceLike = None):
    """An ``AdamWState`` (fields step, mu, nu) or ``SGDState`` (step,
    momentum) of numpy leaves -> the port's, the step an int32 scalar."""
    dev = resolve_device(device)
    f = _fields(state)
    step = _step(f["step"], dev)
    if set(f) == {"step", "mu", "nu"}:
        return AdamWState(step=step, mu=_tree(f["mu"], dev),
                          nu=_tree(f["nu"], dev))
    if set(f) == {"step", "momentum"}:
        return SGDState(step=step, momentum=_tree(f["momentum"], dev))
    raise ValueError(f"not an AdamW or SGD state: fields {sorted(f)}")


def train_state_from_numpy(state: Any, device: DeviceLike = None,
                           generator: Optional[torch.Generator] = None
                           ) -> TrainState:
    """The JAX package's ``TrainState`` (params, opt_state, step, rng) of
    numpy leaves -> the port's.  A JAX PRNG key has no torch counterpart:
    the port's ``rng`` is ``generator``."""
    dev = resolve_device(device)
    f = _fields(state)
    return TrainState(
        params=_tree(f["params"], dev),
        opt_state=opt_state_from_numpy(f["opt_state"], dev),
        step=_step(f["step"], dev), rng=generator)


def _unstack(blocks: Mapping) -> list:
    """A tree whose leaves share a leading layer axis -> a list of trees."""
    def leaves(t):
        for v in t.values():
            yield from (leaves(v) if isinstance(v, Mapping) else (v,))

    n = len(next(iter(leaves(blocks))))

    def take(t, i):
        return {k: take(v, i) if isinstance(v, Mapping) else v[i]
                for k, v in t.items()}

    return [take(blocks, i) for i in range(n)]


def lm_params_from_numpy(tree: Mapping, device: DeviceLike = None) -> Params:
    """The JAX package's ``transformer.init_lm`` tree, as numpy, for the
    port's ``models.transformer``.

    With ``scan_layers`` the reference stacks every block leaf on a leading
    layer axis (``blocks["attn"]["wq"]`` is (L, d, q_dim)); without it,
    ``blocks`` is a list of per-layer trees.  Both become the port's list.
    """
    dev = resolve_device(device)
    blocks = tree["blocks"]
    if isinstance(blocks, Mapping):
        blocks = _unstack(blocks)
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_tree(blk, dev) for blk in blocks]
    return out
