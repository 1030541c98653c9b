"""Parameters from the JAX package's layout, as numpy, to the port's.

The layouts are the same (weights ``(d_in, d_out)``, as ``dense_init``
makes them), so nothing is transposed: each leaf becomes a tensor of the
same dtype on the target device.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import Params


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
    if isinstance(x, Mapping):
        return {k: _tree(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, dev) for v in x]
    return _tensor(x, dev)


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
