"""Parameters from the JAX package's layout, as numpy, to the port's.

The layouts are the same (weights ``(d_in, d_out)``, as ``dense_init``
makes them), so nothing is transposed: each leaf becomes a tensor of the
same dtype on the target device.
"""
from __future__ import annotations

from typing import Mapping

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
