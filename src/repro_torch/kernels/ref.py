"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``ref_*`` computes what its kernel computes, including the fp32
accumulation, so the CPU tests compare it with the JAX package and
``chip_smoke.py`` compares the CUDA kernel with it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: activation names the fused epilogue accepts, in the kernel's code order
#: (code 0 is no activation)
ACTS = ("relu", "relu2", "silu", "gelu")


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The epilogue's activation on an fp32 tensor.

    ``gelu`` is the tanh form: ``jax.nn.gelu`` defaults to
    ``approximate=True`` while ``F.gelu`` defaults to the erf form.
    """
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "relu2":
        r = torch.relu(y)
        return r * r
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unsupported activation {act!r}; have {ACTS}")


def ref_matmul(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """(M, K) @ (K, N) in fp32 + fp32 bias, activation, cast to ``a.dtype``."""
    y = torch.matmul(a.float(), b.float())
    if bias is not None:
        y = y + bias.float()
    return apply_act(y, act).to(a.dtype)
