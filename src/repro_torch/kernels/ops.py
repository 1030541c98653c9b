"""Dispatch wrappers around the port's kernels, in model-native shapes.

``matmul`` collapses leading dims and calls the blocked-matmul wrapper:
the CUDA kernel for a CUDA tensor at every size, ``ref_matmul`` for a CPU
tensor.  The JAX package's pad-to-512 and its small-shape bypass are TPU
rules about block shapes and launch cost; the CUDA kernel masks ragged
edges itself, so no padded copies are made here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.blocked_matmul import blocked_matmul


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """(…, K) @ (K, N) with fused bias + activation; output in ``a.dtype``."""
    *lead, K = a.shape
    y = blocked_matmul(a.reshape(-1, K).contiguous(), b.contiguous(),
                       bias=bias, act=act)
    return y.reshape(*lead, b.shape[1])
