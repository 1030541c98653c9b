"""Dispatch wrappers around the port's kernels, in model-native shapes.

``matmul`` collapses leading dims and calls the blocked-matmul wrapper;
``flash_attention`` views the model layout (B, S, H, dh) as the kernel's
(B, H, S, dh) and calls the flash-attention wrapper.  Each runs the CUDA
kernel for a CUDA tensor at every size and the plain version for a CPU
tensor.  The JAX package's padding (to 512) and its bypass of small shapes
(below 256) are TPU rules about block shapes and launch cost; the CUDA
kernels mask ragged edges themselves, so no padded copies are made here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.kernels.flash_attention import flash_attention_bhsd


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """(…, K) @ (K, N) with fused bias + activation; output in ``a.dtype``."""
    *lead, K = a.shape
    y = blocked_matmul(a.reshape(-1, K).contiguous(), b.contiguous(),
                       bias=bias, act=act)
    return y.reshape(*lead, b.shape[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout q (B,S,H,dh), k/v (B,S,K,dh) -> (B,S,H,dh).

    The kernel reads the transposed views in place and writes its output
    with ``q``'s strides, so a contiguous q gives a contiguous result; no
    padding and no small-S bypass.
    """
    o = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)
