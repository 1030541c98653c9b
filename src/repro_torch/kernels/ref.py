"""Plain PyTorch versions of the port's kernels (the correctness contract).

``ref_matmul`` is the plain version of the blocked matmul
(``csrc/blocked_matmul.cu``), ``ref_flash_attention`` that of the flash
attention (``csrc/flash_attention.cu``).  Each computes what its kernel
computes, including the fp32 accumulation, so the CPU tests compare it with
the JAX package and ``chip_smoke.py`` compares the CUDA kernel with it on
the card.
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


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        seq_len: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,dh), k/v (B,S,K,dh) -> (B,S,H,dh); softmax in fp32.

    GQA by repeating each kv head H // K times (query head h reads kv head
    h // (H // K)); scores in fp32 divided by sqrt(dh); masked with -inf.
    ``seq_len`` masks keys at or past it, as the kernel does.  A row that
    sees no key at all is 0, as the kernel's guard makes it (the softmax of
    an all -inf row would be NaN); with every row seeing a key this is
    ``src/repro/kernels/ref.py::ref_flash_attention``.
    """
    B, S, H, dh = q.shape
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / dh ** 0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    if seq_len is not None:
        ok = ok & (kpos < seq_len)
    scores = scores.masked_fill(~ok, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = w.masked_fill(~ok.any(dim=-1)[:, None], 0.0)
    out = torch.einsum("bhqs,bshd->bqhd", w, v.float())
    return out.to(q.dtype)
