"""Dense feed-forward blocks: SwiGLU (llama/qwen) and GELU MLP (whisper).

The port of ``src/repro/models/ffn.py``.  ``cfg.use_kernel_matmul`` routes
the products through ``kernels.ops.matmul`` (the blocked-matmul CUDA
kernel, with the SwiGLU gate's silu fused into it), as the JAX package's
``use_pallas_matmul`` routes them through its Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import sp_matmul
from repro_torch.kernels import ops as kops
from repro_torch.models.common import activation, dense_init, init_rng, zeros
from repro_torch.models.config import ModelConfig, Params, Specs


def init_ffn(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, d_ff: int = 0) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card)."""
    gen, dev = init_rng(generator, device)
    d_ff = d_ff or cfg.d_ff
    names = (("w_gate", "w_up") if cfg.ffn_activation == "swiglu"
             else ("w_up",))
    p = {n: dense_init(gen, cfg.d_model, d_ff, device=dev) for n in names}
    p["w_down"] = dense_init(gen, d_ff, cfg.d_model, device=dev)
    if cfg.ffn_bias:
        p["b_up"] = zeros((d_ff,), device=dev)
        p["b_down"] = zeros((cfg.d_model,), device=dev)
    return p


def ffn_specs(cfg: ModelConfig) -> Specs:
    if cfg.ffn_activation == "swiglu":
        p = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
             "w_down": ("ffn", "embed")}
    else:
        p = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if cfg.ffn_bias:
        p["b_up"] = ("ffn",)
        p["b_down"] = ("embed",)
    return p


def _kernel_mm(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """``ops.matmul`` with the bias cast to ``a.dtype``, as the kernel takes it."""
    bias = None if bias is None else bias.to(a.dtype)
    return kops.matmul(a, b, bias=bias, act=act)


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = x.to(dt)
    matmul = _kernel_mm if cfg.use_kernel_matmul else _mm
    if cfg.ffn_activation == "swiglu":
        g = matmul(x, p["w_gate"].to(dt), act="silu")
        u = matmul(x, p["w_up"].to(dt), bias=p.get("b_up"))
        h = g * u
    else:
        h = matmul(x, p["w_up"].to(dt), bias=p.get("b_up"),
                   act=cfg.ffn_activation)
    return matmul(h, p["w_down"].to(dt), bias=p.get("b_down"))


def _mm(a: torch.Tensor, b: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        act: Optional[str] = None) -> torch.Tensor:
    y = sp_matmul(a, b)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act is not None:
        y = activation(act, y)
    return y
