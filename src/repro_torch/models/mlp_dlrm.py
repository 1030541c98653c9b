"""The paper's case study (§III): the DLRM-style MLP tower.

A stack of fully-connected layers O_l = f(W_l I_l + b_l) with feature width
4096 (paper Fig. 4); its forward pass scores a batch of click-through
requests.  Parameters are a plain dict in the JAX package's layout:
``{"layers": [{"w": (d_in, d_out), "b": (d_out,)}, ...], "head": {...}}``,
fp32 master weights cast to ``cfg.compute_dtype`` at use.

``cfg.use_kernel_matmul`` routes the layer GEMMs through the fused
GEMM + bias + ReLU CUDA kernel (``kernels/ops.matmul``).  That kernel is
forward-only, as the JAX package's Pallas kernel is: training runs the
plain path through autograd, and ``loss_fn`` refuses the kernel path while
autograd records.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard_hint
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig, Params

Specs = Any  # a tree of mesh-axis tuples, one per param


def _dense_init(generator: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=generator.device)
    return w * (1.0 / math.sqrt(d_in))


def init_mlp(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Params:
    """N(0, 1/d_in) weights and zero biases, drawn from ``generator``.

    The numbers differ from ``jax.random``'s for any seed; a comparison with
    the JAX package hands both the same numpy arrays (``convert``).
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator()
    widths = cfg.mlp_widths
    dt = cfg.param_dtype
    layers = []
    for i, width in enumerate(widths):
        d_in = widths[i - 1] if i else widths[0]
        layers.append({"w": _dense_init(gen, d_in, width, dt).to(dev),
                       "b": torch.zeros((width,), dtype=dt, device=dev)})
    head = {"w": _dense_init(gen, widths[-1], 1, dt).to(dev),
            "b": torch.zeros((1,), dtype=dt, device=dev)}
    return {"layers": layers, "head": head}


def mlp_specs(cfg: ModelConfig) -> Specs:
    """Pure data parallelism (the paper's deployment): every weight is
    replicated, so every param's mesh axes are None."""
    layers = [{"w": (None, None), "b": (None,)} for _ in cfg.mlp_widths]
    return {"layers": layers, "head": {"w": (None, None), "b": (None,)}}


def forward(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, d_in) -> logit (B,).

    Weights *and* biases are cast to the compute dtype in every call, as the
    JAX forward does, so the bias is rounded to bf16 before the kernel adds
    it in fp32.
    """
    dt = cfg.compute_dtype
    h = shard_hint(x.to(dt), ("batch", None))
    if cfg.use_kernel_matmul:
        for lyr in params["layers"]:
            h = kops.matmul(h, lyr["w"].to(dt), bias=lyr["b"].to(dt),
                            act="relu")
    else:
        for lyr in params["layers"]:
            h = torch.relu(h @ lyr["w"].to(dt) + lyr["b"].to(dt))
    logit = h @ params["head"]["w"].to(dt) + params["head"]["b"].to(dt)
    return logit[..., 0]


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Binary cross-entropy (click-through objective of DLRM), stable form.

    Raises on the kernel path while autograd records: the CUDA kernel has
    no backward, so its layers would pass no gradient.
    """
    if cfg.use_kernel_matmul and torch.is_grad_enabled():
        raise RuntimeError(
            "use_kernel_matmul routes the layers through the forward-only "
            "blocked_matmul kernel (kernels/csrc/blocked_matmul.cu), which "
            "has no backward; train on the plain path "
            "(use_kernel_matmul=False) or score under torch.no_grad()")
    logit = forward(params, x, cfg).float()
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


# --- analytic Ridgeline terms (paper §III accounting) ---------------------------

def analytic_work_unit(batch: int, width: int, n_layers: int,
                       dtype_bytes: int = 4) -> Tuple[float, float, float]:
    """(F, B_M, B_N) per step for the paper's MLP accounting.

    F   = 6 * B * W^2 * L      (fwd + act-grad + wgt-grad GEMMs, 2BW^2 each)
    B_M = L * W^2 * dtype_bytes (weights read once per step — the paper's
          Fig. 4a convention that puts the CLX ridge crossing at batch 32)
    B_N = 2 * L * W^2 * dtype_bytes (ring all-reduce wire bytes of the grads)
    """
    F = 6.0 * batch * width * width * n_layers
    B_M = float(n_layers) * width * width * dtype_bytes
    B_N = 2.0 * float(n_layers) * width * width * dtype_bytes
    return F, B_M, B_N
