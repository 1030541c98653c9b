"""Mamba-style selective-SSM heads (SSD form) for the Hymba hybrid blocks.

The port of ``src/repro/models/mamba.py``.  The heads run in the Mamba-2 /
SSD per-head scalar-decay form (``models/ssd.py``):

    h_t = a_t h_{t-1} + Δ_t B_t x_t,   y_t = C_t h_t + D ⊙ x_t
    a_t = exp(-Δ_t · exp(A_log)),      Δ_t = softplus(w_dt · u_t + b_dt)

with Δ folded into v before the recurrence.  ``n_heads`` heads of ``dh``
channels, as on the attention side, and a state of ``cfg.ssm_state`` per
head.  The projections are plain products in the compute dtype (on the
shards under a mesh, ``sharding.sp_matmul``, with the reference's
``shard_hint`` sites); Δ and the decay are fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import shard_hint, sp_matmul
from repro_torch.models.common import dense_init, init_rng, ones, zeros
from repro_torch.models.config import ModelConfig, Params, Specs
from repro_torch.models.ssd import (State, chunked_linear_recurrence,
                                    decode_linear_step, init_linear_state)


def init_mamba(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card)."""
    gen, dev = init_rng(generator, device)
    D, H, dh, N = cfg.d_model, cfg.n_heads, cfg.dh, cfg.ssm_state
    return {
        "w_v": dense_init(gen, D, H * dh, device=dev),
        "w_B": dense_init(gen, D, H * N, device=dev),
        "w_C": dense_init(gen, D, H * N, device=dev),
        "w_dt": dense_init(gen, D, H, device=dev),
        "b_dt": zeros((H,), device=dev),
        "A_log": zeros((H,), device=dev),      # a = exp(-dt * exp(A_log))
        "D_skip": ones((H, dh), device=dev),
        "w_out": dense_init(gen, H * dh, D, device=dev),
    }


def mamba_specs(cfg: ModelConfig) -> Specs:
    return {
        "w_v": ("embed", "q_proj"), "w_B": ("embed", "kv_proj"),
        "w_C": ("embed", "kv_proj"), "w_dt": ("embed", None),
        "b_dt": (None,), "A_log": (None,), "D_skip": ("heads", None),
        "w_out": ("q_proj", "embed"),
    }


def _mamba_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """(v, v_in = v·Δ, B, C, log_a) of the compute-dtype ``x`` (B, S, D)."""
    dt_ = cfg.compute_dtype
    B, S, _ = x.shape
    H, dh, N = cfg.n_heads, cfg.dh, cfg.ssm_state
    heads = ("batch", "attn_seq", "heads", None)
    v = shard_hint(sp_matmul(x, p["w_v"].to(dt_)).reshape(B, S, H, dh), heads)
    bk = shard_hint(sp_matmul(x, p["w_B"].to(dt_)).reshape(B, S, H, N), heads)
    cq = shard_hint(sp_matmul(x, p["w_C"].to(dt_)).reshape(B, S, H, N), heads)
    delta = F.softplus(sp_matmul(x, p["w_dt"].to(dt_)).float()
                       + p["b_dt"])                      # (B,S,H)
    log_a = -delta * torch.exp(p["A_log"])               # (B,S,H) <= 0
    v_in = v * delta[..., None].to(dt_)                  # fold Δ into v
    return v, v_in, bk, cq, log_a


def apply_mamba(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) in the compute dtype."""
    dt_ = cfg.compute_dtype
    x = x.to(dt_)
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.dh
    v, v_in, bk, cq, log_a = _mamba_proj(p, x, cfg)
    chunk = min(cfg.ssm_chunk, S)
    y, _ = chunked_linear_recurrence(cq, bk, v_in, log_a, chunk=chunk)
    y = y + v * p["D_skip"].to(dt_)
    return sp_matmul(y.reshape(B, S, H * dh), p["w_out"].to(dt_))


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = None) -> State:
    return init_linear_state(batch, cfg.n_heads, cfg.ssm_state, cfg.dh,
                             device=device)


def decode_mamba(p: Params, x: torch.Tensor, state: State, cfg: ModelConfig):
    """x (B, 1, D) -> (y (B, 1, D), the new (M, n))."""
    dt_ = cfg.compute_dtype
    x = x.to(dt_)
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.dh
    v, v_in, bk, cq, log_a = _mamba_proj(p, x, cfg)
    y, state = decode_linear_step(state, cq[:, 0], bk[:, 0], v_in[:, 0],
                                  torch.exp(log_a[:, 0]))
    y = y + v[:, 0] * p["D_skip"].to(dt_)
    return y.reshape(B, 1, H * dh) @ p["w_out"].to(dt_), state
