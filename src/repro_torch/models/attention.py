"""Grouped-query attention: init and full-sequence apply (train / prefill).

The port of ``src/repro/models/attention.py``'s full-sequence path: GQA
(kv heads < q heads), optional QKV bias (Qwen2), per-head QK RMS-norm
(Qwen3), RoPE, causal or bidirectional, sliding-window masks, and the
flash-attention kernel path (``cfg.use_flash``).  The reference's
``shard_hint`` calls constrain sharding under a mesh and do nothing without
one, so they are left out.  The chunked ``_blockwise_sdpa`` and the decode
functions come with later slices (ROADMAP Queue 1, item 7).

Shapes: activations (B, S, D); per-head tensors (B, S, H, dh).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (apply_rope, dense_init, init_rng, ones,
                                       rms_norm_head, zeros)
from repro_torch.models.config import ModelConfig, Params

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def init_attention(cfg: ModelConfig,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card)."""
    gen, dev = init_rng(generator, device)
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, device=dev),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, device=dev),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, device=dev),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((cfg.q_dim,), device=dev)
        p["bk"] = zeros((cfg.kv_dim,), device=dev)
        p["bv"] = zeros((cfg.kv_dim,), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = ones((cfg.dh,), device=dev)
        p["k_norm"] = ones((cfg.dh,), device=dev)
    return p


def _project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor,
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    B, S = x.shape[0], x.shape[1]
    Skv = kv_src.shape[1]
    q = x @ p["wq"].to(dt)
    k = kv_src @ p["wk"].to(dt)
    v = kv_src @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, cfg.n_heads, cfg.dh)
    k = k.reshape(B, Skv, cfg.n_kv_heads, cfg.dh)
    v = v.reshape(B, Skv, cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        q = rms_norm_head(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_head(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _mask_bias(sq: int, skv: int, causal: bool, window: int, offset: int = 0,
               device: Optional[torch.device] = None
               ) -> Optional[torch.Tensor]:
    """(sq, skv) additive fp32 mask; None if fully visible.

    ``offset`` = absolute position of query 0 minus position of key 0.
    """
    if not causal and window <= 0:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Plain dot-product attention with GQA by kv-head repetition.

    q: (B, Sq, H, dh), k/v: (B, Skv, K, dh) -> (B, Sq, H, dh).  The
    contractions and the 1/sqrt(dh) scaling run in the compute dtype, the
    softmax in fp32, and the weights are cast to ``v.dtype``, as the JAX
    package's ``_sdpa`` does.
    """
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if K != H:
        reps = H // K
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    scale = torch.sqrt(torch.tensor(float(dh))).to(q.dtype)  # 0-dim, on the CPU
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) / scale
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    kv_src: Optional[torch.Tensor] = None,
                    causal: Optional[bool] = None,
                    window: int = 0) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    dt = cfg.compute_dtype
    x = x.to(dt)
    cross = kv_src is not None
    kv_src = x if kv_src is None else kv_src.to(dt)
    causal = (cfg.causal and not cross) if causal is None else causal
    B, S = x.shape[0], x.shape[1]
    q, k, v = _project_qkv(p, x, kv_src, cfg)
    if cfg.pos_emb == "rope" and not cross:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.use_flash and not cross and q.shape[1] == k.shape[1]:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif cfg.attn_impl == "chunked" and not cross \
            and q.shape[1] == k.shape[1] and q.shape[1] > cfg.attn_block_q:
        raise NotImplementedError(
            "attn_impl='chunked' (_blockwise_sdpa) is not ported yet: "
            "ROADMAP Queue 1, item 7")
    else:
        bias = _mask_bias(q.shape[1], k.shape[1], causal, window,
                          device=x.device)
        out = _sdpa(q, k, v, bias, cfg)
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["wo"].to(dt)
