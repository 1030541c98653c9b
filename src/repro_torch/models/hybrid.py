"""Hymba hybrid blocks [arXiv:2411.13676]: parallel attention ∥ Mamba heads.

The port of ``src/repro/models/hybrid.py``.  Each block: x -> pre-norm ->
{GQA attention, Mamba heads} on the same input, each branch's output
RMS-normed and scaled by its learnable per-channel β, the two averaged
(the paper's fusion), then the SwiGLU FFN sub-block (the blocked-matmul
kernel with ``cfg.use_kernel_matmul``).

Attention is sliding-window (``cfg.sliding_window``) in every layer but
``cfg.global_attn_layers``.  The reference carries each layer's window
through its layer scan as data; here it is a plain int per layer
(``layer_windows``), the global layers' equal to the sequence length.  The
prefill attention is the plain ``_sdpa`` with a mask bias, as in the
reference (never the flash kernel).  Under a mesh q, k and v take the
reference's ``shard_hint`` placements and the products run on the shards
(``sharding.sp_matmul``).

Decode keeps a full-length KV buffer for the global layers only; a local
layer holds a ring of ``min(window, max_len)`` slots, the token at ``pos``
written at slot ``pos % W`` in place, and keys masked by the age of their
slot.  Each layer's Mamba state is the SSD (M, n).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard_hint, sp_matmul
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import (NEG_INF, _project_qkv, _sdpa,
                                          _sdpa_grouped)
from repro_torch.models.common import (apply_norm, apply_rope, init_norm,
                                       init_rng, norm_specs, ones)
from repro_torch.models.config import ModelConfig, Params, Specs


def init_hymba_block(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card)."""
    gen, dev = init_rng(generator, device)
    return {
        "pre_norm": init_norm(cfg, device=dev),
        "attn": attn_mod.init_attention(cfg, gen, dev),
        "mamba": mamba_mod.init_mamba(cfg, gen, dev),
        "attn_out_norm": init_norm(cfg, device=dev),
        "mamba_out_norm": init_norm(cfg, device=dev),
        "beta_attn": ones((cfg.d_model,), device=dev),
        "beta_mamba": ones((cfg.d_model,), device=dev),
        "ffn_norm": init_norm(cfg, device=dev),
        "ffn": ffn_mod.init_ffn(cfg, gen, dev),
    }


def hymba_block_specs(cfg: ModelConfig) -> Specs:
    return {
        "pre_norm": norm_specs(cfg),
        "attn": attn_mod.attention_specs(cfg),
        "mamba": mamba_mod.mamba_specs(cfg),
        "attn_out_norm": norm_specs(cfg),
        "mamba_out_norm": norm_specs(cfg),
        "beta_attn": ("embed",),
        "beta_mamba": ("embed",),
        "ffn_norm": norm_specs(cfg),
        "ffn": ffn_mod.ffn_specs(cfg),
    }


def _windowed_attention(p: Params, h: torch.Tensor, cfg: ModelConfig,
                        window: int) -> torch.Tensor:
    """Full-sequence causal attention over the last ``window`` keys."""
    dt = cfg.compute_dtype
    B, S, _ = h.shape
    q, k, v = _project_qkv(p, h, h, cfg)
    if cfg.pos_emb == "rope":
        pos = torch.arange(S, device=h.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = shard_hint(q, ("batch", "attn_seq", "heads", None))
    k = shard_hint(k, ("batch", "attn_seq", "kv_heads", None))
    v = shard_hint(v, ("batch", "attn_seq", "kv_heads", None))
    qpos = torch.arange(S, device=h.device)[:, None]
    kpos = torch.arange(S, device=h.device)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - window)
    out = _sdpa(q, k, v, torch.where(ok, 0.0, NEG_INF).float(), cfg)
    return sp_matmul(out.reshape(B, S, cfg.q_dim), p["wo"].to(dt))


def _fuse(p: Params, a: torch.Tensor, m: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """0.5 · (norm(a)·β_attn + norm(m)·β_mamba), in the compute dtype."""
    dt = cfg.compute_dtype
    return 0.5 * (apply_norm(p["attn_out_norm"], a, cfg) * p["beta_attn"].to(dt)
                  + apply_norm(p["mamba_out_norm"], m, cfg)
                  * p["beta_mamba"].to(dt))


def apply_hymba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      window: int) -> torch.Tensor:
    h = apply_norm(p["pre_norm"], x, cfg)
    a = _windowed_attention(p["attn"], h, cfg, window)
    m = mamba_mod.apply_mamba(p["mamba"], h, cfg)
    x = x + _fuse(p, a, m, cfg)
    return x + ffn_mod.apply_ffn(p["ffn"], apply_norm(p["ffn_norm"], x, cfg),
                                 cfg)


def layer_windows(cfg: ModelConfig, seq_len: int) -> List[int]:
    """Each layer's attention window: ``seq_len`` (sees everything) for the
    global layers, ``cfg.sliding_window`` for the rest."""
    return [seq_len if i in cfg.global_attn_layers else cfg.sliding_window
            for i in range(cfg.n_layers)]


# --- decode ------------------------------------------------------------------

def init_hymba_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: DeviceLike = None) -> Dict:
    """``layer{i}``: k and v of (batch, S_i, K, dh) in the compute dtype,
    S_i = ``max_len`` for a global layer and ``min(window, max_len)`` for a
    local one, and the Mamba state ``mM``, ``mn`` (fp32), all zeros on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    W = min(cfg.sliding_window, max_len)
    dt = cfg.compute_dtype
    cache: Dict = {}
    for i in range(cfg.n_layers):
        S = max_len if i in cfg.global_attn_layers else W
        shape = (batch, S, cfg.n_kv_heads, cfg.dh)
        M, n = mamba_mod.init_mamba_state(cfg, batch, device=dev)
        cache[f"layer{i}"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "mM": M, "mn": n,
        }
    return cache


def _decode_slot_bias(S: int, pos: int, is_global: bool,
                      device: torch.device) -> Tuple[int, torch.Tensor]:
    """The slot the token at ``pos`` takes in a buffer of ``S`` rows and the
    (1, S) additive fp32 mask of the keys it sees: a global layer writes at
    ``pos`` and sees rows ``<= pos``; a local layer's ring writes at
    ``pos % S`` and sees the slots whose age ``(slot - row) % S`` is at most
    ``min(pos, S - 1)``."""
    rows = torch.arange(S, device=device)
    if is_global:
        slot = pos
        ok = rows <= pos
    else:
        slot = pos % S
        ok = torch.remainder(slot - rows, S) <= min(pos, S - 1)
    return slot, torch.where(ok, 0.0, NEG_INF).float()[None, :]


def decode_hymba_block(p: Params, x: torch.Tensor, cache_row: Dict, pos: int,
                       cfg: ModelConfig, is_global: bool) -> torch.Tensor:
    """One-token decode for one layer.  x (B, 1, D) -> x (B, 1, D).

    **The cache row is updated in place**: the new k and v row is written
    into its buffers at the token's slot (the reference selects over the
    whole buffer; the values are the same), and ``mM``, ``mn`` are replaced
    by the new Mamba state.
    """
    dt = cfg.compute_dtype
    B = x.shape[0]
    h = apply_norm(p["pre_norm"], x, cfg)

    q, k_new, v_new = _project_qkv(p["attn"], h, h, cfg)
    if cfg.pos_emb == "rope":
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
    k, v = cache_row["k"], cache_row["v"]
    slot, bias = _decode_slot_bias(k.shape[1], pos, is_global, x.device)
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    a = _sdpa_grouped(q, k, v, bias, cfg)
    a = a.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(dt)

    m, (M, n) = mamba_mod.decode_mamba(
        p["mamba"], h, (cache_row["mM"], cache_row["mn"]), cfg)
    cache_row["mM"], cache_row["mn"] = M, n
    x = x + _fuse(p, a, m, cfg)
    return x + ffn_mod.apply_ffn(p["ffn"], apply_norm(p["ffn_norm"], x, cfg),
                                 cfg)
