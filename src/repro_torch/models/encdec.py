"""Whisper-style encoder-decoder [arXiv:2212.04356]: init, encode, the
train / prefill forward, the cache and one-token decode.

The port of ``src/repro/models/encdec.py``.  The conv frontend is a stub
there too: ``encode`` takes precomputed frame embeddings (B, T_enc, D).
Encoder blocks are bidirectional attention + the FFN behind pre-norms, on
fixed sinusoidal positions; decoder blocks are causal self-attention,
cross-attention over the encoder's output and the FFN, on learned
positions, with the embedding tied to the LM head.  The config sets the
rest (whisper-tiny: MHA, biased projections, LayerNorm, a GELU FFN).

Parameters are nested dicts with ``enc_blocks`` and ``dec_blocks`` lists of
per-layer dicts, and a Python loop over each takes the place of
``lax.scan`` (``convert.encdec_params_from_numpy`` unstacks the
reference's scanned layout).  With ``cfg.use_flash`` every encoder layer's
attention runs the flash-attention kernel non-causal and every decoder
layer's self-attention runs it causal; cross-attention stays the plain
``_sdpa`` (the query and key lengths differ), as in the reference.  With
``cfg.use_kernel_matmul`` the FFN products run the blocked-matmul kernel,
the GELU and the bias in its epilogue.  Under a mesh the reference's
``shard_hint`` sites hold the residual stream and the logits, and the
lookup runs on the shards (``sharding.sp_embedding``) and the tied head
and the FFN's products multiply each device's own tokens by the gathered
weight (``sharding.tokens_matmul``).  Where the ``seq`` rule's mesh extent does not divide
the encoder's frames (whisper-tiny's 1,500 on a 16-wide model axis),
``_encode`` pads them with zero rows to a multiple of it, so that every
device runs the encoder and the cross-attention's K/V projections on its
own frames, and masks the padded keys (``_pad_frames``); ``encode``
hands back the real frames.

The cache is ``{"self": {"k", "v"}, "cross_k", "cross_v"}``: the decoder's
KV cache (``attention.init_kv_cache``) and every decoder layer's cross
K/V of the encoder's output, (L, B, T_enc, K, dh) in the compute dtype,
computed once by ``init_encdec_cache``.  ``decode_step`` writes its self
k and v row in place and leaves the cross K/V as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (bound_mesh, logical_spec,
                                              replicate_inner, shard_hint,
                                              sp_embedding, sp_matmul,
                                              tokens_matmul)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (apply_norm, clamped_row, embed_init,
                                       init_norm, init_rng, norm_specs,
                                       sinusoidal_positions)
from repro_torch.models.config import ModelConfig, Params, Specs


def init_encdec(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator`` (default: a CPU generator at
    its default seed) and placed on ``device`` (None: the card)."""
    gen, dev = init_rng(generator, device)

    def enc_block():
        return {"attn_norm": init_norm(cfg, device=dev),
                "attn": attn_mod.init_attention(cfg, gen, dev),
                "ffn_norm": init_norm(cfg, device=dev),
                "ffn": ffn_mod.init_ffn(cfg, gen, dev)}

    def dec_block():
        return {"self_norm": init_norm(cfg, device=dev),
                "self_attn": attn_mod.init_attention(cfg, gen, dev),
                "cross_norm": init_norm(cfg, device=dev),
                "cross_attn": attn_mod.init_attention(cfg, gen, dev),
                "ffn_norm": init_norm(cfg, device=dev),
                "ffn": ffn_mod.init_ffn(cfg, gen, dev)}

    return {
        "enc_blocks": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_norm": init_norm(cfg, device=dev),
        "dec_embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev),
        "dec_pos": embed_init(gen, cfg.max_seq_len, cfg.d_model, device=dev),
        "dec_blocks": [dec_block() for _ in range(cfg.n_layers)],
        "dec_norm": init_norm(cfg, device=dev),
    }


def encdec_specs(cfg: ModelConfig) -> Specs:
    """Per-layer lists, as ``init_encdec`` builds them (the reference's
    stacked ``"layers"`` axis stripped)."""
    enc_blk = lambda: {"attn_norm": norm_specs(cfg),
                       "attn": attn_mod.attention_specs(cfg),
                       "ffn_norm": norm_specs(cfg),
                       "ffn": ffn_mod.ffn_specs(cfg)}
    dec_blk = lambda: {"self_norm": norm_specs(cfg),
                       "self_attn": attn_mod.attention_specs(cfg),
                       "cross_norm": norm_specs(cfg),
                       "cross_attn": attn_mod.attention_specs(cfg),
                       "ffn_norm": norm_specs(cfg),
                       "ffn": ffn_mod.ffn_specs(cfg)}
    return {
        "enc_blocks": [enc_blk() for _ in range(cfg.encoder_layers)],
        "enc_norm": norm_specs(cfg),
        "dec_embed": ("vocab", "embed"), "dec_pos": (None, "embed"),
        "dec_blocks": [dec_blk() for _ in range(cfg.n_layers)],
        "dec_norm": norm_specs(cfg),
    }


#: the logical axes of the encoder's residual stream
FRAMES = ("batch", "seq", "embed")


def _seq_extent(x: torch.Tensor) -> int:
    """The number of devices over which the active binding's ``seq`` rule
    lays out the frames of ``x``: 1 outside a binding or for anything but
    a DTensor."""
    mesh = bound_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return 1
    entry = logical_spec(FRAMES)[1]
    names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in names)


def _pad_frames(x: DTensor, T_p: int) -> Tuple[DTensor, torch.Tensor]:
    """x (B, T, D) with zero rows appended up to (B, T_p, D), and the
    (T_p,) fp32 key bias that gives the padded frames ``NEG_INF``.

    Each device pads its own shard (the frames' axis made whole first), so
    nothing is sent.  A zero row stays finite through the encoder (a
    LayerNorm of zeros is its bias); as a key it weighs exp(NEG_INF - max)
    = 0 in every real row's softmax, so the real rows read what they read
    unpadded, and its own output is never read, so its grad is 0."""
    x = replicate_inner(x)
    B, T, D = x.shape
    local = F.pad(x.to_local(grad_placements=x.placements),
                  (0, 0, 0, T_p - T))
    x = DTensor.from_local(local, x.device_mesh, x.placements,
                           run_check=False, shape=(B, T_p, D),
                           stride=(T_p * D, D, 1))
    keep = torch.arange(T_p, device=local.device) < T
    return x, torch.where(keep, 0.0, attn_mod.NEG_INF).float()


def _unpad(x: torch.Tensor, T: int) -> torch.Tensor:
    """The first ``T`` frames of x (B, T_p, ...), gathered along the
    frames where a mesh shards them."""
    if x.shape[1] == T:
        return x
    return replicate_inner(x)[:, :T]


def _encode(params: Params, frames: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """frames (B, T_enc, D) -> (encoder states (B, T_p, D) in the compute
    dtype, their (T_p,) key bias or None).

    T_p is T_enc, except under a binding whose ``seq`` rule lays DTensor
    frames over n devices that do not divide T_enc: there it is T_enc
    rounded up to a multiple of n (``_pad_frames``), the frames are
    sharded over those devices, and every per-token op runs on each
    device's own frames.  The attention, whose keys are gathered, masks
    the padded ones with the bias."""
    dt = cfg.compute_dtype
    T = frames.shape[1]
    x = frames.to(dt) + sinusoidal_positions(
        T, cfg.d_model, device=frames.device).to(dt)
    n = _seq_extent(x)
    bias = None
    if T % n:
        x, bias = _pad_frames(x, -(-T // n) * n)
    x = shard_hint(x, FRAMES)
    for blk in params["enc_blocks"]:
        h = apply_norm(blk["attn_norm"], x, cfg)
        x = x + attn_mod.apply_attention(blk["attn"], h, cfg, causal=False,
                                         key_bias=bias)
        h = apply_norm(blk["ffn_norm"], x, cfg)
        x = x + ffn_mod.apply_ffn(blk["ffn"], h, cfg)
        x = shard_hint(x, FRAMES)
    return apply_norm(params["enc_norm"], x, cfg), bias


def encode(params: Params, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings -> encoder states (B, T_enc, D)
    in the compute dtype."""
    return _unpad(_encode(params, frames, cfg)[0], frames.shape[1])


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's final norm, then the tied head in the compute dtype
    (``sharding.tokens_matmul``, as ``transformer._head``)."""
    x = apply_norm(params["dec_norm"], x, cfg)
    return tokens_matmul(x, params["dec_embed"].T.to(cfg.compute_dtype))


def forward(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, S) int, frames (B, T_enc, D)) -> (logits (B, S, V) in the
    compute dtype, aux: an fp32 zero)."""
    dt = cfg.compute_dtype
    enc, enc_bias = _encode(params, frames, cfg)
    S = tokens.shape[1]
    x = sp_embedding(tokens, params["dec_embed"]).to(dt)
    x = shard_hint(x + params["dec_pos"][:S].to(dt), ("batch", "seq", "embed"))
    for blk in params["dec_blocks"]:
        h = apply_norm(blk["self_norm"], x, cfg)
        x = x + attn_mod.apply_attention(blk["self_attn"], h, cfg,
                                         causal=True)
        h = apply_norm(blk["cross_norm"], x, cfg)
        x = x + attn_mod.apply_attention(blk["cross_attn"], h, cfg,
                                         kv_src=enc, causal=False,
                                         key_bias=enc_bias)
        h = apply_norm(blk["ffn_norm"], x, cfg)
        x = x + ffn_mod.apply_ffn(blk["ffn"], h, cfg)
        x = shard_hint(x, ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard_hint(_logits(params, x, cfg), ("batch", "seq", "vocab")), aux


# --- decode ------------------------------------------------------------------

def init_encdec_cache(params: Params, frames: torch.Tensor, batch: int,
                      max_len: int, cfg: ModelConfig) -> Dict[str, Any]:
    """Prefill: run the encoder once and compute every decoder layer's cross
    K/V of its output (the ``bk``/``bv`` biases with ``cfg.qkv_bias``),
    stacked to (L, batch, T_enc, K, dh); a zeroed self KV cache of
    ``max_len`` beside them, on the frames' device.  Under a mesh each
    device projects its own frames (``_encode``) and the K/V are gathered
    along the frames."""
    dt = cfg.compute_dtype
    enc, _ = _encode(params, frames, cfg)
    Tk = frames.shape[1]
    ks, vs = [], []
    for blk in params["dec_blocks"]:
        p = blk["cross_attn"]
        k = sp_matmul(enc, p["wk"].to(dt))
        v = sp_matmul(enc, p["wv"].to(dt))
        if cfg.qkv_bias:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        ks.append(_unpad(k, Tk).reshape(batch, Tk, cfg.n_kv_heads, cfg.dh))
        vs.append(_unpad(v, Tk).reshape(batch, Tk, cfg.n_kv_heads, cfg.dh))
    return {"self": attn_mod.init_kv_cache(cfg, batch, max_len,
                                           device=enc.device),
            "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) + cache + int pos -> (logits (B, 1, V), cache).

    **The cache is updated in place** and the same dict is returned: each
    layer writes its self k and v row at ``pos`` (``attention.
    decode_attention``); ``cross_k``/``cross_v`` stay as they were.  The
    learned position row is read at ``min(pos, max_seq_len - 1)``, the
    clamp of the reference's ``dynamic_slice_in_dim``.  Cross-attention is
    the grouped contraction of the query over every frame's cached K/V,
    unmasked (the k and v the projection also makes are dropped, as in the
    reference).  With ``use_kernel_matmul`` the FFN products run the
    blocked-matmul kernel.
    """
    dt = cfg.compute_dtype
    pos = int(pos)
    B = tokens.shape[0]
    x = F.embedding(tokens, params["dec_embed"]).to(dt)
    x = x + clamped_row(params["dec_pos"], pos).to(dt)
    self_kv = cache["self"]
    for i, blk in enumerate(params["dec_blocks"]):
        h = apply_norm(blk["self_norm"], x, cfg)
        a, _ = attn_mod.decode_attention(
            blk["self_attn"], h, {"k": self_kv["k"][i], "v": self_kv["v"][i]},
            pos, cfg)
        x = x + a
        h = apply_norm(blk["cross_norm"], x, cfg)
        q, _, _ = attn_mod._project_qkv(blk["cross_attn"], h, h, cfg)
        out = attn_mod._sdpa_grouped(q, cache["cross_k"][i],
                                     cache["cross_v"][i], None, cfg)
        x = x + out.reshape(B, 1, cfg.q_dim) @ blk["cross_attn"]["wo"].to(dt)
        h = apply_norm(blk["ffn_norm"], x, cfg)
        x = x + ffn_mod.apply_ffn(blk["ffn"], h, cfg)
    return _logits(params, x, cfg), cache
