"""Decoder-only LM, dense family: the train / prefill forward.

The port of ``src/repro/models/transformer.py`` for ``family == "dense"``
(GQA attention + SwiGLU FFN, llama/qwen style).  ``forward`` returns
``(logits, aux)`` as the reference does; aux is the MoE load-balance loss,
0 for a dense model.  Parameters are nested dicts with ``blocks`` a list of
per-layer dicts, and a Python loop over it takes the place of
``lax.scan`` (``convert.lm_params_from_numpy`` unstacks the reference's
scanned layout).  With ``cfg.use_flash`` every layer's attention runs the
flash-attention CUDA kernel.

The MoE, hybrid and ssm families, rematerialisation and decode come with
later slices (ROADMAP Queue 1, items 7-9): they raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm, init_rng)
from repro_torch.models.config import ModelConfig, Params

#: where each family the port does not run yet stands in ROADMAP Queue 1
_NOT_PORTED = {"moe": "item 8 (MoE)", "hybrid": "item 9 (recurrent families)",
               "ssm": "item 9 (recurrent families)"}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        where = _NOT_PORTED.get(cfg.family, "items 7-10")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue 1, "
            f"{where}")
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (the forward has no "
            f"backward in the port): ROADMAP Queue 1, item 3")


def init_block(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    gen, dev = init_rng(generator, device)
    return {
        "attn_norm": init_norm(cfg, device=dev),
        "attn": attn_mod.init_attention(cfg, gen, dev),
        "ffn_norm": init_norm(cfg, device=dev),
        "ffn": ffn_mod.init_ffn(cfg, gen, dev),
    }


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator`` (default: a CPU generator at
    its default seed) and placed on ``device`` (None: the card, which must
    be there); blocks as a list."""
    _require_dense(cfg)
    gen, dev = init_rng(generator, device)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev)}
    p["blocks"] = [init_block(cfg, gen, dev) for _ in range(cfg.n_layers)]
    p["final_norm"] = init_norm(cfg, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, device=dev)
    if cfg.pos_emb == "learned":
        p["pos_embed"] = embed_init(gen, cfg.max_seq_len, cfg.d_model,
                                    device=dev)
    return p


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table cast to the compute dtype (the same values as the
    reference's cast of the whole table, then gather)."""
    dt = cfg.compute_dtype
    x = F.embedding(tokens, params["embed"]).to(dt)
    if cfg.pos_emb == "learned":
        S = tokens.shape[1]
        x = x + params["pos_embed"][:S].to(dt)
    return x


def _apply_dense_block(blk: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """One pre-norm block; a dense block adds nothing to aux."""
    h = apply_norm(blk["attn_norm"], x, cfg)
    x = x + attn_mod.apply_attention(blk["attn"], h, cfg,
                                     window=cfg.sliding_window)
    h = apply_norm(blk["ffn_norm"], x, cfg)
    return x + ffn_mod.apply_ffn(blk["ffn"], h, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) in compute dtype, aux fp32 0)."""
    _require_dense(cfg)
    x = _embed(params, tokens, cfg)
    for blk in params["blocks"]:
        x = _apply_dense_block(blk, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(cfg.compute_dtype)
    return logits, aux
