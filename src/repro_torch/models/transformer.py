"""Decoder-only LM, dense and MoE families: the train / prefill forward and
decode.

The port of ``src/repro/models/transformer.py`` for ``family == "dense"``
(GQA attention + SwiGLU FFN, llama/qwen style) and ``family == "moe"``
(GQA attention + the top-k MoE FFN of ``models/moe.py``, shared experts
optional).  ``forward`` returns ``(logits, aux)`` as the reference does;
aux is the MoE load-balance loss summed over the layers in fp32, 0 for a
dense model.  ``decode_step`` performs one-token decode against the
KV cache ``init_cache`` builds, which it updates in place.  Parameters are
nested dicts with ``blocks`` a list of per-layer dicts, and a Python loop
over it takes the place of ``lax.scan`` (``convert.lm_params_from_numpy``
unstacks the reference's scanned layout).  With ``cfg.use_flash`` every
layer's prefill attention runs the flash-attention CUDA kernel, with
``cfg.use_kernel_matmul`` every dense FFN product (an MoE layer's shared
experts included) the blocked-matmul kernel.
``cfg.remat`` recomputes each block in the backward: ``"full"`` keeps only
the block's input, ``"dots"`` also the products' outputs.

The hybrid and ssm families come with a later slice (ROADMAP Queue 1,
item 9), enc-dec and VLM with item 10: they raise here.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm, init_rng)
from repro_torch.models.config import ModelConfig, Params

#: where each family the port does not run yet stands in ROADMAP Queue 1
_NOT_PORTED = {"hybrid": "item 9 (recurrent families)",
               "ssm": "item 9 (recurrent families)",
               "encdec": "item 10 (enc-dec and VLM)",
               "vlm": "item 10 (enc-dec and VLM)"}


#: the families this module runs
_PORTED = ("dense", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        where = _NOT_PORTED.get(cfg.family, "items 9-10")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue 1, "
            f"{where}")


def init_block(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    gen, dev = init_rng(generator, device)
    p = {
        "attn_norm": init_norm(cfg, device=dev),
        "attn": attn_mod.init_attention(cfg, gen, dev),
        "ffn_norm": init_norm(cfg, device=dev),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(cfg, gen, dev)
    else:
        p["ffn"] = ffn_mod.init_ffn(cfg, gen, dev)
    return p


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator`` (default: a CPU generator at
    its default seed) and placed on ``device`` (None: the card, which must
    be there); blocks as a list."""
    _require_ported(cfg)
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


def _apply_ffn_or_moe(blk: Params, h: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed ``h``: (out, aux fp32), aux None for a
    dense FFN (it adds nothing, and no op is spent on a zero)."""
    if "moe" in blk:
        return moe_mod.apply_moe(blk["moe"], h, cfg)
    return ffn_mod.apply_ffn(blk["ffn"], h, cfg), None


def _apply_dense_block(blk: Params, x: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-norm block -> (x, the block's aux or None)."""
    h = apply_norm(blk["attn_norm"], x, cfg)
    x = x + attn_mod.apply_attention(blk["attn"], h, cfg,
                                     window=cfg.sliding_window)
    h = apply_norm(blk["ffn_norm"], x, cfg)
    out, aux = _apply_ffn_or_moe(blk, h, cfg)
    return x + out, aux


#: the products whose outputs ``remat="dots"`` saves: the counterpart of
#: ``checkpoint_dots_with_no_batch_dims``, which would recompute the
#: attention's batched product too (the saved set changes memory, not values)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under activation checkpointing as ``cfg.remat`` asks: "full"
    saves the inputs only, "dots" the products' outputs too; "none" is
    ``fn``.  Remat changes memory, not values."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _DOTS))
    if cfg.remat == "none":
        return fn
    raise ValueError(f"remat must be none, dots or full, got {cfg.remat!r}")


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm, then the logits ``x @ head`` in the compute dtype."""
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.compute_dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) in compute dtype, aux fp32:
    the layers' load-balance losses summed, 0 for a dense model)."""
    _require_ported(cfg)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _maybe_remat(_apply_dense_block, cfg)
    for blk in params["blocks"]:
        x, a = block(blk, x, cfg)
        if a is not None:
            aux = aux + a
    return _head(params, x, cfg), aux


# --- decode ------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The KV cache of the dense and MoE families
    (``attention.init_kv_cache``) on ``device`` (None: the card)."""
    _require_ported(cfg)
    return attn_mod.init_kv_cache(cfg, batch, max_len, device=device)


def _embed_decode(params: Params, tokens: torch.Tensor, pos: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """The token rows in the compute dtype, plus the learned position row
    at ``pos``."""
    dt = cfg.compute_dtype
    x = F.embedding(tokens, params["embed"]).to(dt)
    if cfg.pos_emb == "learned":
        x = x + params["pos_embed"][pos:pos + 1].to(dt)
    return x


def decode_step(params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, 1) + cache + int pos -> (logits (B, 1, V), cache).

    Each layer writes its k and v row at ``pos`` into its view of the
    stacked cache, **in place** (``attention.decode_attention``), and the
    same dict is returned: a caller that kept the cache sees it change.
    The attention is the plain grouped contraction over the whole
    ``S_max``, as in the reference (which takes the flash kernel only when
    the query and key lengths agree, so ``use_flash`` launches nothing
    here); with ``use_kernel_matmul`` the FFN products run the
    blocked-matmul kernel.  An MoE layer dispatches the step's B tokens as
    one group (the reference's ``apply_moe`` on the (B, 1, D) batch), and
    its aux is dropped.
    """
    _require_ported(cfg)
    pos = int(pos)
    x = _embed_decode(params, tokens, pos, cfg)
    for i, blk in enumerate(params["blocks"]):
        h = apply_norm(blk["attn_norm"], x, cfg)
        a, _ = attn_mod.decode_attention(
            blk["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, pos,
            cfg, window=cfg.sliding_window)
        x = x + a
        h = apply_norm(blk["ffn_norm"], x, cfg)
        x = x + _apply_ffn_or_moe(blk, h, cfg)[0]
    return _head(params, x, cfg), cache
