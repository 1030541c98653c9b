"""Decoder-only LM over the block families: the train / prefill forward and
decode.

The port of ``src/repro/models/transformer.py`` for four families:

  dense   GQA attention + SwiGLU FFN (llama/qwen style);
  moe     GQA attention + the top-k MoE FFN of ``models/moe.py`` (shared
          experts optional);
  hybrid  Hymba: parallel attention ∥ Mamba heads and a SwiGLU FFN
          (``models/hybrid.py``), sliding-window attention but in
          ``cfg.global_attn_layers``;
  ssm     xLSTM: mLSTM blocks with sLSTM at ``cfg.slstm_layers``
          (``models/ssm.py``), no FFN of their own.

``forward`` returns ``(logits, aux)`` as the reference does; aux is the MoE
load-balance loss summed over the layers in fp32, 0 for the other families.
``decode_step`` performs one-token decode against the cache ``init_cache``
builds (the dense KV cache, Hymba's per-layer KV buffers and rings with
their Mamba states, xLSTM's per-layer recurrent states), which it updates
in place.  Parameters are nested dicts with ``blocks`` a list of per-layer
dicts, and a Python loop over it takes the place of ``lax.scan``
(``convert.lm_params_from_numpy`` unstacks the reference's scanned layout).
With ``cfg.use_flash`` every dense or MoE layer's prefill attention runs the
flash-attention CUDA kernel (Hymba's windowed attention stays the plain
``_sdpa`` with a mask bias, as in the reference), with
``cfg.use_kernel_matmul`` every dense FFN product (an MoE layer's shared
experts and a Hymba block's FFN included) the blocked-matmul kernel.
``cfg.remat`` recomputes each block in the backward: ``"full"`` keeps only
the block's input, ``"dots"`` also the products' outputs; a block's MoE aux
comes out of the checkpointed function beside its output, so its gradient
is recomputed with the block's.

The VLM family's language model is the dense decoder: ``init_lm``,
``forward``, ``init_cache`` and ``decode_step`` run it on the dense path,
as the reference's do (``models/vlm.py`` adds the visual prefix in front of
it).  The enc-dec family is not a decoder LM: its entry points are in
``models/encdec.py``, and the ones here raise ``ValueError`` for it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (shard_hint, sp_embedding,
                                              sp_matmul)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, clamped_row, dense_init,
                                       embed_init, init_norm, init_rng,
                                       norm_specs)
from repro_torch.models.config import ModelConfig, Params, Specs

#: the families this module runs (``vlm`` on the dense path)
_PORTED = ("dense", "moe", "hybrid", "ssm", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise ValueError("family 'encdec' is not a decoder LM: its forward, "
                         "cache and decode step are in models/encdec.py")
    if cfg.family not in _PORTED:
        raise ValueError(f"family {cfg.family!r} is not a decoder LM: "
                         f"{', '.join(_PORTED)}")


def init_block(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    gen, dev = init_rng(generator, device)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hymba_block(cfg, gen, dev)
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


def block_specs(cfg: ModelConfig) -> Specs:
    if cfg.family == "hybrid":
        return hybrid_mod.hymba_block_specs(cfg)
    p = {
        "attn_norm": norm_specs(cfg),
        "attn": attn_mod.attention_specs(cfg),
        "ffn_norm": norm_specs(cfg),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_specs(cfg)
    else:
        p["ffn"] = ffn_mod.ffn_specs(cfg)
    return p


def init_xlstm_block(cfg: ModelConfig, layer: int,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Params:
    """Block ``layer`` of an xLSTM: sLSTM at ``cfg.slstm_layers``, mLSTM
    elsewhere, each behind its pre-norm."""
    gen, dev = init_rng(generator, device)
    if layer in cfg.slstm_layers:
        return {"norm": init_norm(cfg, device=dev),
                "slstm": ssm_mod.init_slstm(cfg, gen, dev)}
    return {"norm": init_norm(cfg, device=dev),
            "mlstm": ssm_mod.init_mlstm(cfg, gen, dev)}


def xlstm_block_specs(cfg: ModelConfig, layer: int) -> Specs:
    if layer in cfg.slstm_layers:
        return {"norm": norm_specs(cfg), "slstm": ssm_mod.slstm_specs(cfg)}
    return {"norm": norm_specs(cfg), "mlstm": ssm_mod.mlstm_specs(cfg)}


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator`` (default: a CPU generator at
    its default seed) and placed on ``device`` (None: the card, which must
    be there); blocks as a list."""
    _require_ported(cfg)
    gen, dev = init_rng(generator, device)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev)}
    if cfg.family == "ssm":
        p["blocks"] = [init_xlstm_block(cfg, i, gen, dev)
                       for i in range(cfg.n_layers)]
    else:
        p["blocks"] = [init_block(cfg, gen, dev)
                       for _ in range(cfg.n_layers)]
    p["final_norm"] = init_norm(cfg, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, device=dev)
    if cfg.pos_emb == "learned":
        p["pos_embed"] = embed_init(gen, cfg.max_seq_len, cfg.d_model,
                                    device=dev)
    return p


def lm_specs(cfg: ModelConfig) -> Specs:
    """The specs of ``init_lm``'s tree: ``blocks`` a list of per-layer
    specs, so the reference's leading ``"layers"`` axis (always None) is
    not in them."""
    p: Dict[str, Any] = {"embed": ("vocab", "embed")}
    if cfg.family == "ssm":
        p["blocks"] = [xlstm_block_specs(cfg, i) for i in range(cfg.n_layers)]
    else:
        p["blocks"] = [block_specs(cfg) for _ in range(cfg.n_layers)]
    p["final_norm"] = norm_specs(cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = ("embed", "vocab")
    if cfg.pos_emb == "learned":
        p["pos_embed"] = (None, "embed")
    return p


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table cast to the compute dtype (the same values as the
    reference's cast of the whole table, then gather)."""
    dt = cfg.compute_dtype
    x = sp_embedding(tokens, params["embed"]).to(dt)
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
    a = attn_mod.apply_attention(blk["attn"], h, cfg,
                                 window=cfg.sliding_window)
    if cfg.sp_outputs:
        # Megatron-SP: the row-parallel sublayer output (a partial sum over
        # the model axis) goes seq-sharded before the residual add, so the
        # sync is a reduce-scatter, not an all-reduce
        a = shard_hint(a, ("batch", "seq", "embed"))
    x = shard_hint(x + a, ("batch", "seq", "embed"))
    h = apply_norm(blk["ffn_norm"], x, cfg)
    out, aux = _apply_ffn_or_moe(blk, h, cfg)
    if cfg.sp_outputs:
        out = shard_hint(out, ("batch", "seq", "embed"))
    return shard_hint(x + out, ("batch", "seq", "embed")), aux


def _apply_xlstm_block(blk: Params, x: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, None]:
    """One pre-norm xLSTM block -> (x, None: it has no aux)."""
    h = apply_norm(blk["norm"], x, cfg)
    if "slstm" in blk:
        return x + ssm_mod.apply_slstm(blk["slstm"], h, cfg), None
    return x + ssm_mod.apply_mlstm(blk["mlstm"], h, cfg), None


def _hybrid_block(window: int) -> Callable:
    """A Hymba block at its layer's attention ``window``, in the form the
    forward's layer loop calls: ``(blk, x, cfg) -> (x, None)``."""
    def block(blk: Params, x: torch.Tensor, cfg: ModelConfig):
        return hybrid_mod.apply_hymba_block(blk, x, cfg, window), None
    return block


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
    return sp_matmul(x, head.to(cfg.compute_dtype))


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) in compute dtype, aux fp32:
    the MoE layers' load-balance losses summed, 0 for the other families)."""
    _require_ported(cfg)
    x = shard_hint(_embed(params, tokens, cfg), ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        blocks = [_hybrid_block(w)
                  for w in hybrid_mod.layer_windows(cfg, tokens.shape[1])]
    else:
        fn = (_apply_xlstm_block if cfg.family == "ssm"
              else _apply_dense_block)
        blocks = [fn] * len(params["blocks"])
    for blk, fn in zip(params["blocks"], blocks, strict=True):
        x, a = _maybe_remat(fn, cfg)(blk, x, cfg)
        if cfg.family == "ssm":
            x = shard_hint(x, ("batch", "seq", "embed"))
        if a is not None:
            aux = aux + a
    return shard_hint(_head(params, x, cfg), ("batch", "seq", "vocab")), aux


# --- decode ------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """A zeroed cache on ``device`` (None: the card): the dense and MoE
    families' KV cache (``attention.init_kv_cache``); Hymba's ``layer{i}``
    KV buffers and Mamba states (``hybrid.init_hymba_cache``); xLSTM's
    ``layer{i}`` states, ``{"M", "n"}`` for an mLSTM block and
    ``{"c", "n", "h", "m"}`` for an sLSTM one (``max_len`` unused)."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        cache: Dict[str, Any] = {}
        for i in range(cfg.n_layers):
            if i in cfg.slstm_layers:
                cache[f"layer{i}"] = ssm_mod.init_slstm_state(cfg, batch,
                                                              device=device)
            else:
                M, n = ssm_mod.init_mlstm_state(cfg, batch, device=device)
                cache[f"layer{i}"] = {"M": M, "n": n}
        return cache
    if cfg.family == "hybrid":
        return hybrid_mod.init_hymba_cache(cfg, batch, max_len, device=device)
    return attn_mod.init_kv_cache(cfg, batch, max_len, device=device)


def _embed_decode(params: Params, tokens: torch.Tensor, pos: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """The token rows in the compute dtype, plus the learned position row
    at ``pos`` (the last row for a ``pos`` past the table, as the
    reference's ``dynamic_slice_in_dim`` clamps it)."""
    dt = cfg.compute_dtype
    x = sp_embedding(tokens, params["embed"]).to(dt)
    if cfg.pos_emb == "learned":
        x = x + clamped_row(params["pos_embed"], pos).to(dt)
    return x


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) + cache + int pos -> (logits (B, 1, V), cache).

    **The cache is updated in place** and the same dict is returned: a
    caller that kept it sees it change.  A dense or MoE layer writes its k
    and v row at ``pos`` into its view of the stacked cache
    (``attention.decode_attention``); the attention is the plain grouped
    contraction over the whole ``S_max``, as in the reference (which takes
    the flash kernel only when the query and key lengths agree, so
    ``use_flash`` launches nothing here).  An MoE layer dispatches the
    step's B tokens as one group (the reference's ``apply_moe`` on the
    (B, 1, D) batch), and its aux is dropped.  A Hymba layer writes its k
    and v row into its buffer or ring (``hybrid.decode_hymba_block``); an
    xLSTM or Hymba layer's recurrent state is replaced by the new one in
    its ``layer{i}`` dict.  With ``use_kernel_matmul`` the FFN products run
    the blocked-matmul kernel.
    """
    _require_ported(cfg)
    pos = int(pos)
    x = shard_hint(_embed_decode(params, tokens, pos, cfg),
                   ("batch", None, "embed"))
    if cfg.family == "ssm":
        for i, blk in enumerate(params["blocks"]):
            h = apply_norm(blk["norm"], x, cfg)
            row = cache[f"layer{i}"]
            if "slstm" in blk:
                y, st = ssm_mod.decode_slstm(blk["slstm"], h, row, cfg)
                row.update(st)
            else:
                y, (row["M"], row["n"]) = ssm_mod.decode_mlstm(
                    blk["mlstm"], h, (row["M"], row["n"]), cfg)
            x = x + y
    elif cfg.family == "hybrid":
        for i, blk in enumerate(params["blocks"]):
            x = hybrid_mod.decode_hymba_block(
                blk, x, cache[f"layer{i}"], pos, cfg,
                is_global=i in cfg.global_attn_layers)
    else:
        for i, blk in enumerate(params["blocks"]):
            h = apply_norm(blk["attn_norm"], x, cfg)
            a, _ = attn_mod.decode_attention(
                blk["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
                pos, cfg, window=cfg.sliding_window)
            x = x + a
            h = apply_norm(blk["ffn_norm"], x, cfg)
            x = x + _apply_ffn_or_moe(blk, h, cfg)[0]
    return _head(params, x, cfg), cache
