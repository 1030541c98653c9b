"""Grouped-query attention: init, full-sequence apply, single-token decode.

The port of ``src/repro/models/attention.py``: GQA (kv heads < q heads),
optional QKV bias (Qwen2), per-head QK RMS-norm (Qwen3), RoPE, causal or
bidirectional, sliding-window masks, the flash-attention kernel path
(``cfg.use_flash``), the chunked ``_blockwise_sdpa``
(``cfg.attn_impl == "chunked"``) and one-token decode against a KV cache.
The reference's ``shard_hint`` calls are kept: under a mesh binding they
lay a DTensor out (``distributed.sharding``), without one they do nothing.
Under a mesh the products run on the shards (``sharding.sp_matmul``) and
so does the attention core (``_sdpa_on_shards``; in decode, over each
device's keys: ``_sdpa_grouped_on_shards``); ``attention_specs`` and
``kv_cache_specs`` give the logical axes of the params and the cache.

Shapes: activations (B, S, D); per-head tensors (B, S, H, dh).  KV cache:
dict(k=(L, B, S_max, K, dh), v=...), one layer's view (B, S_max, K, dh).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (move, replicate_inner,
                                              shard_hint, sp_matmul)
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (apply_rope, dense_init, init_rng, ones,
                                       rms_norm_head, zeros)
from repro_torch.models.config import ModelConfig, Params, Specs

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


def attention_specs(cfg: ModelConfig) -> Specs:
    p = {
        "wq": ("embed", "q_proj"),
        "wk": ("embed", "kv_proj"),
        "wv": ("embed", "kv_proj"),
        "wo": ("q_proj", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("q_proj",)
        p["bk"] = ("kv_proj",)
        p["bv"] = ("kv_proj",)
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor,
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    B, S = x.shape[0], x.shape[1]
    Skv = kv_src.shape[1]
    q = sp_matmul(x, p["wq"].to(dt))
    k = sp_matmul(kv_src, p["wk"].to(dt))
    v = sp_matmul(kv_src, p["wv"].to(dt))
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


def _scale(dh: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(dh) in the compute dtype, as the reference divides by it."""
    return torch.sqrt(torch.tensor(float(dh))).to(dtype)   # 0-dim, on the CPU


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Plain dot-product attention with GQA by kv-head repetition.

    q: (B, Sq, H, dh), k/v: (B, Skv, K, dh) -> (B, Sq, H, dh).  The
    contractions and the 1/sqrt(dh) scaling run in the compute dtype, the
    softmax in fp32, and the weights are cast to ``v.dtype``, as the JAX
    package's ``_sdpa`` does.
    """
    if isinstance(q, DTensor):
        return _sdpa_on_shards(q, k, v, bias, cfg)
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if K != H:
        reps = H // K
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k) / _scale(dh, q.dtype)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _sdpa_on_shards(q: DTensor, k: DTensor, v: DTensor,
                    bias: Optional[torch.Tensor], cfg: ModelConfig
                    ) -> DTensor:
    """``_sdpa`` on DTensors: each device attends with its own query rows
    (its shard of the batch, of the heads and, under the ``attn_seq`` rule,
    of the sequence) over every key of its batch and heads, through the
    plain ``_sdpa`` on the shards; the output takes q's layout.  The keys
    are gathered along the sequence and sliced along the heads as q's are
    (kv heads that are replicated are first repeated up to q's).  A
    (Sq, Skv) bias is sliced to the device's query rows; a (Skv,) key bias
    holds for every row as it is.  Left to
    DTensor, the einsum flattens (batch, heads) while both are sharded,
    which some torch versions refuse and others do by replicating the
    attention or by laying the batch over every mesh axis."""
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    if K != H and not any(isinstance(p, Shard) and p.dim == 2
                          for p in k.placements):
        k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    kept = (Shard(0), Shard(2))                 # batch and heads as q's
    layout = [p if p in kept else Replicate() for p in q.placements]
    grad = [p if isinstance(p, Shard) else
            Partial() if isinstance(pq, Shard) else Replicate()
            for p, pq in zip(layout, q.placements)]
    k, v = (t.redistribute(mesh, layout).to_local(grad_placements=grad)
            for t in (k, v))
    if bias is not None and bias.ndim == 2:     # rows of q's seq shard
        bias = distribute_tensor(
            bias, mesh, [Shard(0) if p == Shard(1) else Replicate()
                         for p in q.placements], src_data_rank=None
        ).to_local()
    out = _sdpa(q.to_local(), k, v, bias, cfg)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def apply_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    kv_src: Optional[torch.Tensor] = None,
                    causal: Optional[bool] = None,
                    window: int = 0,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``key_bias`` (Skv,) is
    an additive fp32 mask on the keys (the encoder's padded frames); with
    one the attention takes the plain ``_sdpa``."""
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
    # "attn_seq" is the SP-fallback axis: mapped to the model axis only when
    # heads can't shard it (dryrun._rules_for), so head-TP archs keep
    # collective-free attention and odd-head archs still shard the O(S^2)
    # scores over seq
    q = shard_hint(q, ("batch", "attn_seq", "heads", None))
    k = shard_hint(k, ("batch", "attn_seq", "kv_heads", None))
    v = shard_hint(v, ("batch", "attn_seq", "kv_heads", None))
    plain = key_bias is not None or cross or q.shape[1] != k.shape[1]
    if cfg.use_flash and not plain:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif cfg.attn_impl == "chunked" and not plain \
            and q.shape[1] > cfg.attn_block_q:
        out = _blockwise_sdpa(q, k, v, cfg, causal, window)
    else:
        bias = _mask_bias(q.shape[1], k.shape[1], causal, window,
                          device=x.device)
        if key_bias is not None:
            bias = key_bias if bias is None else bias + key_bias
        out = _sdpa(q, k, v, bias, cfg)
    out = out.reshape(B, S, cfg.q_dim)
    return sp_matmul(out, p["wo"].to(dt))


def _blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, causal: bool,
                    window: int) -> torch.Tensor:
    """Chunked attention: a loop over q blocks of ``cfg.attn_block_q`` rows,
    each against all keys, so the (S x S) scores are never formed at once.

    The loop takes the place of the reference's ``lax.scan``; the arithmetic
    is its: kv heads repeated up to H, scores scaled in the compute dtype,
    masked with ``NEG_INF`` by absolute position, softmax in fp32.  The q
    rows padded up to a whole block are computed and sliced off.
    """
    B, S, H, dh = q.shape
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    bq = cfg.attn_block_q
    Sp = -(-S // bq) * bq
    if Sp != S:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sp - S))
    scale = _scale(dh, q.dtype)
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for i in range(Sp // bq):
        # re-assert the SP sharding of the block (a slice of the seq axis
        # would otherwise leave it as its parent's layout gives it)
        qi = shard_hint(q[:, i * bq:(i + 1) * bq],
                        ("batch", "attn_seq", "heads", None))
        s = (torch.einsum("bqhd,bshd->bhqs", qi, k) / scale).float()
        qpos = i * bq + torch.arange(bq, device=q.device)[:, None]
        ok = torch.ones((bq, S), dtype=torch.bool, device=q.device)
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok[None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", w, v))
    return torch.cat(outs, dim=1)[:, :S]


# --- decode with KV cache ----------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed k and v of (L, batch, max_len, K, dh) in the compute dtype on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def kv_cache_specs() -> Specs:
    """The stacked cache keeps its leading layer axis (it is one tensor)."""
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None)}


def decode_attention(p: Params, x: torch.Tensor,
                     layer_cache: Dict[str, torch.Tensor], pos: int,
                     cfg: ModelConfig, *, window: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: write this token's k and v at ``pos``, attend over
    the cache.

    x (B, 1, D); ``layer_cache`` k/v (B, S_max, K, dh), one layer's view of
    the stacked cache; ``pos`` an int.  **The cache is updated in place**:
    the new row is written into ``layer_cache``'s tensors (and so into the
    stacked cache they view), which are returned, so a caller that kept
    them sees them change.  The reference builds a new cache with a select
    over the whole sequence axis, a form its comment keeps for GSPMD's
    partitioning; here that would read and write the whole cache every step,
    so the row is written alone, under a mesh into the shard that holds it
    (``write_row``).  The values are the same.  Keys at ``kpos <= pos``
    (and, with a window, ``kpos > pos - window``) are visible; the rest get
    an additive fp32 ``NEG_INF`` over the whole ``S_max``, as in the
    reference.
    """
    dt = cfg.compute_dtype
    x = x.to(dt)
    B = x.shape[0]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    if cfg.pos_emb == "rope":
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
    k, v = layer_cache["k"], layer_cache["v"]
    write_row(k, k_new, pos)
    write_row(v, v_new, pos)
    bias = _decode_bias(k.shape[1], pos, window, x.device)
    out = _sdpa_grouped(q, k, v, bias, cfg)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"].to(dt)
    return out, {"k": k, "v": v}


def write_row(buf: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """``buf[:, slot] = row[:, 0]``, in place: a decode step's new k or v row
    (B, 1, K, dh) written into its cache buffer (B, S, K, dh).

    On a DTensor (a cache laid out on a mesh, its sequence axis perhaps
    sharded) the row is first laid out as the buffer's rows are: as the
    buffer on every mesh axis but those that shard the sequence, where it
    is whole (the one collective moves the row, never the buffer).  Then
    each device whose shard of the sequence holds ``slot`` writes its part
    of the row into its own shard; the others leave theirs as they are.
    DTensor's own row write, or the reference's select over the whole
    axis, can gather the buffer to write one row (torch 2.11's strategy
    for ``where`` does).  The cache is state, never differentiated, so the
    shard is written under no_grad."""
    if not isinstance(buf, DTensor):
        buf[:, slot] = row[:, 0]
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    rows = tuple(Replicate() if p.is_shard(1) else p for p in buf.placements)
    local = move(row, rows).to_local()
    shape, start = compute_local_shape_and_global_offset(
        buf.shape, buf.device_mesh, buf.placements)
    if start[1] <= slot < start[1] + shape[1]:
        with torch.no_grad():
            buf.to_local()[:, slot - start[1]] = local[:, 0]


def _decode_bias(s_max: int, pos: int, window: int,
                 device: torch.device) -> torch.Tensor:
    """(1, s_max) additive fp32 mask of the token at ``pos``: keys at
    ``kpos <= pos`` and, with a window, ``kpos > pos - window`` see 0, the
    rest ``NEG_INF``."""
    kpos = torch.arange(s_max, device=device)
    ok = kpos <= pos
    if window > 0:
        ok = ok & (kpos > pos - window)
    return torch.where(ok, 0.0, NEG_INF).float()[None, :]


def _sdpa_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], cfg: ModelConfig
                  ) -> torch.Tensor:
    """Decode-path attention in the grouped (K, G) form, no kv repetition:
    query head h reads kv head h // G.

    q (B, Sq, H, dh), k/v (B, S, K, dh) -> (B, Sq, H, dh).  Scores scaled
    in the compute dtype, softmax in fp32, weights cast to ``v.dtype``, as
    the reference's ``_sdpa_grouped``.  A cache whose sequence a mesh
    shards attends on its own shards (``_sdpa_grouped_on_shards``).
    """
    seq = _seq_dims(k, v)
    if seq:
        return _sdpa_grouped_on_shards(q, k, v, bias, seq)
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    # under a mesh the cache's sequence carries the model axis: one token's
    # q gathers its heads (DTensor cannot split sharded heads into groups)
    qg = replicate_inner(q).reshape(B, Sq, K, H // K, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / _scale(dh, q.dtype)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, dh)


def _seq_dims(k: torch.Tensor, v: torch.Tensor) -> Tuple[int, ...]:
    """The mesh dims that shard the sequence of a cache ``k``/``v`` laid out
    alike, where ``_sdpa_grouped_on_shards`` takes it: every other mesh
    dim replicates it or shards its batch or kv heads (a sharded head_dim
    would leave each device partial scores).  () for anything else, which
    keeps the plain grouped form."""
    if not isinstance(k, DTensor) or not isinstance(v, DTensor) \
            or tuple(k.placements) != tuple(v.placements) or any(
                p.is_partial() or p.is_shard() and p.dim > 2
                for p in k.placements):
        return ()
    return tuple(i for i, p in enumerate(k.placements) if p.is_shard(1))


def _sdpa_grouped_on_shards(q: DTensor, k: DTensor, v: DTensor,
                            bias: Optional[torch.Tensor],
                            seq: Tuple[int, ...]) -> DTensor:
    """``_sdpa_grouped`` where mesh dims ``seq`` shard the cache's sequence:
    each device attends with the token's query over its own keys, as the
    reference's grouped contraction keeps the scores local to the
    sequence's shards.  DTensor's softmax would gather the (B, K, G, Sq, S)
    fp32 scores whole on every device.

    q takes the cache's shards of the batch and the kv heads and is whole
    on every other mesh dim (one token's rows moved); ``bias`` (the
    caller's (1, S) mask) is sliced to the device's keys.  The softmax's
    max and sum are all-reduced over ``seq`` (two (B, H, Sq) fp32
    reductions), so a shard with no visible key weighs each of them
    exp(NEG_INF - max) = 0.  The weights, cast to ``v.dtype``, contract
    with the device's values; the output is their partial sum over
    ``seq`` (``Partial``, the layout DTensor's own contraction over the
    sharded sequence gives), and takes the cache's shards elsewhere."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = k.device_mesh
    B, Sq, H, dh = q.shape
    rows = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
                 for p in k.placements)
    ql = move(q, rows).to_local()
    kl, vl = k.to_local(), v.to_local()
    Bl, Kl = kl.shape[0], kl.shape[2]
    qg = ql.reshape(Bl, Sq, Kl, H // k.shape[2], dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kl) / _scale(dh, q.dtype)
    scores = scores.float()
    if bias is not None:
        shape, start = compute_local_shape_and_global_offset(
            k.shape, mesh, k.placements)
        scores = scores + bias[:, start[1]:start[1] + shape[1]]
    m = scores.amax(dim=-1, keepdim=True)
    for i in seq:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(scores - m)
    total = e.sum(dim=-1, keepdim=True)
    for i in seq:
        total = funcol.all_reduce(total, "sum", (mesh, i))
    w = (e / total).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, vl).reshape(Bl, Sq, -1, dh)
    return DTensor.from_local(
        out, mesh, [Partial() if i in seq else p for i, p in enumerate(rows)],
        run_check=False, shape=(B, Sq, H, dh), stride=(Sq * H * dh, H * dh,
                                                       dh, 1))
