"""Mixture-of-Experts FFN: top-k routing with capacity-based dense dispatch.

The port of ``src/repro/models/moe.py``, keeping its GShard formulation:
the token->expert assignment is a dense one-hot dispatch tensor contracted
with ``einsum``, so the expert compute is a batched product (E, C, D) x
(E, D, F) and F and B_M count the same work unit the JAX package lowers.
The routed experts' products are plain ``torch.einsum`` (cuBLAS), as the
reference's are plain ``jnp.einsum`` outside any Pallas kernel; only the
shared experts' FFN goes through ``ffn.apply_ffn`` and so, with
``cfg.use_kernel_matmul``, through the blocked-matmul kernel.

Routing is softmax-then-top-k with renormalised gates (Qwen), plus the
load-balance auxiliary loss over all k choices.  Three places where the
reference's primitives differ from torch's, kept the reference's way:

  * top-k ties go to the lower expert index, as ``lax.top_k`` orders them
    (a stable descending sort; ``torch.topk`` promises no order);
  * a choice past its expert's capacity gets a zero row in the one-hot of
    its slot, as ``jax.nn.one_hot`` gives for an index out of range
    (``torch.nn.functional.one_hot`` raises there);
  * the combine weight is the dispatch times the sum of the token's kept
    gates, rounded to the compute dtype first, as the reference's
    ``einsum("gtec,gtk->gtec")`` computes it.

``moe_specs`` gives the logical axes of ``init_moe``'s tree.  Under a mesh
the tokens are regrouped on each device's shard (``_groups``), and the
dispatch, the experts' products and the combine are laid out here from the
groups' and the experts' placements (``_dispatch``, ``_experts``,
``_combine``), as ``sharding.sp_matmul`` lays out a dense product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import dense_init, init_rng
from repro_torch.models.config import ModelConfig, Params, Specs


def _padded_e(cfg: ModelConfig) -> int:
    return max(cfg.n_experts, cfg.pad_experts_to)


def init_moe(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card).  The router has ``n_experts`` columns; the expert weights
    have ``_padded_e`` experts, the padding ones never routed to."""
    gen, dev = init_rng(generator, device)
    E, D, Fe = _padded_e(cfg), cfg.d_model, cfg.moe_d_ff

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w * scale).to(dev)

    p = {
        "router": dense_init(gen, D, cfg.n_experts, device=dev),
        "w_gate": normal((E, D, Fe), 1.0 / math.sqrt(D)),
        "w_up": normal((E, D, Fe), 1.0 / math.sqrt(D)),
        "w_down": normal((E, Fe, D), 1.0 / math.sqrt(Fe)),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_mod.init_ffn(
            cfg, gen, dev, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def moe_specs(cfg: ModelConfig) -> Specs:
    # "experts" is EP (mesh model axis) when the count divides it; otherwise
    # the launcher maps "expert_ffn" to the model axis instead (per-expert
    # hidden TP: 60-expert qwen2-moe against a 16-wide axis).
    p = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ffn"),
        "w_up": ("experts", "embed", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_mod.ffn_specs(cfg)
    return p


def _capacity(group_tokens: int, cfg: ModelConfig) -> int:
    cap = int(group_tokens * cfg.moe_top_k * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, cfg.moe_top_k)


def gates_and_aux(probs: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The renormalised gates (T, k) of the choices ``idx`` (T, k) and the
    load-balance loss ``E * sum_e f_e * p_e``, for fp32 ``probs`` (T, E).
    The assignment fraction f_e counts all k choices, divided by k."""
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E, k = cfg.n_experts, cfg.moe_top_k
    me = probs.mean(0)                                            # (E,)
    ce = F.one_hot(idx, E).float().sum(1).mean(0) / k             # (E,)
    return gates, E * (me * ce).sum()


def route(router_logits: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (gates (T, k) fp32, expert_idx (T, k), aux fp32)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k]
    gates, aux = gates_and_aux(probs, idx, cfg)
    return gates, idx, aux


def _grouped_placements(x, Tg: int):
    """The placements under which each device's shard of the DTensor ``x``
    (B, S, D) holds whole groups of ``Tg`` consecutive tokens: x's with the
    embedding axis and any partial sum made whole, and the sequence axis
    gathered where a shard would cut a group (a mesh axis of one device
    shards nothing).  None where no layout but a whole copy does (the
    batch's shards themselves cut groups)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    place = [p if p in (Shard(0), Shard(1)) and mesh.size(i) > 1
             else Replicate() for i, p in enumerate(x.placements)]
    seq = math.prod(mesh.size(i) for i, p in enumerate(place)
                    if p == Shard(1))
    if (x.shape[1] // seq) % Tg:
        place = [Replicate() if p == Shard(1) else p for p in place]
        seq = 1
    rows = math.prod(mesh.size(i) for i, p in enumerate(place)
                     if p == Shard(0))
    if seq == 1 and (x.shape[0] // rows) * x.shape[1] % Tg:
        return None
    return tuple(place)


def _groups(x: torch.Tensor, G: int, Tg: int) -> torch.Tensor:
    """x (B, S, D) regrouped into (G, Tg, D) windows of consecutive tokens.

    A DTensor is regrouped on each device's own shard, which holds whole
    groups (``_grouped_placements``), and the groups axis is sharded over
    every mesh axis that shards the batch or the sequence: DTensor cannot
    flatten (batch, seq) while both are sharded.  The global order of the
    groups is then the devices' (a group's rank-major position), which no
    step reads: routing, capacity and dispatch are per group, the aux a
    mean over all tokens, and ``_ungroup`` puts each group back where it
    came from."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.reshape(G, Tg, x.shape[-1])
    place = _grouped_placements(x, Tg)
    if place is None:
        place = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) != place:
        x = x.redistribute(x.device_mesh, place)
    local = x.to_local()
    local = local.reshape(-1, Tg, local.shape[-1])
    grouped = tuple(Shard(0) if isinstance(p, Shard) else p for p in place)
    return DTensor.from_local(local, x.device_mesh, grouped, run_check=False,
                              shape=(G, Tg, x.shape[-1]),
                              stride=(Tg * x.shape[-1], x.shape[-1], 1))


def _ungroup(out: torch.Tensor, xt: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``_groups`` undone: ``out`` (G, Tg, D), laid out as ``xt`` was, back
    to ``x``'s (B, S, D) as ``_groups`` found it."""
    from torch.distributed.tensor import DTensor, Replicate
    B, S, D = x.shape
    if not isinstance(out, DTensor):
        return out.reshape(B, S, D)
    if tuple(out.placements) != tuple(xt.placements):
        out = out.redistribute(xt.device_mesh, xt.placements)
    place = (_grouped_placements(x, xt.shape[1])
             or (Replicate(),) * x.device_mesh.ndim)
    local = out.to_local()
    lb, ls = (B // math.prod(x.device_mesh.size(i) for i, p in
                             enumerate(place) if p.is_shard(0)),
              S // math.prod(x.device_mesh.size(i) for i, p in
                             enumerate(place) if p.is_shard(1)))
    return DTensor.from_local(local.reshape(lb, ls, D), x.device_mesh,
                              place, run_check=False, shape=(B, S, D),
                              stride=(S * D, D, 1))


def _dispatch(dispatch: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Each group's tokens into its experts' buffers: dispatch (G, Tg, E, C)
    and xt (G, Tg, D) -> (G, E, C, D).  Under a mesh both hold the same
    groups (``_groups``'s layout), so each device fills its own groups'
    buffers; a grad that comes back in another layout (a partial sum of
    ``_experts``) is made whole in this one first."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import move
    if not isinstance(xt, DTensor):
        return torch.einsum("gtec,gtd->gecd", dispatch, xt)
    place = tuple(xt.placements)
    dispatch = move(dispatch, place)
    y = torch.einsum("gtec,gtd->gecd", dispatch.to_local(grad_placements=place),
                     xt.to_local(grad_placements=place))
    return DTensor.from_local(y, xt.device_mesh, place, run_check=False)


def _expert_products(xin, wg, wu, wd):
    g = F.silu(torch.einsum("gecd,edf->gecf", xin, wg))
    u = torch.einsum("gecd,edf->gecf", xin, wu)
    return torch.einsum("gecf,efd->gecd", g * u, wd)


def _experts(xin: torch.Tensor, p: Params, dt: torch.dtype) -> torch.Tensor:
    """Each expert's SwiGLU over its buffers: xin (G, E, C, D) -> (G, E, C,
    D) in ``dt``.

    Under a mesh the products are laid out here, mesh axis by mesh axis,
    from the expert weights' placement, as ``sharding.sp_matmul`` lays out
    a dense product (DTensor's own einsum rules may shard an expert axis
    that the mesh does not divide).  Where the experts are sharded (expert
    parallelism) each device takes its experts' buffers, by an all-to-all
    from a groups axis sharded on the same mesh axis, and returns them the
    same way; where each expert's hidden axis is sharded the buffers are
    gathered whole and the output is a partial sum; against replicated
    weights the buffers keep their shards.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    wg, wu, wd = (p[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    if not isinstance(xin, DTensor):
        return _expert_products(xin, wg, wu, wd)
    came = tuple(xin.placements)
    x_to, out, gw_in, gw_out = [], [], [], []
    for px, pw in zip(came, wg.placements):
        if pw == Shard(0):                       # experts: the buffers move
            x_to.append(Shard(1))
            out.append(Shard(1))
            gw_in.append(pw)
            gw_out.append(pw)
        elif pw == Shard(2):                     # each expert's hidden axis
            x_to.append(Replicate())
            out.append(Partial())
            gw_in.append(pw)
            gw_out.append(Shard(1))
        else:
            lead = px == Shard(0)
            x_to.append(px if lead else Replicate())
            out.append(x_to[-1])
            gw_in.append(Partial() if lead else Replicate())
            gw_out.append(gw_in[-1])
    xin = move(xin, x_to)
    h = _expert_products(
        xin.to_local(grad_placements=out),
        wg.to_local(grad_placements=gw_in), wu.to_local(grad_placements=gw_in),
        wd.to_local(grad_placements=gw_out))
    h = DTensor.from_local(h, xin.device_mesh, out, run_check=False)
    back = tuple(c if (c == Shard(0) and o == Shard(1)) else o
                 for c, o in zip(came, out))
    return move(h, back)


def _combine(combine: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The experts' outputs weighted back onto their tokens: combine (G,
    Tg, E, C) and h (G, E, C, D) -> (G, Tg, D).

    Under a mesh, laid out here as ``_experts`` lays out its products: h
    first takes the groups' shards of ``combine`` (a reduce-scatter of a
    partial sum, a slice or an all-to-all), and a partial h is
    reduce-scattered on its channels; then against experts sharded on a
    mesh axis each device weighs its own experts (``combine`` sliced to
    them) and the output is a partial sum, and against h's channels each
    device forms its channels of the output.  DTensor's own einsum would
    gather h, whose E·C rows a group are k × capacity_factor times its
    tokens.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move, whole_grad
    if not isinstance(h, DTensor):
        return torch.einsum("gtec,gecd->gtd", combine, h)
    mesh = h.device_mesh
    h = move(h, tuple(
        Shard(0) if pc == Shard(0) else
        Shard(3) if ph == Partial() and h.shape[3] % mesh.size(i) == 0
        else ph
        for i, (pc, ph) in enumerate(zip(combine.placements, h.placements))))
    c_to, out, gc, gh = [], [], [], []
    for pc, ph in zip(combine.placements, h.placements):
        if ph == Shard(0):
            c_to.append(pc)
            out.append(ph)
            gc.append(ph)
            gh.append(ph)
        elif ph == Shard(1):                     # each device its experts
            c_to.append(Shard(2))
            out.append(Partial())
            gc.append(Shard(2))
            gh.append(ph)
        elif ph == Shard(3):                     # each device its channels
            c_to.append(Replicate())
            out.append(Shard(2))
            gc.append(Partial())
            gh.append(ph)
        elif ph == Partial():
            c_to.append(Replicate())
            out.append(Partial())
            gc.append(Partial())
            gh.append(Replicate())
        else:
            c_to.append(Replicate())
            out.append(Replicate())
            gc.append(Replicate())
            gh.append(Replicate())
    combine = whole_grad(move(combine, c_to))
    y = torch.einsum("gtec,gecd->gtd", combine.to_local(grad_placements=gc),
                     h.to_local(grad_placements=gh))
    return DTensor.from_local(y, mesh, out, run_check=False)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in compute dtype, aux fp32).

    The tokens are flattened and regrouped into windows of
    ``cfg.moe_group_tokens`` (one per sequence, or one in all, where that
    does not divide them); each group dispatches into per-expert buffers of
    ``_capacity`` slots, filled in the flat (token, choice) order.  A
    choice past its buffer is dropped: its expert adds nothing and the
    token keeps its residual.
    """
    dt = cfg.compute_dtype
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    Tg = min(cfg.moe_group_tokens, T)
    if T % Tg:
        Tg = S if T % S == 0 else T
    G = T // Tg
    C = _capacity(Tg, cfg)
    xt = _groups(x, G, Tg).to(dt)

    E_pad = p["w_gate"].shape[0]
    logits = torch.einsum("gtd,de->gte", xt, p["router"].to(dt))
    gates, idx, aux = route(logits.reshape(T, E), cfg)
    gates = gates.reshape(G, Tg, k)
    idx = idx.reshape(G, Tg, k)

    # each (token, choice)'s slot in its expert's buffer: a cumulative sum
    # over the group's flattened choices, in fp32 as the reference counts
    onehot = F.one_hot(idx, E_pad).float()                    # (G, Tg, k, E_pad)
    flat = onehot.reshape(G, Tg * k, E_pad)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_expert * flat).sum(-1).reshape(G, Tg, k)
    keep = (pos < C).float()
    gates = gates * keep

    # dispatch and combine (G, Tg, E_pad, C); a slot >= C matches no column
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).to(dt) * keep[..., None].to(dt)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot.to(dt), pos_oh)
    combine = torch.einsum("gtec,gtk->gtec", dispatch, gates.to(dt))

    xin = _dispatch(dispatch, xt)                             # (G, E_pad, C, D)
    h = _experts(xin, p, dt)                                  # (G, E_pad, C, D)
    out = _combine(combine, h)                                # (G, Tg, D)

    out = _ungroup(out, xt, x)
    if cfg.n_shared_experts:
        out = out + ffn_mod.apply_ffn(p["shared"], x.to(dt), cfg)
    return out, aux.float()
