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
the tokens are regrouped on each device's shard (``_group_layout``,
``_groups``), so that each group is routed once across the mesh: on one
device, or split over several, each its own run of the group's tokens
(``_route_groups``).  The dispatch, the experts' products and the combine
are laid out here from the groups' and the experts' placements
(``_dispatch``, ``_experts``, ``_combine``), as ``sharding.sp_matmul``
lays out a dense product.
"""
from __future__ import annotations

import itertools
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


def gates_and_aux(probs: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig,
                  mean=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The renormalised gates (T, k) of the choices ``idx`` (T, k) and the
    load-balance loss ``E * sum_e f_e * p_e``, for fp32 ``probs`` (T, E).
    The assignment fraction f_e counts all k choices, divided by k.
    ``mean`` takes a (T, E) tensor to its mean over the tokens: over these
    rows by default, over every device's under a mesh (``_mean_across``)."""
    mean = mean or (lambda t: t.mean(0))
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E, k = cfg.n_experts, cfg.moe_top_k
    me = mean(probs)                                              # (E,)
    ce = mean(F.one_hot(idx, E).float().sum(1)) / k               # (E,)
    return gates, E * (me * ce).sum()


def route(router_logits: torch.Tensor, cfg: ModelConfig, mean=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (gates (T, k) fp32, expert_idx (T, k), aux fp32);
    ``mean`` as ``gates_and_aux`` takes it."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k]
    gates, aux = gates_and_aux(probs, idx, cfg, mean)
    return gates, idx, aux


def _group_layout(x, Tg: int) -> Tuple[Tuple, Tuple, Optional[int]]:
    """(x's placements, the groups' placements, the exchange's mesh axis):
    the layout of the DTensor ``x`` (B, S, D) under which each device's
    shard regroups into windows of ``Tg`` consecutive tokens, and that of
    the groups (G, Tg, D) it gives, which splits the groups' work over the
    most devices.

    Each mesh axis shards the batch (nested in mesh order), the sequence,
    or nothing.  A device's shard must then hold whole groups: the groups
    axis is ``Shard(0)`` on every axis that splits the tokens (case 1);
    or a run of one group's consecutive tokens, the same share of it on
    every device: then the innermost axes split each group's tokens
    (``Shard(1)``) and the outer ones the groups (case 2, where the batch
    holds fewer groups than there are devices: decode, a short sequence);
    or, where one mesh axis splits the sequence into runs shorter than a
    group, the runs of that axis's devices together make whole groups, as
    many for each device: each device takes its groups' runs from its
    peers on that axis by one all-to-all of uneven splits (case 3,
    ``_exchange``; the two-pod train cells, whose data shards hold fewer
    rows than the model axis has devices).  Of the layouts that hold, the
    one that splits the tokens over the most devices wins, then the one
    with whole groups, then one with no exchange, then the one nearest x's
    own (the fewest moves).  The exchange's axis is None but in case 3."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    B, S = x.shape[0], x.shape[1]
    best, best_key = None, None
    for place in itertools.product((Shard(0), Shard(1), Replicate()),
                                   repeat=mesh.ndim):
        place = tuple(p if mesh.size(i) > 1 else Replicate()
                      for i, p in enumerate(place))
        rows = [i for i, p in enumerate(place) if p == Shard(0)]
        seqs = [i for i, p in enumerate(place) if p == Shard(1)]
        r = math.prod(mesh.size(i) for i in rows)
        q = math.prod(mesh.size(i) for i in seqs)
        if B % r or S % q:
            continue
        lb, ls = B // r, S // q
        swap = None
        if (ls % Tg == 0) if q > 1 else (lb * S % Tg == 0):
            grouped = tuple(Shard(0) if isinstance(p, Shard) else p
                            for p in place)
        elif Tg % (lb * ls) == 0 and (q == 1 or lb == 1):   # one run
            grouped = _split_groups(mesh, rows + seqs, Tg // (lb * ls))
        elif len(seqs) == 1 and lb * ls % Tg == 0:         # exchange
            grouped = tuple(Shard(0) if isinstance(p, Shard) else p
                            for p in place)
            swap = seqs[0]
        else:
            grouped = None
        if grouped is None:
            continue
        key = (r * q, Shard(1) not in grouped, swap is None,
               sum(a == b for a, b in zip(place, x.placements)))
        if best_key is None or key > best_key:
            best, best_key = (place, grouped, swap), key
    return best


def _split_groups(mesh, order, share: int):
    """The groups' placements where the devices along ``order`` (the mesh
    axes in the order of the token runs they hold, outermost first) hold
    runs of ``1 / share`` of a group each: the innermost axes, of ``share``
    devices together, split each group's tokens, the others the groups;
    None where no run of innermost axes makes ``share`` or either part is
    out of mesh order (DTensor nests a tensor dim's shards in mesh
    order)."""
    from torch.distributed.tensor import Replicate, Shard
    n = 1
    for cut in range(len(order), -1, -1):
        if n == share:
            outer, inner = order[:cut], order[cut:]
            if outer != sorted(outer) or inner != sorted(inner):
                return None
            return tuple(Shard(0) if i in outer else
                         Shard(1) if i in inner else Replicate()
                         for i in range(mesh.ndim))
        if cut:
            n *= mesh.size(order[cut - 1])
    return None


def _groups(x: torch.Tensor, G: int, Tg: int) -> torch.Tensor:
    """x (B, S, D) regrouped into (G, Tg, D) windows of consecutive tokens.

    A DTensor is first laid out by ``_group_layout`` (one all-to-all where
    the batch takes the sequence's mesh axis), then regrouped on each
    device's own shard, its runs first exchanged with its peers' where
    they are shorter than a group (``_exchange``).  The global order of
    the groups is then the devices' (a group's rank-major position), which
    no step reads: routing, capacity and dispatch are per group, the aux a
    mean over all tokens, and ``_ungroup`` puts each group back where it
    came from.
    Within a group split over devices (``Shard(1)``) the tokens keep their
    order, which the slots' cumulative sum reads (``_route_groups``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(G, Tg, x.shape[-1])
    from repro_torch.distributed.sharding import move
    place, grouped, swap = _group_layout(x, Tg)
    x = move(x, place)
    local = x.to_local()
    if swap is not None:
        local = _exchange(local, x.device_mesh, swap, x.shape[1])
    split = math.prod(x.device_mesh.size(i) for i, p in enumerate(grouped)
                      if p.is_shard(1))
    local = local.reshape(-1, Tg // split, local.shape[-1])
    return DTensor.from_local(local, x.device_mesh, grouped, run_check=False,
                              shape=(G, Tg, x.shape[-1]),
                              stride=(Tg * x.shape[-1], x.shape[-1], 1))


def _exchange(local: torch.Tensor, mesh, axis: int, S: int,
              back: bool = False) -> torch.Tensor:
    """Case 3 of ``_group_layout``: the runs that the devices along mesh
    ``axis`` hold of the same rows (each ``ls = S / n`` tokens of each of
    ``lb`` rows, n devices on the axis) dealt out so that device j holds
    the tokens ``[j * lb * ls, (j + 1) * lb * ls)`` of those rows
    flattened, in order: whole groups, the same tokens the reference's
    windows of the flattened rows give.

    ``local`` (lb, ls, D) -> (lb * ls, D); with ``back``, (lb * ls, D) ->
    (lb, ls, D), the inverse.  One all-to-all of uneven splits, whose
    gradient is the reverse exchange: the run of (row r, device j) goes to
    the device that holds its first token ``r * S + j * ls``.  A device's
    runs, row by row, go to devices in rank order, so its shard is sent
    as it lies; the runs it gets come peer by peer and are put in token
    order."""
    from torch.distributed import _functional_collectives as funcol
    n, me = mesh.size(axis), mesh.get_local_rank(axis)
    ls = S // n
    lb = local.shape[0] // ls if back else local.shape[0]
    held = lb * ls

    def owner(r: int, j: int) -> int:
        return (r * S + j * ls) // held

    sent = [ls * sum(owner(r, me) == d for r in range(lb)) for d in range(n)]
    came = [(r * S + j * ls, j) for j in range(n) for r in range(lb)
            if owner(r, j) == me]                    # in arrival order
    got = [ls * sum(j == k for _, j in came) for k in range(n)]
    order = sorted(range(len(came)), key=lambda i: came[i][0])
    in_order = order == sorted(order)
    D = local.shape[-1]
    if back:
        if not in_order:
            runs = local.split(ls)
            where = {i: at for at, i in enumerate(order)}
            local = torch.cat([runs[where[i]] for i in range(len(came))])
        return funcol.all_to_all_single_autograd(
            local, sent, got, (mesh, axis)).reshape(lb, ls, D)
    mine = funcol.all_to_all_single_autograd(local.reshape(held, D), got,
                                             sent, (mesh, axis))
    if in_order:
        return mine
    runs = mine.split(ls)
    return torch.cat([runs[i] for i in order])


def _ungroup(out: torch.Tensor, xt: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``_groups`` undone: ``out`` (G, Tg, D), laid out as ``xt`` was, back
    to (B, S, D) in ``x``'s layout (a partial sum made whole).  Where out
    holds channels of the tokens that xt splits on a mesh axis
    (``_combine`` after ``_dispatch``'s channel layout), the channels are
    traded back for each device's tokens (``_transpose``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    B, S, D = x.shape
    if not isinstance(out, DTensor):
        return out.reshape(B, S, D)
    mesh = x.device_mesh
    chan = [i for i, (p, q) in enumerate(zip(out.placements, xt.placements))
            if p == Shard(2) and q == Shard(1)]
    if chan:                       # channels of every token: each its own
        mid = tuple(p if i in chan else q for i, (p, q) in
                    enumerate(zip(out.placements, xt.placements)))
        local = _transpose(move(out, mid).to_local(grad_placements=mid),
                           mesh, chan, back=True)
        out = DTensor.from_local(local, mesh, xt.placements, run_check=False,
                                 shape=xt.shape, stride=xt.stride())
    elif tuple(out.placements) != tuple(xt.placements):
        out = out.redistribute(mesh, xt.placements)
    place, _, swap = _group_layout(x, xt.shape[1])
    lb = B // math.prod(mesh.size(i) for i, p in enumerate(place)
                        if p.is_shard(0))
    ls = S // math.prod(mesh.size(i) for i, p in enumerate(place)
                        if p.is_shard(1))
    local = out.to_local()
    if swap is not None:
        local = _exchange(local.reshape(-1, D), mesh, swap, S, back=True)
    out = DTensor.from_local(local.reshape(lb, ls, D), mesh, place,
                             run_check=False, shape=(B, S, D),
                             stride=(S * D, D, 1))
    return move(out, tuple(Replicate() if isinstance(p, Partial) else p
                           for p in x.placements))


def _mean_across(mesh, split: Tuple, T: int):
    """``gates_and_aux``'s mean over all ``T`` tokens, each device holding
    its own rows: the row sums all-reduced over the mesh axes that split
    the tokens (``split``: ``Partial`` there)."""
    from torch.distributed.tensor import DTensor, Replicate

    def mean(t: torch.Tensor) -> torch.Tensor:
        s = DTensor.from_local(t.sum(0), mesh, split, run_check=False)
        return s.redistribute(mesh, (Replicate(),) * mesh.ndim) / T
    return mean


def _earlier(counts: torch.Tensor, mesh, grouped: Tuple):
    """Each expert's choices in the runs of the group before this device's:
    ``counts`` (G, E_pad) this device's, gathered over the mesh axes that
    split the groups' tokens (one all-gather) and summed over the devices
    that hold earlier runs; None where no axis splits them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tok = [i for i, p in enumerate(grouped) if p.is_shard(1)]
    if not tok:
        return None
    place = tuple(Shard(0) if p.is_shard(1) else
                  Shard(1) if p.is_shard(0) else p for p in grouped)
    every = DTensor.from_local(counts[None], mesh, place, run_check=False)
    every = every.redistribute(mesh, tuple(
        Replicate() if i in tok else p for i, p in enumerate(place)))
    run = 0
    for i in tok:                      # this device's run, in mesh order
        run = run * mesh.size(i) + mesh.get_local_rank(i)
    return every.to_local()[:run].sum(0)


def _repeat_axes(mesh, grouped: Tuple) -> Tuple[Tuple[int, ...], int, int]:
    """(the mesh axes on which every device holds the same tokens of the
    groups laid out as ``grouped``, their devices n, this device's block
    among them in mesh order): decode's one group, whose runs of tokens
    the model axis does not split.  ((), 1, 0) where every axis splits."""
    rep = tuple(i for i, p in enumerate(grouped)
                if p.is_replicate() and mesh.size(i) > 1)
    n, blk = 1, 0
    for i in rep:
        n *= mesh.size(i)
        blk = blk * mesh.size(i) + mesh.get_local_rank(i)
    return rep, n, blk


def _gather_blocks(t: torch.Tensor, mesh, grouped: Tuple, rep) -> torch.Tensor:
    """The blocks of dim 2 that the devices along ``rep`` hold of a local
    ``t`` (G, Tg, e, ...) laid out as ``grouped`` elsewhere, gathered in
    mesh order on each of them; its grad, the same on each, taken back to
    the device's own block."""
    from torch.distributed.tensor import DTensor, Shard
    place = tuple(Shard(2) if i in rep else p for i, p in enumerate(grouped))
    whole = DTensor.from_local(t, mesh, place, run_check=False)
    return whole.redistribute(mesh, grouped).to_local(grad_placements=grouped)


def _whole_over(t: torch.Tensor, mesh, grouped: Tuple, rep) -> torch.Tensor:
    """``t``, the same on the devices along ``rep``, whose grad there (each
    device's partial sum, from its block of experts) is all-reduced."""
    from torch.distributed.tensor import DTensor, Partial
    part = tuple(Partial() if i in rep else p for i, p in enumerate(grouped))
    return DTensor.from_local(t, mesh, grouped, run_check=False
                              ).to_local(grad_placements=part)


def _route_groups(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
                  C: int, E_pad: int):
    """Each group's routing: (dispatch, combine) (G, Tg, E_pad, C) and the
    aux loss of xt (G, Tg, D), as the reference computes them.

    Under a mesh it runs on each device's own tokens (xt's layout from
    ``_groups``), so the router, the top-k, the one-hots and the slots are
    computed once per token across the mesh.  Where a group's tokens are
    split over devices, each (token, choice)'s slot is this device's
    exclusive cumulative sum plus the choices of the earlier runs
    (``_earlier``): the devices hold the group's tokens in order, so the
    slots and ``keep`` are exactly the reference's.  The aux's means are
    all-reduced (``_mean_across``).

    Where the devices of a mesh axis hold the same tokens (``_repeat_axes``:
    decode's one group of B tokens, which a data device's B / n_data rows
    cannot split further), each of them takes its block of the router's
    columns and of the experts, both padded to a multiple of its devices.
    Its logits are gathered (``_gather_blocks``), and the softmax, top-k
    and slots run on the gathered logits on each of them (no product: they
    count no F).  Its experts' block of the dispatch and combine comes
    back sharded on that axis (``Shard(2)``: where the experts' weights are
    split there too, ``_dispatch`` and ``_combine`` read only that block),
    or gathered and cut back where the experts were padded.  The gates'
    and xt's grads, each device's partial sum from its block, are
    all-reduced there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    E, k = cfg.n_experts, cfg.moe_top_k
    mesh, rep = None, ()
    if isinstance(xt, DTensor):
        from repro_torch.distributed.sharding import move, whole_grad
        mesh, grouped = xt.device_mesh, tuple(xt.placements)
        split = tuple(Partial() if isinstance(p, Shard) else Replicate()
                      for p in grouped)
        T = xt.shape[0] * xt.shape[1]
        rep, n, blk = _repeat_axes(mesh, grouped)
        router = move(router, (Replicate(),) * mesh.ndim).to_local(
            grad_placements=tuple(Partial() if i in rep else p
                                  for i, p in enumerate(split)))
        if rep:
            xt = whole_grad(xt).to_local(grad_placements=tuple(
                Partial() if i in rep else p for i, p in enumerate(grouped)))
        else:
            xt = xt.to_local(grad_placements=grouped)
    G, Tg, _ = xt.shape
    if rep:
        e = -(-E // n)
        cols = F.pad(router, (0, e * n - E)).narrow(1, blk * e, e)
        logits = _gather_blocks(torch.einsum("gtd,de->gte", xt, cols), mesh,
                                grouped, rep)[..., :E]
    else:
        logits = torch.einsum("gtd,de->gte", xt, router)
    if mesh is None:
        gates, idx, aux = route(logits.reshape(G * Tg, E), cfg)
    else:
        gates, idx, aux = route(logits.reshape(G * Tg, E), cfg,
                                mean=_mean_across(mesh, split, T))
    gates = gates.reshape(G, Tg, k)
    idx = idx.reshape(G, Tg, k)

    # each (token, choice)'s slot in its expert's buffer: a cumulative sum
    # over the group's flattened choices, in fp32 as the reference counts
    onehot = F.one_hot(idx, E_pad).float()                    # (G, Tg, k, E_pad)
    flat = onehot.reshape(G, Tg * k, E_pad)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    if mesh is not None:
        before = _earlier(flat.sum(1), mesh, grouped)
        if before is not None:
            pos_in_expert = pos_in_expert + before[:, None, :]
    pos = (pos_in_expert * flat).sum(-1).reshape(G, Tg, k)
    keep = (pos < C).float()
    gates = gates * keep

    # dispatch and combine (G, Tg, E_pad, C); a slot >= C matches no column
    dt = xt.dtype
    slots = torch.arange(C, device=xt.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).to(dt) * keep[..., None].to(dt)
    gates = gates.to(dt)
    if rep:                             # this device's block of the experts
        e = -(-E_pad // n)
        onehot = F.pad(onehot, (0, e * n - E_pad)).narrow(-1, blk * e, e)
        gates = _whole_over(gates, mesh, grouped, rep)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot.to(dt), pos_oh)
    combine = torch.einsum("gtec,gtk->gtec", dispatch, gates)
    if mesh is None:
        return dispatch, combine, aux
    place = grouped
    if rep and E_pad % n:               # padded blocks: gathered, cut back
        dispatch, combine = (
            _gather_blocks(t, mesh, grouped, rep)[:, :, :E_pad]
            for t in (dispatch, combine))
    elif rep:                           # each device its experts' block
        place = tuple(Shard(2) if i in rep else p
                      for i, p in enumerate(grouped))
    dispatch, combine = (DTensor.from_local(t, mesh, place, run_check=False)
                         for t in (dispatch, combine))
    return dispatch, combine, aux


def _split(pw) -> bool:
    """Whether an expert weight's placement on a mesh axis splits the
    experts (``Shard(0)``) or each expert's hidden axis (``Shard(2)``)."""
    from torch.distributed.tensor import Shard
    return pw in (Shard(0), Shard(2))


def _slot_axes(partial, w_place, C: int, mesh) -> Tuple[int, ...]:
    """The mesh axes on which ``_experts`` reduce-scatters the buffers onto
    their ``C`` slots: those where the buffers are a partial sum
    (``partial``) against weights that split nothing there, in mesh order
    while the slots divide their devices."""
    axes, split = [], 1
    for i, (part, pw) in enumerate(zip(partial, w_place)):
        if part and not _split(pw) and C % (split * mesh.size(i)) == 0:
            split *= mesh.size(i)
            axes.append(i)
    return tuple(axes)


def _channel_axes(place, w_place, C: int, D: int, mesh
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The mesh axes on which ``_dispatch`` splits the experts' buffers by
    their D channels, as (tok, rep).  ``tok``: the axes that split a
    group's tokens (``place``, the groups' layout) against weights that
    split nothing there, where the slots do not divide the devices
    (``_slot_axes``): decode's one group of 128 tokens against 10 slots,
    whose buffers would be a partial sum made whole on every device.
    ``rep``: the axes on which every device holds the same tokens against
    each expert's hidden axis split, where each would dispatch them all.
    Both empty (the buffers then take the layouts of ``_experts``) where D
    does not divide their devices, or where the shards would not nest in
    mesh order as DTensor nests them: the group's other token axes first,
    then ``tok`` (the runs they trade), then ``rep``."""
    from torch.distributed.tensor import Replicate, Shard
    slots = _slot_axes([p == Shard(1) for p in place], w_place, C, mesh)
    tok = tuple(i for i, (p, pw) in enumerate(zip(place, w_place))
                if p == Shard(1) and not _split(pw) and i not in slots)
    rep = tuple(i for i, (p, pw) in enumerate(zip(place, w_place))
                if p == Replicate() and pw == Shard(2))
    runs = tuple(i for i, p in enumerate(place)
                 if p == Shard(1) and i not in tok)
    order = runs + tok + rep
    if D % math.prod(mesh.size(i) for i in tok + rep) or \
            list(order) != sorted(order):
        return (), ()
    return tok, rep


def _transpose(local: torch.Tensor, mesh, axes, back: bool = False
               ) -> torch.Tensor:
    """Each device's run of a group's tokens, split over the mesh ``axes``
    (outermost first, nested as DTensor nests a dim's shards), traded for
    its block of the channels of all those tokens: ``local`` (G, T, D) ->
    (G, n T, D / n), n the axes' devices; with ``back``, the inverse.

    One all-to-all per axis, innermost first: each device sends a peer the
    channels that end on it, and puts the runs it gets in token order.
    The block a device ends with is its rank over the axes, outermost
    first: the channels' ``Shard(2)`` on those axes."""
    from torch.distributed import _functional_collectives as funcol
    n_all = math.prod(mesh.size(i) for i in axes)
    c = local.shape[2] if back else local.shape[2] // n_all
    steps = list(enumerate(axes))
    for m, i in (steps if back else reversed(steps)):
        n, G = mesh.size(i), local.shape[0]
        A = math.prod(mesh.size(j) for j in axes[:m])
        if back:
            T = local.shape[1] // n
            send = local.reshape(G, n, T, A, c).movedim(1, 0)
        else:
            T = local.shape[1]
            send = local.reshape(G, T, A, n, c).movedim(3, 0)
        got = funcol.all_to_all_single_autograd(send.contiguous(), None,
                                                None, (mesh, i))
        if back:
            local = got.movedim(0, 3).reshape(G, T, A * n * c)
        else:
            local = got.movedim(0, 1).reshape(G, n * T, A * c)
    return local


def _slice_then(t: torch.Tensor, place) -> torch.Tensor:
    """``t`` moved to ``place``, each axis it holds whole sliced first, so
    that a gather on another axis moves only the slice."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import move
    first = tuple(q if p == Replicate() else p
                  for p, q in zip(t.placements, place))
    return move(move(t, first), place)


def _dispatch(dispatch: torch.Tensor, xt: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Each group's tokens into its experts' buffers: dispatch (G, Tg, E, C)
    and xt (G, Tg, D) -> (G, E, C, D).  Under a mesh both hold the same
    groups (``_groups``'s layout), so each device fills its own groups'
    buffers; where a mesh axis splits a group's tokens each device fills
    them from its own tokens, and the buffers are a partial sum over that
    axis.  A grad that comes back in another layout (a partial sum of
    ``_experts``) is made whole in this one first.

    Against ``w``, an expert weight, each device fills only what its
    products read.  On a mesh axis that splits the experts while every
    device holds the same tokens, its experts' buffers (the dispatch
    sliced).  On the axes of ``_channel_axes``, its block of the D
    channels of every buffer: xt's runs of tokens traded for channels
    (``_transpose``) and the dispatch gathered, where the axis splits the
    tokens; xt's channels sliced, where it does not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    if not isinstance(xt, DTensor):
        return torch.einsum("gtec,gtd->gecd", dispatch, xt)
    mesh, place = xt.device_mesh, tuple(xt.placements)
    tok, rep = _channel_axes(place, w.placements, dispatch.shape[-1],
                             xt.shape[-1], mesh)
    ep = tuple(i for i, (p, pw) in enumerate(zip(place, w.placements))
               if p == Replicate() and pw == Shard(0))
    chan = tok + rep
    if tok:
        local = _transpose(xt.to_local(grad_placements=place), mesh, tok)
        xt = DTensor.from_local(local, mesh, tuple(
            Shard(2) if i in tok else p for i, p in enumerate(place)),
            run_check=False, shape=xt.shape, stride=xt.stride())
    xt = move(xt, tuple(Shard(2) if i in chan else p
                        for i, p in enumerate(place)))
    dispatch = _slice_then(dispatch, tuple(
        Replicate() if i in tok else Shard(2) if i in ep else p
        for i, p in enumerate(place)))
    gd = tuple(Partial() if i in chan else p
               for i, p in enumerate(dispatch.placements))
    gx = tuple(Partial() if i in ep else p for i, p in enumerate(
        xt.placements))
    y = torch.einsum("gtec,gtd->gecd", dispatch.to_local(grad_placements=gd),
                     xt.to_local(grad_placements=gx))
    return DTensor.from_local(y, mesh, tuple(
        Shard(3) if i in chan else Shard(1) if i in ep else
        Partial() if p.is_shard(1) else p for i, p in enumerate(place)),
        run_check=False)


def _expert_products(xin, wg, wu, wd):
    g = F.silu(torch.einsum("gecd,edf->gecf", xin, wg))
    u = torch.einsum("gecd,edf->gecf", xin, wu)
    return torch.einsum("gecf,efd->gecd", g * u, wd)


def _channel_products(xin, wg, wu, wd, mesh, whole, chan):
    """``_expert_products`` on each device's block of the D channels, on
    the mesh axes ``chan``, of the buffers xin (G, E, C, D / n) and of the
    weights (wg, wu (E, D / n, F), wd (E, F, D / n)): the gate and up
    products are partial sums over ``chan``, made whole by one all-reduce
    of both before the SwiGLU, and the down product writes the device's
    channels.  ``whole``: the placements of the whole products (G, E, C,
    F).  Their grads come back as partial sums over ``chan`` (each device
    reads its channels of the down product), made whole before the
    all-reduce's backward hands them to the gate and up products."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.distributed.sharding import whole_grad
    whole = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in whole)                  # the pair stacked first
    part = tuple(Partial() if i in chan else p for i, p in enumerate(whole))
    gu = torch.stack([torch.einsum("gecd,edf->gecf", xin, w)
                      for w in (wg, wu)])
    gu = whole_grad(DTensor.from_local(gu, mesh, part, run_check=False
                                       ).redistribute(mesh, whole))
    g, u = gu.to_local(grad_placements=part).unbind(0)
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, wd)


def _experts(xin: torch.Tensor, p: Params, dt: torch.dtype) -> torch.Tensor:
    """Each expert's SwiGLU over its buffers: xin (G, E, C, D) -> (G, E, C,
    D) in ``dt``.

    Under a mesh the products are laid out here, mesh axis by mesh axis,
    from the expert weights' placement, as ``sharding.sp_matmul`` lays out
    a dense product (DTensor's own einsum rules may shard an expert axis
    that the mesh does not divide).  Where the experts are sharded (expert
    parallelism) each device takes its experts' buffers, by an all-to-all
    from a groups axis sharded on the same mesh axis (a reduce-scatter
    from a partial sum), and returns them the same way; where each
    expert's hidden axis is sharded the buffers are gathered whole and the
    output is a partial sum; against replicated weights the buffers keep
    their shards, and a partial sum is reduce-scattered onto the slots
    (where they divide; made whole elsewhere).  Buffers that ``_dispatch``
    split by channels keep them against replicated weights: each device
    multiplies its channels (``_channel_products``).
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    wg, wu, wd = (p[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
    if not isinstance(xin, DTensor):
        return _expert_products(xin, wg, wu, wd)
    mesh = xin.device_mesh
    came = tuple(xin.placements)
    slots = _slot_axes([p == Partial() for p in came], wg.placements,
                       xin.shape[2], mesh)
    chan = tuple(i for i, (px, pw) in enumerate(zip(came, wg.placements))
                 if px == Shard(3) and not _split(pw))
    x_to, out, whole, gw_in, gw_out = [], [], [], [], []
    for i, (px, pw) in enumerate(zip(came, wg.placements)):
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
        elif i in chan:                          # each device its channels
            x_to.append(px)
            out.append(px)
            gw_in.append(Shard(1))
            gw_out.append(Shard(2))
        else:
            x_to.append(Shard(2) if i in slots else
                        px if px == Shard(0) else Replicate())
            out.append(x_to[-1])
            gw_in.append(Partial() if isinstance(x_to[-1], Shard)
                         else Replicate())
            gw_out.append(gw_in[-1])
        whole.append(Replicate() if i in chan else
                     Shard(3) if pw == Shard(2) else out[-1])
    xin = move(xin, x_to)
    if chan:                   # each device its channels of the weights
        wg, wu = (move(w, tuple(Shard(1) if i in chan else q
                                for i, q in enumerate(w.placements)))
                  for w in (wg, wu))
        wd = move(wd, tuple(Shard(2) if i in chan else q
                            for i, q in enumerate(wd.placements)))
    local = (xin.to_local(grad_placements=out),
             wg.to_local(grad_placements=gw_in),
             wu.to_local(grad_placements=gw_in),
             wd.to_local(grad_placements=gw_out))
    h = (_channel_products(*local, mesh, whole, chan) if chan
         else _expert_products(*local))
    h = DTensor.from_local(h, mesh, out, run_check=False)
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
    device forms its channels of the output.  Where a mesh axis splits
    each group's tokens, h is gathered whole on it (k × capacity_factor
    times the group's tokens) and each device weighs its own tokens; but
    where h holds channels there (``_dispatch``'s channel layout), the
    combine weights are gathered instead (the group's tokens × its
    experts' slots, not × D) and each device forms its channels of every
    token.  DTensor's own einsum would gather h on every axis.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move, whole_grad
    if not isinstance(h, DTensor):
        return torch.einsum("gtec,gecd->gtd", combine, h)
    mesh = h.device_mesh
    h = move(h, tuple(
        Shard(0) if pc == Shard(0) else
        ph if ph == Shard(3) else
        Replicate() if pc == Shard(1) else
        Shard(3) if ph == Partial() and h.shape[3] % mesh.size(i) == 0
        else ph
        for i, (pc, ph) in enumerate(zip(combine.placements, h.placements))))
    c_to, out, gc, gh = [], [], [], []
    for pc, ph in zip(combine.placements, h.placements):
        if ph == Shard(3):                       # each device its channels
            c_to.append(Replicate())
            out.append(Shard(2))
            gc.append(Partial())
            gh.append(ph)
        elif pc == Shard(1):                     # each device its tokens
            c_to.append(pc)
            out.append(pc)
            gc.append(pc)
            gh.append(Partial())
        elif ph == Shard(0):
            c_to.append(pc)
            out.append(ph)
            gc.append(ph)
            gh.append(ph)
        elif ph == Shard(1):                     # each device its experts
            c_to.append(Shard(2))
            out.append(Partial())
            gc.append(Shard(2))
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
    combine = whole_grad(_slice_then(combine, c_to))
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
    Tg = min(cfg.moe_group_tokens, T)
    if T % Tg:
        Tg = S if T % S == 0 else T
    G = T // Tg
    C = _capacity(Tg, cfg)
    xt = _groups(x, G, Tg).to(dt)

    E_pad = p["w_gate"].shape[0]
    dispatch, combine, aux = _route_groups(xt, p["router"].to(dt), cfg, C,
                                           E_pad)
    xin = _dispatch(dispatch, xt, p["w_gate"])                # (G, E_pad, C, D)
    h = _experts(xin, p, dt)                                  # (G, E_pad, C, D)
    out = _combine(combine, h)                                # (G, Tg, D)

    out = _ungroup(out, xt, x)
    if cfg.n_shared_experts:
        out = out + ffn_mod.apply_ffn(p["shared"], x.to(dt), cfg)
    return out, aux.float()
