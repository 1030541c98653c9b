"""Chunked scalar-decay linear recurrence (SSD form): the substrate of the
recurrent families.

The port of ``src/repro/models/ssd.py``.  One primitive serves both:

  * xLSTM mLSTM blocks: matrix memory C_t = f_t C_{t-1} + i_t k_t v_t^T,
    y_t = (q_t C_t) / max(|q_t n_t|, 1) with normalizer
    n_t = f_t n_{t-1} + i_t k_t;
  * Hymba mamba heads: h_t = a_t h_{t-1} + B_t x_t, y_t = C_t h_t (the
    Mamba-2 / SSD per-head scalar decay).

Prefill runs the chunked algorithm: within a chunk of L steps the work is
dense products (attention-like scores weighted by the decay), and a loop
over the NC chunks carries the (dk x dv) state from one to the next.  The
loop takes the place of the reference's ``lax.associative_scan``: it
composes the same (a, M, n) law, chunk after chunk, so it gives the same
values within fp32 rounding.  Decode is the exact sequential update on the
constant-size state.

Shapes: inputs (B, T, H, d); the decay as ``log_decay`` (B, T, H) with
values <= 0 (the log of a forget factor in (0, 1]).  The scores and the
intra-chunk output run in the compute dtype; the decay, the chunk
summaries, the carried state and the output before its final cast in fp32,
as the reference's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device

State = Tuple[torch.Tensor, torch.Tensor]


def chunked_linear_recurrence(
    q: torch.Tensor,            # (B, T, H, dk)
    k: torch.Tensor,            # (B, T, H, dk)
    v: torch.Tensor,            # (B, T, H, dv)
    log_decay: torch.Tensor,    # (B, T, H)
    chunk: int = 256,
    normalize: bool = False,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """Return (y (B, T, H, dv) in ``v.dtype``, final (M (B, H, dk, dv),
    n (B, H, dk)) in fp32).

    Without ``normalize`` the returned n is the incoming one (zeros without
    a ``state``), as in the reference, which carries no normalizer then.
    DTensor inputs take ``_on_shards``.
    """
    if isinstance(v, DTensor) and state is None:
        return _on_shards(q, k, v, log_decay, chunk, normalize)
    B, T, H, dk = k.shape
    dv = v.shape[-1]
    L = min(chunk, T)
    while T % L:          # fall back to the largest divisor <= chunk
        L -= 1
    NC = T // L
    f32 = torch.float32
    dev = q.device

    def split(x):  # (B, T, H, d) -> (NC, B, L, H, d)
        return x.reshape(B, NC, L, *x.shape[2:]).movedim(1, 0)

    qc, kc, vc = split(q), split(k), split(v)
    la = log_decay.reshape(B, NC, L, H).movedim(1, 0).float()
    cum = torch.cumsum(la, dim=2)                    # (NC, B, L, H) inclusive
    total = cum[:, :, -1:, :]                        # (NC, B, 1, H)

    # intra-chunk: D_ij = exp(cum_i - cum_j) for j <= i, else 0; the scores
    # in the compute dtype, the decay in fp32
    idx = torch.arange(L, device=dev)
    tri = idx[:, None] >= idx[None, :]               # (L, L) j <= i
    scores = torch.einsum("nbihd,nbjhd->nbhij", qc, kc)     # (NC,B,H,L,L)
    cum_h = cum.permute(0, 1, 3, 2)                  # (NC, B, H, L)
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # (NC, B, H, L_i, L_j)
    # mask BEFORE exp: future diffs are positive and would overflow
    diff = torch.where(tri, diff, -torch.inf)
    w = scores.float() * torch.exp(diff)
    y_intra = torch.einsum("nbhij,nbjhd->nbihd", w.to(v.dtype), vc)
    d_intra = w.sum(dim=-1).permute(0, 1, 3, 2) if normalize else None

    # per-chunk summaries: M_c = sum_j exp(total - cum_j) k_j v_j^T
    kd = kc.float() * torch.exp(total - cum)[..., None]     # (NC,B,L,H,dk)
    M_c = torch.einsum("nblhd,nblhe->nbhde", kd, vc.float())  # (NC,B,H,dk,dv)
    n_c = kd.sum(dim=2) if normalize else None       # (NC, B, H, dk)

    if state is None:
        M0 = torch.zeros((B, H, dk, dv), dtype=f32, device=dev)
        n0 = torch.zeros((B, H, dk), dtype=f32, device=dev)
    else:
        M0, n0 = state

    # the state entering each chunk: M_{c+1} = a_c M_c + M_c-summary, the
    # reference's combine law (a2, M2) o (a1, M1) = (a1 a2, a2 M1 + M2)
    chunk_decay = torch.exp(total[:, :, 0, :])       # (NC, B, H)
    M_prev, n_prev = [], []
    M, n = M0, n0
    for c in range(NC):
        M_prev.append(M)
        M = chunk_decay[c][..., None, None] * M + M_c[c]
        if normalize:
            n_prev.append(n)
            n = chunk_decay[c][..., None] * n + n_c[c]
    M_prev = torch.stack(M_prev)                     # (NC, B, H, dk, dv)

    # inter-chunk contribution, batched over chunks
    qdec = qc.float() * torch.exp(cum)[..., None]    # (NC, B, L, H, dk)
    y = y_intra.float() + torch.einsum("nblhd,nbhde->nblhe", qdec, M_prev)
    if normalize:
        denom = d_intra + torch.einsum("nblhd,nbhd->nblh", qdec,
                                       torch.stack(n_prev))
        y = y / torch.clamp(denom.abs(), min=1.0)[..., None]
    y = y.movedim(0, 1).reshape(B, T, H, dv)
    return y.to(v.dtype), (M, n if normalize else n0)


def _on_shards(q, k, v, log_decay, chunk: int, normalize: bool):
    """``chunked_linear_recurrence`` of DTensors, each device running the
    plain recurrence on its own shard.

    The chunks compose in order along the sequence, so each device takes
    whole sequences: its batch rows (where a mesh axis shards the batch)
    and, on the other mesh axes, a slice of v's channels where they divide
    (the recurrence is linear in v: the scores, the decay and the
    normaliser are computed whole on each device, the rest on its slice)
    or a whole copy.  The output goes back to v's own layout (a partial sum
    made whole); the final state keeps the shards' (M sliced as v, n
    whole).  DTensor itself cannot run the chunk split: it flattens the
    (chunk, batch) axes while the sequence is sharded.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move, whole_grad
    mesh = v.device_mesh
    came = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in v.placements)
    batch = tuple(p == Shard(0) for p in q.placements)
    vp, qp, gq, split = [], [], [], 1
    for i, rows in enumerate(batch):
        if rows:
            vp.append(Shard(0))
            qp.append(Shard(0))
            gq.append(Shard(0))
        elif v.shape[3] % (split * mesh.size(i)) == 0 and mesh.size(i) > 1:
            split *= mesh.size(i)
            vp.append(Shard(3))
            qp.append(Replicate())
            gq.append(Partial())       # each channel slice's share
        else:
            vp.append(Replicate())
            qp.append(Replicate())
            gq.append(Replicate())
    vp, qp, gq = tuple(vp), tuple(qp), tuple(gq)
    local = [whole_grad(move(x, qp)).to_local(grad_placements=gq)
             for x in (q, k, log_decay)]
    vl = move(v, vp).to_local(grad_placements=vp)
    y, (M, n) = chunked_linear_recurrence(local[0], local[1], vl, local[2],
                                          chunk=chunk, normalize=normalize)
    y = DTensor.from_local(y, mesh, vp, run_check=False)
    return move(y, came), (DTensor.from_local(M, mesh, vp, run_check=False),
                           DTensor.from_local(n, mesh, qp, run_check=False))


def decode_linear_step(
    state: State,               # M (B, H, dk, dv), n (B, H, dk)
    q: torch.Tensor,            # (B, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,            # (B, H, dv)
    decay: torch.Tensor,        # (B, H) forget factor in (0, 1]
    normalize: bool = False,
) -> Tuple[torch.Tensor, State]:
    """Exact sequential update: O(1) per token on a constant-size state.
    Returns (y (B, H, dv) in ``v.dtype``, the new (M, n) in fp32); the
    state passed in is not changed.  A state laid out on a mesh steps on
    each device's own rows (``_step_on_shards``)."""
    M, n = state
    if isinstance(M, DTensor):
        return _step_on_shards(state, q, k, v, decay, normalize)
    qf, kf, vf = q.float(), k.float(), v.float()
    M = decay[..., None, None] * M + kf[..., :, None] * vf[..., None, :]
    n = decay[..., None] * n + kf
    y = torch.einsum("bhd,bhde->bhe", qf, M)
    if normalize:
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qf, n).abs(), min=1.0)
        y = y / den[..., None]
    return y.to(v.dtype), (M, n)


def _step_on_shards(state: State, q, k, v, decay, normalize: bool):
    """``decode_linear_step`` of DTensors: each (batch, head) row steps on
    its own, so every input takes the state's shards of the batch and the
    heads (one token's q, k, v and decay moved; the state stays as it
    lies where only those axes shard it) and each device steps its rows;
    the new state keeps that layout.  DTensor's own step cannot run where
    the batch and the heads are both sharded on torch 2.11: its ``einsum``
    views (batch, heads) as one dim."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import move
    M, n = state
    mesh = M.device_mesh
    rows = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                 for p in M.placements)
    y, (M, n) = decode_linear_step(
        (move(M, rows).to_local(), move(n, rows).to_local()),
        *(move(x, rows).to_local() for x in (q, k, v, decay)),
        normalize=normalize)
    y, M, n = (DTensor.from_local(t, mesh, rows, run_check=False)
               for t in (y, M, n))
    return y, (M, n)


def init_linear_state(batch: int, heads: int, dk: int, dv: int,
                      device: DeviceLike = None) -> State:
    """Zeroed fp32 (M (batch, heads, dk, dv), n (batch, heads, dk)) on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    return (torch.zeros((batch, heads, dk, dv), dtype=torch.float32,
                        device=dev),
            torch.zeros((batch, heads, dk), dtype=torch.float32, device=dev))
