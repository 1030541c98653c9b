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

Under a mesh the chunk boundaries stay the one process's.  Where one mesh
dim shards the sequence (or holds the inputs as partial sums, as the
mLSTM's projections leave them) and each device's run of T / n tokens is
whole chunks, each device runs its own chunks once from a zero state, and
only the runs' summaries (a, M, n) cross the sequence's devices: a doubling
scan composes the ones before each device by the reference's combine law
into the state entering its run, which each chunk then takes scaled by its
run's earlier decay (``_on_sequence_shards``).  Any other mesh call runs
whole sequences on each device (``_on_shards``).

Shapes: inputs (B, T, H, d); the decay as ``log_decay`` (B, T, H) with
values <= 0 (the log of a forget factor in (0, 1]).  The scores and the
intra-chunk output run in the compute dtype; the decay, the chunk
summaries, the carried state and the output before its final cast in fp32,
as the reference's do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    DTensor inputs take ``_on_sequence_shards`` where a mesh dim holds
    each device's own run of whole chunks (``_sequence_dim``), else
    ``_on_shards``.
    """
    if isinstance(v, DTensor) and state is None:
        seq = _sequence_dim(q, k, v, log_decay, chunk)
        if seq is not None:
            return _on_sequence_shards(q, k, v, log_decay, chunk, normalize,
                                       seq)
        return _on_shards(q, k, v, log_decay, chunk, normalize)
    B, T, H, dk = k.shape
    dv = v.shape[-1]
    f32 = torch.float32
    ch = _local_pass(q, k, v, log_decay, _chunk_len(T, chunk), normalize)
    if state is None:
        M0 = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n0 = torch.zeros((B, H, dk), dtype=f32, device=q.device)
    else:
        M0, n0 = state
    M_prev, n_prev, M, n = _compose(ch, M0, n0, normalize)
    y = _finish(ch, M_prev, n_prev, normalize, v.dtype)
    return y, (M, n if normalize else n0)


def _chunk_len(T: int, chunk: int) -> int:
    """The chunk length L: the largest divisor of T that is <= ``chunk``."""
    L = min(chunk, T)
    while T % L:
        L -= 1
    return L


class _Chunks(NamedTuple):
    """What ``_local_pass`` gives for NC chunks of L: each chunk's own
    work, from a zero state."""
    qc: torch.Tensor        # (NC, B, L, H, dk) q split into chunks
    cum: torch.Tensor       # (NC, B, L, H) fp32 inclusive log-decay sums
    y_intra: torch.Tensor   # (NC, B, L, H, dv) in v's dtype
    d_intra: Optional[torch.Tensor]   # (NC, B, L, H) fp32, with normalize
    M_c: torch.Tensor       # (NC, B, H, dk, dv) fp32 chunk summaries
    n_c: Optional[torch.Tensor]       # (NC, B, H, dk) fp32, with normalize
    decay: torch.Tensor     # (NC, B, H) fp32 each chunk's whole decay


def _local_pass(q, k, v, log_decay, L: int, normalize: bool) -> _Chunks:
    """The intra-chunk output and the summaries of the chunks of L that
    (B, T, H, d) inputs hold, T a multiple of L."""
    B, T, H, _ = k.shape
    NC = T // L

    def split(x):  # (B, T, H, d) -> (NC, B, L, H, d)
        return x.reshape(B, NC, L, *x.shape[2:]).movedim(1, 0)

    qc, kc, vc = split(q), split(k), split(v)
    la = log_decay.reshape(B, NC, L, H).movedim(1, 0).float()
    cum = torch.cumsum(la, dim=2)                    # (NC, B, L, H) inclusive
    total = cum[:, :, -1:, :]                        # (NC, B, 1, H)

    # intra-chunk: D_ij = exp(cum_i - cum_j) for j <= i, else 0; the scores
    # in the compute dtype, the decay in fp32
    idx = torch.arange(L, device=q.device)
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
    return _Chunks(qc, cum, y_intra, d_intra, M_c, n_c,
                   torch.exp(total[:, :, 0, :]))


def _compose(ch: _Chunks, M, n, normalize: bool):
    """(the state entering each chunk, stacked (NC, ...), n's or None, and
    the state after the last) from (M, n) entering the first: M_{c+1} =
    a_c M_c + M_c-summary, the reference's combine law (a2, M2) o (a1, M1)
    = (a1 a2, a2 M1 + M2)."""
    M_prev, n_prev = [], []
    for c in range(ch.decay.shape[0]):
        M_prev.append(M)
        M = ch.decay[c][..., None, None] * M + ch.M_c[c]
        if normalize:
            n_prev.append(n)
            n = ch.decay[c][..., None] * n + ch.n_c[c]
    return (torch.stack(M_prev), torch.stack(n_prev) if normalize else None,
            M, n)


def _finish(ch: _Chunks, M_prev, n_prev, normalize: bool, dtype):
    """y (B, T, H, dv) in ``dtype``: each chunk's own output plus its
    incoming state's, batched over chunks, divided by max(|denominator|, 1)
    with ``normalize``."""
    qdec = ch.qc.float() * torch.exp(ch.cum)[..., None]    # (NC,B,L,H,dk)
    y = ch.y_intra.float() + torch.einsum("nblhd,nbhde->nblhe", qdec, M_prev)
    if normalize:
        denom = ch.d_intra + torch.einsum("nblhd,nbhd->nblh", qdec, n_prev)
        y = y / torch.clamp(denom.abs(), min=1.0)[..., None]
    NC, B, L, H, dv = y.shape
    return y.movedim(0, 1).reshape(B, NC * L, H, dv).to(dtype)


def _placements(q, v, seq: Optional[int] = None):
    """Per mesh dim, the layouts the recurrence runs in: (v's, q's, k's
    and the decay's, and the grad placement of those three).  A mesh dim
    that shards q's batch keeps its rows; ``seq`` shards the sequence; on
    the others v's channels are sliced where they divide (the recurrence
    is linear in v: the scores, the decay and the normaliser are computed
    whole on each device, the rest on its slice; q's grad is each slice's
    share) or each device takes a whole copy."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = v.device_mesh
    vp, qp, gq, split = [], [], [], 1
    for i, p in enumerate(q.placements):
        if p == Shard(0) or i == seq:
            shard = Shard(1) if i == seq else Shard(0)
            vp.append(shard)
            qp.append(shard)
            gq.append(shard)
        elif v.shape[3] % (split * mesh.size(i)) == 0 and mesh.size(i) > 1:
            split *= mesh.size(i)
            vp.append(Shard(3))
            qp.append(Replicate())
            gq.append(Partial())
        else:
            vp.append(Replicate())
            qp.append(Replicate())
            gq.append(Replicate())
    return tuple(vp), tuple(qp), tuple(gq)


def _on_shards(q, k, v, log_decay, chunk: int, normalize: bool):
    """``chunked_linear_recurrence`` of DTensors, each device running the
    plain recurrence on its own shard of whole sequences: its batch rows
    (where a mesh axis shards the batch) and, on the other mesh axes, a
    slice of v's channels or a whole copy (``_placements``).  The output
    goes back to v's own layout (a partial sum made whole); the final
    state keeps the shards' (M sliced as v, n whole).  DTensor itself
    cannot run the chunk split: it flattens the (chunk, batch) axes while
    the sequence is sharded.
    """
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.distributed.sharding import move
    mesh = v.device_mesh
    came = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in v.placements)
    vp, qp, gq = _placements(q, v)
    ql, kl, ll, vl = _to_local(q, k, log_decay, v, vp, qp, gq)
    y, (M, n) = chunked_linear_recurrence(ql, kl, vl, ll, chunk=chunk,
                                          normalize=normalize)
    y = DTensor.from_local(y, mesh, vp, run_check=False)
    return move(y, came), (DTensor.from_local(M, mesh, vp, run_check=False),
                           DTensor.from_local(n, mesh, qp, run_check=False))


def _to_local(q, k, log_decay, v, vp, qp, gq):
    """The local shards of q, k and the decay laid out as ``qp`` (their
    grads handed back as ``gq``, made whole before they reach the ops that
    made them) and of v laid out as ``vp``."""
    from repro_torch.distributed.sharding import move, whole_grad
    local = [whole_grad(move(x, qp)).to_local(grad_placements=gq)
             for x in (q, k, log_decay)]
    return (*local, move(v, vp).to_local(grad_placements=vp))


def _sequence_dim(q, k, v, log_decay, chunk: int) -> Optional[int]:
    """The mesh dim on which the recurrence runs each device's own run of
    tokens, or None: the one dim of more than one device, not sharding q's
    batch, on which any input shards the sequence (dim 1) or is a partial
    sum (a sum to be reduced there anyway, and reduced onto the sequence's
    shards at half an all-reduce's bytes), where each device's run of
    T / n tokens is whole chunks of the one-process chunk length."""
    from torch.distributed.tensor import Shard
    mesh = v.device_mesh
    dims = [i for i in range(mesh.ndim)
            if mesh.size(i) > 1 and q.placements[i] != Shard(0)
            and any(x.placements[i] == Shard(1) or x.placements[i].is_partial()
                    for x in (q, k, v, log_decay))]
    if len(dims) != 1:
        return None
    T, n = v.shape[1], mesh.size(dims[0])
    return dims[0] if T % n == 0 and (T // n) % _chunk_len(T, chunk) == 0 \
        else None


def _on_sequence_shards(q, k, v, log_decay, chunk: int, normalize: bool,
                        seq: int):
    """``chunked_linear_recurrence`` of DTensors whose sequence mesh dim
    ``seq`` holds each device's own run of whole chunks (the batch and
    other mesh dims as ``_placements`` lays them out).

    Each device runs its chunks once from a zero state (``_local_pass``,
    ``_compose``): their outputs, the state entering each chunk and its
    run's summary (a_run, M_run, n_run).  Only the summaries cross the
    sequence's devices: ``_exclusive_prefix`` composes those of the runs
    before each device into the state entering its run, M_in.  A chunk's
    incoming state is then A_c M_in plus its local one (A_c the run's
    decay before chunk c), and ``_finish`` takes it once.  The output
    takes v's layout, but keeps its sequence shards where v held none on
    ``seq`` (the mLSTM's partial sums); the final state, the last run's, is
    a partial sum that every other device holds as zeros (one all-reduce
    where a caller reads it, none where it is discarded).
    """
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.distributed.sharding import move
    mesh = v.device_mesh
    vp, qp, gq = _placements(q, v, seq)
    ql, kl, ll, vl = _to_local(q, k, log_decay, v, vp, qp, gq)
    B, T, H, dk = kl.shape
    dv = vl.shape[-1]
    f32 = torch.float32
    ch = _local_pass(ql, kl, vl, ll, _chunk_len(v.shape[1], chunk), normalize)
    M0 = torch.zeros((B, H, dk, dv), dtype=f32, device=ql.device)
    n0 = torch.zeros((B, H, dk), dtype=f32, device=ql.device)
    M_loc, n_loc, M_run, n_run = _compose(ch, M0, n0, normalize)
    # A_c: the decay of the run's chunks before c; the run's whole a_run
    upto = torch.cumprod(ch.decay, dim=0)            # (NC, B, H)
    A = torch.cat([torch.ones_like(upto[:1]), upto[:-1]])
    a_run = upto[-1]
    parts = (M_run, n_run) if normalize else (M_run,)
    ins = _exclusive_prefix(a_run, parts, mesh, seq)
    M_prev = A[..., None, None] * ins[0] + M_loc
    n_prev = A[..., None] * ins[1] + n_loc if normalize else None
    y = _finish(ch, M_prev, n_prev, normalize, v.dtype)
    # y back to v's layout (a partial sum made whole), but its sequence
    # shards kept where v held none on ``seq``
    back = tuple(p if i == seq and not w.is_shard()
                 else Replicate() if w.is_partial() else w
                 for i, (p, w) in enumerate(zip(vp, v.placements)))
    y = move(DTensor.from_local(y, mesh, vp, run_check=False), back)
    last = mesh.get_local_rank(seq) == mesh.size(seq) - 1
    ends = [_scaled(a_run, p_in) + p if last else torch.zeros_like(p)
            for p_in, p in zip(ins, parts)]
    M, n = ends if normalize else (ends[0], n0)

    def final(t, place, summed):
        place = tuple((Partial() if summed else Replicate()) if i == seq
                      else p for i, p in enumerate(place))
        return DTensor.from_local(t, mesh, place, run_check=False)
    return y, (final(M, vp, True), final(n, qp, normalize))


def _exclusive_prefix(a: torch.Tensor, parts, mesh, dim: int):
    """The composition of the runs before this device along mesh ``dim``:
    each device holds its run's decay ``a`` (B, H) and summaries ``parts``
    (M (B, H, dk, dv), n (B, H, dk)), and the result is the state entering
    its run, (M_in, n_in), by the combine law (a1, P1) then (a2, P2) =
    (a1 a2, a2 P1 + P2) in sequence order; zeros on the first device.

    A doubling scan: in round r = 1, 2, 4, ... each device sends what it
    holds r devices along and composes what it gets with its own, which
    leaves the inclusive prefix after ceil(log2 n) rounds; one shift by
    one device makes it exclusive.  Every send is one all-to-all of uneven
    splits (one peer, a flat fp32 buffer), whose gradient is the reverse
    send.  The sends wrap around the ring and a device composes what came
    from past the first device times 0 (which leaves its own exactly): so
    every device runs the same program, the backward's reverse sends meet
    on every device, and each device sends ceil(log2 n) + 1 buffers each
    way."""
    from torch.distributed import _functional_collectives as funcol
    size, me = mesh.size(dim), mesh.get_local_rank(dim)

    def send(ts, step: int):
        flat = torch.cat([t.reshape(-1) for t in ts])
        m = flat.numel()
        sent = [m if r == (me + step) % size else 0 for r in range(size)]
        got = [m if r == (me - step) % size else 0 for r in range(size)]
        out = funcol.all_to_all_single_autograd(flat, got, sent, (mesh, dim))
        keep = 1.0 if me >= step else 0.0      # 0: from past the first
        return [keep * x.reshape(t.shape)
                for x, t in zip(out.split([t.numel() for t in ts]), ts)], keep

    step = 1
    while step < size:
        got, keep = send((a,) + tuple(parts), step)
        parts = tuple(_scaled(a, p0) + p for p0, p in zip(got[1:], parts))
        a = (got[0] + (1.0 - keep)) * a
        step *= 2
    return send(parts, 1)[0]


def _scaled(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``a`` (B, H) times ``p`` (B, H, ...)."""
    return a.reshape(a.shape + (1,) * (p.ndim - a.ndim)) * p


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
