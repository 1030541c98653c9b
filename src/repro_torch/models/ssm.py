"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) + sLSTM (scalar).

The port of ``src/repro/models/ssm.py``.

mLSTM: per-head matrix memory C_t = f_t C_{t-1} + i_t k_t v_t^T with
normalizer n_t and output y_t = (q_t C_t) / max(|q_t n_t|, 1), bounded
sigmoid gates (i_t = σ(ĩ), f_t = σ(f̃)) as in the reference.  Prefill runs
the chunked SSD form (``models/ssd.py``); decode the exact sequential
update on the constant-size state.  The block has the paper's up-projection
factor 2 and a gated output.

sLSTM: a scalar state per channel with exponential gating and the paper's
stabilizer state m_t, run as the exact per-time-step recurrence (a Python
loop over the sequence; ``w_x`` applied once to the whole sequence first),
then a GeGLU post-FFN of factor 4/3.  The reference's ``jax.checkpoint``
around its time chunks changes only the backward, so it has no counterpart
here.  Training takes autograd through both, the sLSTM's loop included.

Under a mesh the mLSTM's products run on the shards (``sharding.sp_matmul``)
with the reference's ``shard_hint`` sites, the four products of the
sequence-sharded u and the down product on each device's own tokens
against the gathered weight (``sharding.tokens_matmul``), and the log-sigmoid gates on each device's shard
(``_log_sigmoid``); the sLSTM's recurrence runs on local
tensors, each device its batch rows and channels (``_channels``), its
sequence moved once a layer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (shard_hint, sp_matmul,
                                              tokens_matmul)
from repro_torch.models.attention import _scale
from repro_torch.models.common import (activation, dense_init, init_rng, ones,
                                       zeros)
from repro_torch.models.config import ModelConfig, Params, Specs
from repro_torch.models.ssd import (State, chunked_linear_recurrence,
                                    decode_linear_step, init_linear_state)

PROJ_FACTOR = 2  # mLSTM up-projection (paper's p_f = 2)


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = PROJ_FACTOR * cfg.d_model
    H = cfg.n_heads
    return H, d_inner // H


# --- mLSTM -------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card)."""
    gen, dev = init_rng(generator, device)
    H, dh = _heads(cfg)
    d_inner = H * dh
    return {
        "w_up": dense_init(gen, cfg.d_model, d_inner, device=dev),
        "w_gate": dense_init(gen, cfg.d_model, d_inner, device=dev),
        "wq": dense_init(gen, d_inner, d_inner, device=dev),
        "wk": dense_init(gen, d_inner, d_inner, device=dev),
        "wv": dense_init(gen, d_inner, d_inner, device=dev),
        "w_if": dense_init(gen, d_inner, 2 * H, device=dev),  # i, f logits
        "b_if": zeros((2 * H,), device=dev),
        "skip_scale": ones((d_inner,), device=dev),
        "w_down": dense_init(gen, d_inner, cfg.d_model, device=dev),
    }


def mlstm_specs(cfg: ModelConfig) -> Specs:
    return {
        "w_up": ("embed", "ffn"), "w_gate": ("embed", "ffn"),
        "wq": ("ffn", "ffn"), "wk": ("ffn", "ffn"), "wv": ("ffn", "ffn"),
        "w_if": ("ffn", None), "b_if": (None,),
        "skip_scale": ("ffn",), "w_down": ("ffn", "embed"),
    }


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; of a DTensor, on each device's shard (DTensor has no
    rule for its backward), a partial sum made whole first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    place = tuple(Replicate() if isinstance(p, Partial) else p
                  for p in x.placements)
    if place != tuple(x.placements):
        x = x.redistribute(x.device_mesh, place)
    return DTensor.from_local(F.logsigmoid(x.to_local(grad_placements=place)),
                              x.device_mesh, place, run_check=False)


def _mlstm_qkvg(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """(u, z, q, k·i, v, log f) of the compute-dtype ``x`` (B, S, D).  q and
    k are divided by sqrt(dh) rounded to the compute dtype, as the
    reference divides by ``jnp.sqrt(dh).astype(dt)``.  Under a mesh the
    four products of u run on each device's tokens (``tokens_matmul``)."""
    dt = cfg.compute_dtype
    H, dh = _heads(cfg)
    B, S, _ = x.shape
    u = shard_hint(tokens_matmul(x, p["w_up"].to(dt)),
                   ("batch", "seq", "ffn"))
    z = F.silu(shard_hint(tokens_matmul(x, p["w_gate"].to(dt)),
                          ("batch", "seq", "ffn")))
    scale = _scale(dh, dt)
    q = tokens_matmul(u, p["wq"].to(dt)).reshape(B, S, H, dh) / scale
    k = tokens_matmul(u, p["wk"].to(dt)).reshape(B, S, H, dh) / scale
    v = tokens_matmul(u, p["wv"].to(dt)).reshape(B, S, H, dh)
    gif = (tokens_matmul(u, p["w_if"].to(dt)) + p["b_if"].to(dt)).float()
    i_gate = torch.sigmoid(gif[..., :H])               # (B,S,H)
    log_f = _log_sigmoid(gif[..., H:])                 # (B,S,H), <= 0
    return u, z, q, k * i_gate[..., None].to(dt), v, log_f


def apply_mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = x.to(dt)
    B, S, _ = x.shape
    H, dh = _heads(cfg)
    u, z, q, k, v, log_f = _mlstm_qkvg(p, x, cfg)
    chunk = min(cfg.ssm_chunk, S)
    y, _ = chunked_linear_recurrence(q, k, v, log_f, chunk=chunk,
                                     normalize=True)
    y = y.reshape(B, S, H * dh) + u * p["skip_scale"].to(dt)
    return tokens_matmul(y * z, p["w_down"].to(dt))


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = None) -> State:
    H, dh = _heads(cfg)
    return init_linear_state(batch, H, dh, dh, device=device)


def decode_mlstm(p: Params, x: torch.Tensor, state: State, cfg: ModelConfig):
    """x (B, 1, D) -> (y (B, 1, D), the new (M, n))."""
    dt = cfg.compute_dtype
    x = x.to(dt)
    B = x.shape[0]
    H, dh = _heads(cfg)
    u, z, q, k, v, log_f = _mlstm_qkvg(p, x, cfg)
    y, state = decode_linear_step(
        state, q[:, 0], k[:, 0], v[:, 0], torch.exp(log_f[:, 0]),
        normalize=True)
    y = y.reshape(B, 1, H * dh) + u * p["skip_scale"].to(dt)
    return (y * z) @ p["w_down"].to(dt), state


# --- sLSTM -------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator``, placed on ``device`` (None:
    the card).  The recurrence is per channel (``r_diag``); 4 gates: i, f,
    z (cell input), o."""
    gen, dev = init_rng(generator, device)
    D = cfg.d_model
    return {
        "w_x": dense_init(gen, D, 4 * D, device=dev),
        "r_diag": zeros((4, D), device=dev),
        "b": zeros((4 * D,), device=dev),
        "w_ffn_up": dense_init(gen, D, (4 * D) // 3 * 2, device=dev),
        "w_ffn_down": dense_init(gen, (4 * D) // 3, D, device=dev),
    }


def slstm_specs(cfg: ModelConfig) -> Specs:
    return {"w_x": ("embed", None), "r_diag": (None, "embed"), "b": (None,),
            "w_ffn_up": ("embed", "ffn"), "w_ffn_down": ("ffn", "embed")}


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """c, n, h zeros and the stabilizer m at -10, fp32 (batch, D)."""
    return _fresh_state((batch, cfg.d_model), resolve_device(device))


def _fresh_state(shape: Tuple[int, ...],
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    return {"c": torch.zeros(shape, device=dev),
            "n": torch.zeros(shape, device=dev),
            "h": torch.zeros(shape, device=dev),
            "m": torch.full(shape, -10.0, device=dev)}


def _slstm_step(state: Dict[str, torch.Tensor], xw: torch.Tensor,
                r: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One exact sLSTM step with exponential gating and the stabilizer
    (paper eq. 9), in fp32: ``xw`` (..., 4, D) the gates' inputs x·w_x,
    ``r`` and ``b`` (4, D) fp32 the recurrent diagonal and the bias of the
    same channels.  The recurrent term h·r per gate is added to x·w_x
    before the bias, as in the reference."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    gates = xw.float() + h[..., None, :] * r + b
    gi, gf, gz, go = gates.unbind(-2)
    log_f = _log_sigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)                # stabilizer state
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n.abs(), min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_cell(p: Params, state: Dict[str, torch.Tensor], xw: torch.Tensor,
                cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """``_slstm_step`` of xw (..., 4D) and the block's own ``r_diag`` and
    ``b``."""
    D = xw.shape[-1] // 4
    return _slstm_step(state, xw.unflatten(-1, (4, D)), p["r_diag"].float(),
                       p["b"].float().reshape(4, D))


def _slstm_scan(xw: torch.Tensor, r: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) of the recurrence over xw (B, S, 4, D) from a fresh
    state, step by step."""
    B, S, _, D = xw.shape
    st = _fresh_state((B, D), xw.device)
    hs = []
    for t in range(S):
        st = _slstm_step(st, xw[:, t], r, b)
        hs.append(st["h"])
    return torch.stack(hs, dim=1)


def _channels(xw, p: Params, channel_split: bool):
    """xw (B, [S,] 4D) of DTensors on the channels the recurrence runs on:
    (xw (B, [S,] 4, D), r, b (4, D)) as local tensors, and the placements
    of a (B, [S,] D) state or output on them.

    The recurrence is per channel, so each device runs its batch rows (the
    mesh axes that shard xw's batch) and, with ``channel_split``, a slice
    of the channels on the others where D divides them: xw moves once, by
    one all-to-all from a sharded sequence (a slice from a whole one),
    and r and b are sliced to the same channels.  Elsewhere the channels
    stay whole (the sequence gathered).  The grads are handed back as
    those layouts give them: r's and b's a partial sum over the batch
    axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    mesh = xw.device_mesh
    D = xw.shape[-1] // 4
    last = xw.ndim - 1
    came = tuple(pl if pl.is_shard() and pl.dim < last else Replicate()
                 for pl in xw.placements)
    xw = move(xw, came)
    xw = DTensor.from_local(xw.to_local().unflatten(-1, (4, D)), mesh, came,
                            run_check=False,
                            shape=(*xw.shape[:-1], 4, D),
                            stride=(*xw.stride()[:-1], D, 1))
    x_to, out, w_to, gw, split = [], [], [], [], 1
    for i, pl in enumerate(came):
        if pl == Shard(0):
            x_to.append(pl)
            out.append(pl)
            w_to.append(Replicate())
            gw.append(Partial())
        elif channel_split and mesh.size(i) > 1 and D % (split
                                                         * mesh.size(i)) == 0:
            split *= mesh.size(i)
            x_to.append(Shard(last + 1))
            out.append(Shard(last))
            w_to.append(Shard(1))
            gw.append(Shard(1))
        else:
            x_to.append(Replicate())
            out.append(Replicate())
            w_to.append(Replicate())
            gw.append(Replicate())
    xl = move(xw, x_to).to_local(grad_placements=x_to)
    r, b = (move(w, w_to).to_local(grad_placements=gw)
            for w in (p["r_diag"].float(), p["b"].float().reshape(4, D)))
    return xl, r, b, tuple(out)


def _geglu(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The sLSTM block's post-FFN: gelu (tanh form) of one half of the
    up-projection times the other, then down.

    Of a DTensor h, laid out here.  A contiguous column shard of the
    column-parallel ``w_ffn_up`` holds columns of one half only, so on the
    mesh axes that shard those columns each device takes the same slice of
    both halves (the weight gathered whole, then sliced: its grad a
    partial sum), h is gathered whole there (Megatron-SP's entry
    all-gather) and the gated product runs on each device's slice; the
    row-parallel down-projection sums the slices (``sp_matmul``).
    DTensor's own matmul flattens (batch, seq) in its backward, which
    torch 2.11 refuses while both are sharded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import move
    dt = cfg.compute_dtype
    w_up, w_down = p["w_ffn_up"].to(dt), p["w_ffn_down"].to(dt)
    if not isinstance(h, DTensor):
        a, b = torch.chunk(h @ w_up, 2, dim=-1)
        return (activation("gelu", a) * b) @ w_down
    mesh = h.device_mesh
    last, half = h.ndim - 1, w_up.shape[1] // 2
    h_to, gh, out, gw, split, run = [], [], [], [], 1, 0
    for i, (ph, pw) in enumerate(zip(h.placements, w_up.placements)):
        n = mesh.size(i)
        if pw == Shard(1) and half % (split * n) == 0:   # column-parallel
            split *= n
            run = run * n + mesh.get_local_rank(i)
            h_to.append(Replicate())
            gh.append(Partial())
            out.append(Shard(last))
            gw.append(Partial())
        elif isinstance(ph, Shard) and ph.dim < last:    # h's rows
            h_to.append(ph)
            gh.append(ph)
            out.append(ph)
            gw.append(Partial())
        else:
            h_to.append(Replicate())
            gh.append(Replicate())
            out.append(Replicate())
            gw.append(Replicate())
    cols = half // split
    w = move(w_up, (Replicate(),) * mesh.ndim).to_local(grad_placements=gw)
    w = w.unflatten(1, (2, half))[:, :, run * cols:(run + 1) * cols]
    a, b = torch.chunk(move(h, h_to).to_local(grad_placements=gh)
                       @ w.flatten(1), 2, dim=-1)
    y = DTensor.from_local(activation("gelu", a) * b, mesh, tuple(out),
                           run_check=False)
    return sp_matmul(y, w_down)


def apply_slstm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence sLSTM: the exact recurrence step by step, then the
    GeGLU post-FFN.  x (B, S, D) -> (B, S, D) in the compute dtype.

    Of a DTensor, the recurrence runs on local tensors, each device its
    batch rows and its slice of the channels (``_channels``): the sequence
    moves once a layer, by all-to-all, never once a step.  Where D does
    not divide a mesh axis, that axis gathers the sequence once and every
    device on it runs the whole channels.  h then goes back whole on the
    non-batch axes, the layout the post-FFN's column-parallel product
    takes (one all-gather of its channels)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import move
    dt = cfg.compute_dtype
    B, S, D = x.shape
    xw = sp_matmul(x.to(dt), p["w_x"].to(dt))          # (B, S, 4D)
    if not isinstance(xw, DTensor):
        hs = _slstm_scan(xw.unflatten(-1, (4, D)), p["r_diag"].float(),
                         p["b"].float().reshape(4, D))
        return _geglu(p, hs.to(dt), cfg)
    mesh = xw.device_mesh
    xl, r, b, place = _channels(xw, p, channel_split=True)
    hs = DTensor.from_local(_slstm_scan(xl, r, b), mesh, place,
                            run_check=False, shape=(B, S, D),
                            stride=(S * D, D, 1))
    hs = move(hs, tuple(pl if pl == Shard(0) else Replicate()
                        for pl in place))
    return _geglu(p, hs.to(dt), cfg)


def decode_slstm(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """x (B, 1, D) -> (y (B, 1, D), the new state).  Of DTensors, the step
    runs on local tensors in xw's batch layout, the channels whole, and
    the new state keeps the layout the state came in (a plain state under
    a mesh is every device's whole copy: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import move
    dt = cfg.compute_dtype
    xw = sp_matmul(x[:, 0].to(dt), p["w_x"].to(dt))
    if not isinstance(xw, DTensor):
        state = _slstm_cell(p, state, xw, cfg)
        return _geglu(p, state["h"][:, None, :].to(dt), cfg), state
    mesh = xw.device_mesh
    state = {k: v if isinstance(v, DTensor) else DTensor.from_local(
        v, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        for k, v in state.items()}
    xl, r, b, place = _channels(xw, p, channel_split=False)
    local = {k: move(v, place).to_local(grad_placements=place)
             for k, v in state.items()}
    new = {k: move(DTensor.from_local(v, mesh, place, run_check=False,
                                      shape=state[k].shape,
                                      stride=state[k].stride()),
                   state[k].placements)
           for k, v in _slstm_step(local, xl, r, b).items()}
    return _geglu(p, new["h"][:, None, :].to(dt), cfg), new
