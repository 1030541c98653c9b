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
with the reference's ``shard_hint`` sites, and the log-sigmoid gates on each
device's shard (``_log_sigmoid``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard_hint, sp_matmul
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
    reference divides by ``jnp.sqrt(dh).astype(dt)``."""
    dt = cfg.compute_dtype
    H, dh = _heads(cfg)
    B, S, _ = x.shape
    u = shard_hint(sp_matmul(x, p["w_up"].to(dt)), ("batch", "seq", "ffn"))
    z = F.silu(shard_hint(sp_matmul(x, p["w_gate"].to(dt)),
                          ("batch", "seq", "ffn")))
    scale = _scale(dh, dt)
    q = sp_matmul(u, p["wq"].to(dt)).reshape(B, S, H, dh) / scale
    k = sp_matmul(u, p["wk"].to(dt)).reshape(B, S, H, dh) / scale
    v = sp_matmul(u, p["wv"].to(dt)).reshape(B, S, H, dh)
    gif = (sp_matmul(u, p["w_if"].to(dt)) + p["b_if"].to(dt)).float()
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
    return sp_matmul(y * z, p["w_down"].to(dt))


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
    dev = resolve_device(device)
    shape = (batch, cfg.d_model)
    return {"c": torch.zeros(shape, device=dev),
            "n": torch.zeros(shape, device=dev),
            "h": torch.zeros(shape, device=dev),
            "m": torch.full(shape, -10.0, device=dev)}


def _slstm_cell(p: Params, state: Dict[str, torch.Tensor], xw: torch.Tensor,
                cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One exact sLSTM step with exponential gating and the stabilizer
    (paper eq. 9), in fp32: the recurrent term h·r per gate is added to
    x·w_x before the bias, as in the reference."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    r = p["r_diag"].float()
    gates = xw.float() + torch.cat(
        [h * r[0], h * r[1], h * r[2], h * r[3]], dim=-1) + p["b"].float()
    gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
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


def _geglu(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The sLSTM block's post-FFN: gelu (tanh form) of one half of the
    up-projection times the other, then down."""
    dt = cfg.compute_dtype
    a, b = torch.chunk(h @ p["w_ffn_up"].to(dt), 2, dim=-1)
    return (activation("gelu", a) * b) @ p["w_ffn_down"].to(dt)


def apply_slstm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence sLSTM: the exact recurrence step by step, then the
    GeGLU post-FFN.  x (B, S, D) -> (B, S, D) in the compute dtype."""
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    xw = x.to(dt) @ p["w_x"].to(dt)                    # (B, S, 4D)
    st = init_slstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, st, xw[:, t], cfg)
        hs.append(st["h"])
    return _geglu(p, torch.stack(hs, dim=1).to(dt), cfg)


def decode_slstm(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """x (B, 1, D) -> (y (B, 1, D), the new state)."""
    dt = cfg.compute_dtype
    xw = x[:, 0].to(dt) @ p["w_x"].to(dt)
    state = _slstm_cell(p, state, xw, cfg)
    return _geglu(p, state["h"][:, None, :].to(dt), cfg), state
