"""Shared model substrate: initializers, norms, rope, activations, loss.

The port of ``src/repro/models/common.py``: plain functions on tensors over
dict params.  Parameters stay fp32 and are cast to ``cfg.compute_dtype`` at
use; norms, rope and the loss compute in fp32.  Initializers draw from an
explicit ``torch.Generator`` on its own device and place the weights on the
caller's device: ``None`` is the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig, Params, Specs


# --- initializers -------------------------------------------------------------

def init_rng(generator: Optional[torch.Generator], device: DeviceLike
             ) -> Tuple[torch.Generator, torch.device]:
    """The generator and device of a public ``init_*``: ``device=None`` is
    the card (``resolve_device``), and with no generator the draws come from
    a default CPU ``torch.Generator``, as ``mlp_dlrm.init_mlp``'s do."""
    dev = resolve_device(device)
    return (generator if generator is not None else torch.Generator()), dev


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> torch.Tensor:
    """N(0, 1/d_in) weight of shape (d_in, d_out), drawn on ``gen``'s device
    and placed on ``device`` (default: ``gen``'s device)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(device or gen.device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> torch.Tensor:
    """N(0, 0.02^2) table of shape (vocab, d), drawn on ``gen``'s device and
    placed on ``device`` (default: ``gen``'s device)."""
    w = torch.randn((vocab, d), generator=gen, dtype=dtype, device=gen.device)
    return (w * 0.02).to(device or gen.device)


def zeros(shape, dtype: torch.dtype = torch.float32,
          device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype: torch.dtype = torch.float32,
         device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


# --- norms --------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: Optional[int] = None,
              device: Optional[torch.device] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": ones((d,), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = zeros((d,), device=device)
    return p


def norm_specs(cfg: ModelConfig) -> Specs:
    p = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        p["bias"] = ("embed",)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm or layernorm over the last dim in fp32, cast to compute dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(cfg.compute_dtype)


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-head QK-norm (Qwen3): normalize over the last (head) dim."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --- rotary position embeddings -----------------------------------------------

def rope_freqs(dh: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, dh); positions: broadcastable to (..., seq).

    The rotation pairs dim i with dim i + dh/2 (halves, not interleaved
    pairs), in fp32.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)              # (dh/2,)
    ang = positions[..., :, None].float() * freqs               # (..., seq, dh/2)
    cos = torch.cos(ang)[..., :, None, :]                       # (..., seq, 1, dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (seq, d) in fp32: sin in the
    even columns, cos in the odd ones, the exponent's step
    ``log(10000) / (d // 2 - 1)`` (1 for ``d <= 2``), as the reference's."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    step = -math.log(10000.0) / (d // 2 - 1 if d > 2 else 1)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * step)
    tab = torch.zeros((seq, d), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


def clamped_row(table: torch.Tensor, pos: int) -> torch.Tensor:
    """Row ``pos`` of ``table`` as a (1, d) view, ``pos`` clamped into
    ``[0, rows - 1]`` as ``jax.lax.dynamic_slice_in_dim`` clamps its start."""
    i = min(max(int(pos), 0), table.shape[0] - 1)
    return table[i:i + 1]


# --- activations ----------------------------------------------------------------

def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """``gelu`` is the tanh form, as ``jax.nn.gelu`` defaults to."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu":
        return torch.relu(x)
    if name == "relu2":  # squared ReLU (Primer / Nemotron family)
        r = torch.relu(x)
        return r * r
    raise ValueError(name)


# --- losses ---------------------------------------------------------------------

def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's CE, in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits (..., V) any dtype -> fp32 loss.

    On a DTensor each device sums its own rows' CE (the vocab gathered
    first where it is sharded; the training rules shard batch and seq and
    leave it whole) and the sum is a partial over the mesh: the gather
    along the vocab and its backward stay local, where DTensor's own
    ``gather`` backward would build the gradient replicated at its global
    size.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        whole = [Replicate() if isinstance(p, Shard)
                 and p.dim == logits.ndim - 1 else p
                 for p in logits.placements]
        logits = logits.redistribute(mesh, whole)
        labels = labels.redistribute(mesh, logits.placements)
        total = _token_ce(logits.to_local(), labels.to_local()).sum()
        partial = [Partial() if isinstance(p, Shard) else p
                   for p in logits.placements]
        total = DTensor.from_local(total, mesh, partial, run_check=False)
        return total / labels.numel()
    return _token_ce(logits, labels).mean()


# --- param counting ---------------------------------------------------------------

def count_params(params: Params) -> int:
    """Elements over every tensor leaf of nested dicts and lists."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(p) for p in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(p) for p in params)
    return 0
