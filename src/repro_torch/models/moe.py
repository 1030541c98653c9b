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

``moe_specs`` gives the logical axes of ``init_moe``'s tree (the dry-run
of this family waits for ROADMAP Queue 1 item 12 step 7).
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
    xt = x.reshape(G, Tg, D).to(dt)

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

    xin = torch.einsum("gtec,gtd->gecd", dispatch, xt)        # (G, E_pad, C, D)
    g = F.silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(dt))
    h = torch.einsum("gecf,efd->gecd", g * u, p["w_down"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", combine, h)          # (G, Tg, D)

    out = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + ffn_mod.apply_ffn(p["shared"], x.to(dt), cfg)
    return out, aux.float()
