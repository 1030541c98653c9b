"""The plain float32 decoder LM: a transformer of MoE layers.

Written out from the configuration's file, for the benchmark's weights (the
port's parameter layout, ``ridgebench/weights.py``):

* attention: GQA with the kv heads repeated, RoPE on halves of each head
  (``theta ** (-2i / dh)``), an optional QKV bias, causal; softmax in
  float32;
* the MoE FFN (``family: moe``): softmax over the router's logits, the top
  k experts (ties to the lower index), the k gates renormalised where the
  file's ``norm_topk_prob`` says so.  Tokens are routed in groups of
  ``moe_group_tokens`` consecutive tokens (one per sequence, or one in all,
  where that does not divide them); each expert takes at most
  ``C = max(int(Tg * k * capacity_factor / E), k)`` choices of a group, in
  the order (token, choice), and drops the rest.  Each kept expert's SwiGLU
  output is weighted by the sum of the token's kept gates, the combine rule
  of the reference implementation this port follows; the shared experts
  are one SwiGLU FFN of ``shared_expert_intermediate_size`` added to every
  token.

Every product goes through ``Arith``.  Norms and softmax are float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

NEG = float("-inf")


class Arith:
    """The products of a reference: ``fp32`` (TF32 off), or ``fp8``, where
    each input of a product is first rounded to float8 e4m3 with one scale
    a tensor (its largest magnitude onto 448), as an fp8 product takes it;
    the sums stay float32."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp32":
            return x
        s = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]
        torch.set_float32_matmul_precision(keep[2])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, dh), positions 0..S-1: dim i turns with dim i + dh/2."""
    S, dh = x.shape[-3], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(p: Dict, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    return ar.mm(F.silu(ar.mm(x, p["w_gate"])) * ar.mm(x, p["w_up"]),
                 p["w_down"])


def attention(p: Dict, x: torch.Tensor, doc: Dict, ar: Arith
              ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), causal."""
    B, S, _ = x.shape
    H, K = doc["num_attention_heads"], doc["num_key_value_heads"]
    dh = doc["hidden_size"] // H
    q, k, v = (ar.mm(x, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, H, dh), doc["rope_theta"])
    k = rope(k.reshape(B, S, K, dh), doc["rope_theta"])
    v = v.reshape(B, S, K, dh)
    k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    pos = torch.arange(S, device=x.device)
    ok = pos[None, :] <= pos[:, None]
    outs = []
    for b in range(B):                  # one sequence's scores at a time
        s = ar.einsum("qhd,khd->hqk", q[b], k[b]) / math.sqrt(dh)
        w = torch.softmax(s.masked_fill(~ok, NEG), dim=-1)
        outs.append(ar.einsum("hqk,khd->qhd", w, v[b]))
    return ar.mm(torch.stack(outs).reshape(B, S, H * dh), p["wo"])


class Routing:
    """The expert choices of a forward, layer by layer: the reference's
    own top k, or, with ``follow`` (one (T, k) choice tensor a MoE layer,
    in order), another side's.  ``chosen`` keeps the choices taken;
    ``gap`` is the widest a followed choice fell short of the reference's
    k-th largest router logit (0 where it chose the reference's top k)."""

    def __init__(self, follow: Optional[List[torch.Tensor]] = None):
        self.follow = follow
        self.chosen: List[torch.Tensor] = []
        self.gap = 0.0

    def choose(self, z: torch.Tensor, k: int) -> torch.Tensor:
        """The k experts of each token, from router logits z (T, E)."""
        top = torch.sort(z, dim=-1, descending=True, stable=True)
        if self.follow is None:
            idx = top.indices[:, :k]
        else:
            idx = self.follow[len(self.chosen)].to(z.device)
            short = top.values[:, k - 1] - z.gather(-1, idx).min(-1).values
            self.gap = max(self.gap, float(short.max()))
        self.chosen.append(idx)
        return idx


def moe(p: Dict, x: torch.Tensor, doc: Dict, ar: Arith,
        routing: Optional[Routing] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared ones; the
    experts a token takes are ``routing``'s (by default its own top k)."""
    B, S, D = x.shape
    E, k = doc["num_experts"], doc["num_experts_per_tok"]
    port = doc["port"]
    routing = routing or Routing()
    T = B * S
    Tg = min(port["moe_group_tokens"], T)
    if T % Tg:
        Tg = S if T % S == 0 else T
    C = max(int(Tg * k * port["capacity_factor"] / E), k)
    xt = x.reshape(T, D)
    z = ar.mm(xt, p["router"])
    probs = torch.softmax(z, dim=-1)
    idx = routing.choose(z, k)                               # (T, k)
    gates = probs.gather(-1, idx)
    if doc["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # each choice's place in its expert's buffer: earlier choices of the
    # same expert in its group, in (token, choice) order
    oh = F.one_hot(idx.reshape(T // Tg, Tg * k), E).float()
    place = ((oh.cumsum(1) - oh) * oh).sum(-1).reshape(T, k)
    keep = place < C
    weight = (gates * keep).sum(-1)                           # (T,)
    out = torch.zeros_like(xt)
    for e in range(E):
        rows = ((idx == e) & keep).any(-1).nonzero()[:, 0]
        if rows.numel():
            pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
            out = out.index_add(0, rows,
                                swiglu(pe, xt[rows], ar) * weight[rows, None])
    out = out.reshape(x.shape)
    return out + swiglu(p["shared"], x, ar)


def block(p: Dict, x: torch.Tensor, doc: Dict, ar: Arith,
          routing: Optional[Routing] = None) -> torch.Tensor:
    """One pre-norm block: attention, then the MoE FFN."""
    eps = doc["rms_norm_eps"]
    x = x + attention(p["attn"], rms_norm(x, p["attn_norm"]["scale"], eps),
                      doc, ar)
    h = rms_norm(x, p["ffn_norm"]["scale"], eps)
    return x + moe(p["moe"], h, doc, ar, routing)


def hidden(params: Dict, tokens: torch.Tensor, doc: Dict, ar: Arith,
           routing: Optional[Routing] = None) -> torch.Tensor:
    """tokens (B, S) -> the final-normed hidden states (B, S, D) in float32;
    ``routing`` picks each layer's experts."""
    x = params["embed"][tokens].float()
    for blk in params["blocks"]:
        x = block(blk, x, doc, ar, routing)
    return rms_norm(x, params["final_norm"]["scale"], doc["rms_norm_eps"])


def logits(params: Dict, h: torch.Tensor, ar: Arith) -> torch.Tensor:
    """The head over hidden states h (..., D) -> float32 logits (..., V)."""
    return ar.mm(h, params["lm_head"])


def row_blocks(params: Dict, tokens: torch.Tensor, doc: Dict, ar: Arith,
               routing: Optional[Routing] = None) -> Iterator[torch.Tensor]:
    """The float32 logits of each sequence of ``tokens`` (B, S) in turn,
    one (S, V) block each; ``routing`` picks each layer's experts.  The
    hidden states are computed here, the head's blocks as they are read."""
    with torch.no_grad():
        h = hidden(params, tokens, doc, ar, routing=routing)
    return _head_blocks(params, h, ar)


def _head_blocks(params: Dict, h: torch.Tensor, ar: Arith
                 ) -> Iterator[torch.Tensor]:
    for b in range(h.shape[0]):
        with torch.no_grad():
            out = logits(params, h[b], ar)
        yield out
