"""Gradient compression for the DP sync, as ``repro.optim.compression``.

The Ridgeline case study's conclusion is that data-parallel training below a
batch threshold is NETWORK bound: t_N = B_N / net_bw dominates.  These
compressors shrink B_N (the all-reduce wire volume) at fixed model size:

  * Int8Compressor — per-tensor-chunk scale + int8 quantization with ERROR
    FEEDBACK (residual carried to the next step): 4x wire reduction vs fp32.
  * TopKCompressor — keep the largest |g| fraction per tensor with error
    feedback: wire ~ 2 * k * (4B idx + 4B val).

``round_trip`` (compress -> decompress) is what the train step applies to
the global-mean gradient (``train/loop.py``: after the microbatch mean and
any all-reduce, before the optimizer), so the update sees the numerics of
the compressed wire.  ``wire_fraction`` reports the B_N scale factor for the
Ridgeline projection.

The arithmetic is the reference's: ``torch.round`` rounds half to even, as
``jnp.round`` does (a tie at .5 is a real case on the int8 grid), the chunk
is zero-padded and the scale floored at 1e-12; the top-k threshold is the
k-th largest magnitude and ``>=`` keeps every tie.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class CompressorState(NamedTuple):
    residual: Params      # error-feedback memory, fp32


def _zeros_f32(params: Params) -> CompressorState:
    return CompressorState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _per_leaf(one: Callable, grads: Params, state: CompressorState
              ) -> Tuple[Params, CompressorState]:
    """``one(g, r) -> (deq, new residual)`` over the leaves of ``grads``."""
    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(state.residual))]
    return (tree_unflatten(grads, [d for d, _ in out]),
            CompressorState(residual=tree_unflatten(
                state.residual, [r for _, r in out])))


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Per-chunk symmetric int8 with error feedback."""

    chunk: int = 4096

    def init(self, params: Params) -> CompressorState:
        return _zeros_f32(params)

    def _chunks(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x flattened, zero-padded to whole chunks: (chunks, scale)."""
        flat = x.reshape(-1)
        fp = F.pad(flat, (0, (-flat.shape[0]) % self.chunk)).reshape(
            -1, self.chunk)
        scale = torch.clamp(fp.abs().amax(dim=1, keepdim=True) / 127.0,
                            min=1e-12)
        return fp, scale

    def compress(self, g: torch.Tensor, r: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """g + r -> (q int8, scale, new residual)."""
        x = g.float() + r
        fp, scale = self._chunks(x)
        q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
        deq = (q.float() * scale).reshape(-1)[:x.numel()].reshape(x.shape)
        return q, scale, x - deq

    def round_trip_tree(self, grads: Params, state: CompressorState
                        ) -> Tuple[Params, CompressorState]:
        def one(g, r):
            x = g.float() + r
            fp, scale = self._chunks(x)
            q = torch.clamp(torch.round(fp / scale), -127, 127)
            deq = (q * scale).reshape(-1)[:x.numel()].reshape(x.shape)
            return deq.to(g.dtype), x - deq

        return _per_leaf(one, grads, state)

    @property
    def wire_fraction(self) -> float:
        """int8 payload + fp32 scale per chunk vs fp32 baseline."""
        return (1.0 + 4.0 / self.chunk) / 4.0


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Magnitude top-k with error feedback (k = keep fraction)."""

    keep: float = 0.01

    def init(self, params: Params) -> CompressorState:
        return _zeros_f32(params)

    def round_trip_tree(self, grads: Params, state: CompressorState
                        ) -> Tuple[Params, CompressorState]:
        def one(g, r):
            x = g.float() + r
            flat = x.reshape(-1)
            k = max(1, int(flat.shape[0] * self.keep))
            thresh = torch.topk(flat.abs(), k).values[-1]
            kept = torch.where(flat.abs() >= thresh, flat, 0.0)
            deq = kept.reshape(x.shape)
            return deq.to(g.dtype), x - deq

        return _per_leaf(one, grads, state)

    @property
    def wire_fraction(self) -> float:
        return 2.0 * self.keep  # (idx + val) per kept entry vs dense fp32


class StatelessRoundTrip:
    """Adapter matching TrainStepConfig.compression (residual folded into a
    step-held buffer is the stateful path; this stateless variant quantizes
    without error feedback, for ablations)."""

    def __init__(self, comp: Int8Compressor):
        self.comp = comp

    def round_trip(self, grads: Params) -> Params:
        deq, _ = self.comp.round_trip_tree(grads, self.comp.init(grads))
        return deq
