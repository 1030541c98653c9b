"""F and B_M of one call, counted while it runs: the port's counterpart of
``repro.core.hlo_analysis.cost_analysis_dict``, which reads them off XLA's
compiled program.

  * F is ``torch.utils.flop_counter.FlopCounterMode``'s total: the
    products (mm, addmm, bmm, convolutions, attention) in the forward and
    the backward; elementwise work counts 0, as in XLA's count of a GEMM
    step, where the products dominate.
  * B_M sums, over every aten op the call dispatches, the bytes of its
    tensor inputs and outputs (each read or written once per op); views
    move nothing and count 0, and so does ``_unsafe_view``, the reshape
    ``einsum`` and ``matmul`` apply to a tensor they made, which aliases its
    input but is not marked a view.  A gather counts its whole table.

B_M is the traffic of the *eager, unfused* program: every elementwise op
reads and writes its operands through device memory.  It is more than
XLA's "bytes accessed" for the same step, which counts the fused program
(an optimizer update is one fusion there, a dozen ops here).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.tree import tree_leaves


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


#: ops that alias their input without being marked views in their schema
_ALIASES = (torch.ops.aten._unsafe_view.default,)


class _ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every non-view aten op's tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _ALIASES):
            self.bytes += sum(_nbytes(x) for x in tree_leaves(
                [list(args), dict(kwargs or {}), out]))
        return out


def count(fn: Callable, *args, **kwargs) -> Tuple[float, float]:
    """(F, B_M) of one ``fn(*args, **kwargs)``; runs it twice, once under
    each counter, so ``fn`` must not change its inputs."""
    with FlopCounterMode(display=False) as flops:
        fn(*args, **kwargs)
    with _ByteCounter() as nbytes:
        fn(*args, **kwargs)
    return float(flops.get_total_flops()), float(nbytes.bytes)
