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

Under a mesh, ``MeshCounter`` counts what *one device* does: the port's
counterpart of XLA's per-device cost analysis and of
``core/hlo_analysis.parse_collectives``.  Placed around a DTensor call,
``FlopCounterMode`` counts the global op; this mode lets DTensor desugar
each op first (it answers ``NotImplemented`` to a DTensor) and counts the
local ops on the shards, the collectives DTensor issues among them
(``_c10d_functional``: kind, result bytes, group size, wire bytes by the
reference's ring factors, and with ``pod_size`` the share of each ring's
hops that cross a pod), and the live bytes of the shards, whose maximum is
the peak memory per device.  Ops that DTensor's sharding propagation runs
on its own fake tensors (global shapes, to infer the output's) are run and
not counted.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

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


# --- per-device counts under a mesh ------------------------------------------

#: per-device wire-byte factor of each collective kind, applied to the
#: *result* buffer's bytes (``repro.core.hlo_analysis._COLLECTIVE_KINDS``):
#: all-reduce 2 (n-1)/n; all-gather (n-1)/n of the gathered result;
#: reduce-scatter (n-1) x the shard (= (n-1)/n of the full buffer);
#: all-to-all (n-1)/n; broadcast 1
COLLECTIVE_FACTORS: Dict[str, Callable[[int], float]] = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n if n > 1 else 0.0,
    "all-gather": lambda n: (n - 1) / n if n > 1 else 0.0,
    "reduce-scatter": lambda n: float(n - 1) if n > 1 else 0.0,
    "all-to-all": lambda n: (n - 1) / n if n > 1 else 0.0,
    "collective-permute": lambda n: 1.0,
    "collective-broadcast": lambda n: 1.0,
}

#: ``_c10d_functional`` ops (what DTensor's redistributions issue) -> kind
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_result: float       # per-device result-buffer bytes
    group_size: int           # ranks in the group (the reference's n)
    wire_bytes: float         # bytes on the wire per device (ring factor)
    cross_pod_fraction: float = 0.0   # share of ring hops crossing pods

    @property
    def cross_pod_wire_bytes(self) -> float:
        return self.wire_bytes * self.cross_pod_fraction


@dataclasses.dataclass
class CollectiveSummary:
    ops: List[CollectiveOp]

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    @property
    def cross_pod_wire_bytes(self) -> float:
        return sum(o.cross_pod_wire_bytes for o in self.ops)

    def by_kind(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            cnt, byt = out.get(o.kind, (0, 0.0))
            out[o.kind] = (cnt + 1, byt + o.wire_bytes)
        return out


def cross_pod_fraction(ranks, pod_size: int) -> float:
    """Share of a ring's hops (rank i -> i + 1 in group order, wrap
    included) whose ends sit in different pods of ``pod_size`` ranks."""
    if pod_size <= 0 or len(ranks) < 2:
        return 0.0
    pods = np.asarray(ranks) // pod_size
    return float((pods != np.roll(pods, -1)).mean())


def _group_ranks(args) -> List[int]:
    """The global ranks of the group a functional collective names (its
    group name is its last string argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return dist.get_process_group_ranks(_resolve_process_group(name))


def _from_torch_distributed() -> bool:
    """Whether the op was called from ``torch.distributed``'s own Python
    (DTensor's shard-size and redistribution-cost arithmetic builds small
    real tensors and reads their values), not from the model's code: the
    innermost caller that is not torch's dispatch machinery decides."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_TORCH_DISTRIBUTED):
            return True
        if name != __file__ and not name.startswith(_TORCH):
            return False
        f = f.f_back
    return False


_TORCH = os.path.dirname(torch.__file__) + os.sep
_TORCH_DISTRIBUTED = os.path.join(_TORCH, "distributed", "")


def _is_meta_device(kwargs) -> bool:
    dev = kwargs.get("device")
    return dev is not None and torch.device(dev).type == "meta"


class MeshCounter(TorchDispatchMode):
    """Per-device F, B_M, collectives and peak live bytes of what runs
    under it (see the module docstring).

    ``fake_mode``: the ``FakeTensorMode`` that holds the shards when the
    run is a dry-run, or None for a run on real tensors.  In a dry-run the
    mode is *not* entered around the call (DTensor's sharding strategies
    for some layouts read values, which an active fake mode refuses):
    ops on the shards run fake because the shards are, and an op with no
    fake input (a factory such as ``torch.arange``, a ``torch.tensor``
    literal) is run under ``fake_mode`` here, so the model's masks and
    tables are fake too and nothing the size of a full-sequence mask is
    allocated.  DTensor's sharding propagation runs under a fake mode of
    its own, on meta tensors or that mode's fake tensors; those ops are run
    and not counted; so are the small real tensors DTensor's own Python
    builds for its shard arithmetic.  ``hold(tree)`` registers tensors that were alive before the block (the
    state, the batch) in the live bytes.
    """

    def __init__(self, fake_mode: Any = None, pod_size: int = 0):
        super().__init__()
        self.fake_mode = fake_mode
        self.pod_size = pod_size
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[CollectiveOp] = []
        self.live = 0
        self.peak = 0
        self._held: "weakref.WeakSet" = weakref.WeakSet()

    # -- live bytes --------------------------------------------------------
    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._held:
            return
        self._held.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def hold(self, tree: Any) -> None:
        """Count the tensors of ``tree`` (dicts, lists, tuples and
        NamedTuples such as ``TrainState``) as live."""
        from torch.distributed.tensor import DTensor
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for x in tree:
                self.hold(x)
        elif isinstance(tree, DTensor):
            self._track(tree._local_tensor)
        elif isinstance(tree, torch.Tensor):
            self._track(tree)

    # -- dispatch ----------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        """Whether the op runs on tensors that are not the run's own: meta
        tensors or another mode's fake tensors (DTensor's sharding
        propagation)."""
        from torch._subclasses.fake_tensor import FakeTensor
        for t in tensors:
            if isinstance(t, FakeTensor):
                if t.fake_mode is not self.fake_mode:
                    return True
            elif t.is_meta:
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar to local ops
        ins = [x for x in tree_leaves([list(args), dict(kwargs)])
               if isinstance(x, torch.Tensor)]
        active = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE)
        if ((active is not None and active is not self.fake_mode)
                or self._foreign(ins) or _is_meta_device(kwargs)):
            return func(*args, **kwargs)     # sharding propagation
        if self.fake_mode is not None and not any(
                isinstance(x, FakeTensor) for x in ins):
            if _from_torch_distributed():
                return func(*args, **kwargs)
            with self.fake_mode:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if self._foreign(outs):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _FUNCOL_KINDS.get(name)
            if kind is not None:
                ranks = _group_ranks(args)
                n = len(ranks)
                nbytes = float(sum(_nbytes(o) for o in outs))
                self.collectives.append(CollectiveOp(
                    kind=kind, bytes_result=nbytes, group_size=n,
                    wire_bytes=nbytes * COLLECTIVE_FACTORS[kind](n),
                    cross_pod_fraction=cross_pod_fraction(ranks,
                                                          self.pod_size)))
            if name == "wait_tensor":
                return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not (func.is_view or func in _ALIASES):
            self.bytes += sum(_nbytes(x) for x in ins + outs)
        returns = func._schema.returns
        fresh = (out,) if len(returns) == 1 else tuple(out)
        for r, o in zip(returns, fresh):
            if r.alias_info is None:
                for t in tree_leaves(o):
                    if isinstance(t, torch.Tensor):
                        self._track(t)
        return out

    @property
    def summary(self) -> CollectiveSummary:
        return CollectiveSummary(list(self.collectives))
