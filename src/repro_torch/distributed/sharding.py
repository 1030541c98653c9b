"""Logical-axis sharding: rules mapping model axes -> mesh axes -> DTensor
placements, as ``repro.distributed.sharding``.

Models annotate params (``*_specs`` trees of logical-axis tuples) and
activations (``shard_hint``) with *logical* names; this module binds them to
mesh axes at launch time.  Outside an active binding ``shard_hint`` is the
identity, so all model code runs unmodified on one device and under any
mesh.

Default rules (the reference's baseline scheme):

  batch   -> ("pod", "data")   DP over pods and the data axis
  q_proj / kv_proj / heads / ffn / experts / vocab -> "model"   TP / EP
  embed   -> None (replicated activations dim)
  seq     -> None (SP variants map it to "model" for long-context shapes)
  layers / kv_seq -> None

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: ``None``, a mesh axis (``"model"``) or a tuple of mesh axes
(``("pod", "data")``).  ``to_placements`` turns it into DTensor placements,
one per mesh dim: ``Shard(d)`` on every mesh axis of more than one device
that shards tensor dim ``d``, ``Replicate()`` on the others.  A dim sharded over several axes
takes them in mesh order, which is the reference's shard layout when the
spec lists them in mesh order (every rule here does).

Where the reference's functions take a jax ``Mesh`` these take a
``DeviceMesh`` or a ``launch.mesh.AbstractMesh``; ``mesh.axis_sizes`` reads
either.  ``shard_hint`` is the counterpart of ``with_sharding_constraint``:
inside a binding a DTensor is redistributed to the hinted placements; a
plain tensor (one device, or the card's local tensors) passes unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import axis_names, axis_sizes, mesh_size

AxisName = Union[str, Tuple[str, ...], None]
Rules = Mapping[str, AxisName]
Spec = Tuple[AxisName, ...]

DEFAULT_RULES: Dict[str, AxisName] = {
    "batch": ("pod", "data"),
    "seq": None,
    "attn_seq": None,   # SP fallback for attention internals
    "embed": None,
    "q_proj": "model",
    "kv_proj": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,     # swapped with "experts" when E % model_size != 0
    "vocab": "model",
    "layers": None,
    "kv_seq": None,
    "head_dim": None,     # decode-cache dh sharding
    "dp_shard": ("pod", "data"),   # ZeRO/FSDP param & moment sharding
}

_state = threading.local()


def _active() -> Optional[Tuple[Any, Rules]]:
    return getattr(_state, "binding", None)


def bound_mesh() -> Any:
    """The mesh of the active ``use_sharding`` binding, or None."""
    binding = _active()
    return None if binding is None else binding[0]


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Rules] = None):
    """Bind a mesh + logical rules for the block; yields the rules in
    force.  Rule entries naming axes the mesh lacks are dropped (a
    single-pod mesh has no ``"pod"`` axis)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    names = set(axis_names(mesh))

    def _filter(axis: AxisName) -> AxisName:
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a in names)
            return kept if kept else None
        return axis if (axis is None or axis in names) else None

    rules = {k: _filter(v) for k, v in rules.items()}
    prev = _active()
    _state.binding = (mesh, rules)
    try:
        yield rules
    finally:
        _state.binding = prev


def logical_spec(axes: Sequence[Optional[str]],
                 rules: Optional[Rules] = None) -> Spec:
    """Map a tuple of logical axis names to a spec.

    A mesh axis may appear at most once in a spec; when two logical axes
    map to the same mesh axis (e.g. seq and vocab both -> "model" under
    sequence parallelism), the first keeps it and later ones drop to None.
    """
    binding = _active()
    if rules is None:
        if binding is None:
            return ()
        rules = binding[1]
    used: set = set()
    out = []
    for a in axes:
        m = rules.get(a) if a is not None else None
        names = m if isinstance(m, tuple) else (m,) if m else ()
        if any(n in used for n in names):
            out.append(None)
            continue
        used.update(names)
        # a one-axis tuple is that axis, as a PartitionSpec canonicalises it
        out.append(names[0] if len(names) == 1 else m)
    return tuple(out)


def _extent(entry: AxisName, sizes: Mapping[str, int]) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[n] for n in names)


def _drop_nondividing(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Replace spec entries whose mesh extent doesn't divide the dim size;
    the result has one entry per dim."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        out.append(None if entry is None or dim % _extent(entry, sizes)
                   else entry)
    return tuple(out)


def to_placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements of ``spec``: one per mesh dim, ``Shard(d)`` on the
    axes that shard tensor dim ``d``, ``Replicate()`` elsewhere.

    A mesh axis of one device shards nothing, so it is ``Replicate()``
    whatever the spec names: the shard is the whole dim either way.  A
    ``Shard`` there made torch 2.11's view rules refuse to flatten the dim
    with another (the SSD decode state's ``einsum`` views (batch, heads) as
    one dim: hymba's decode at 1x1) and cost a copy per no-op move."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard one device holds of a ``shape`` tensor laid out by
    ``spec`` (whose entries divide their dims)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d if e is None else d // _extent(e, sizes)
                 for d, e in zip(shape, spec))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the reference's ``NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return to_placements(self.spec, self.mesh)


def is_spec(x: Any) -> bool:
    """A logical spec: a tuple of axis names (``None`` for a free dim)."""
    return type(x) is tuple and all(a is None or isinstance(a, str)
                                    for a in x)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_specs(fn: Callable, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure
    (dicts by the spec's keys, lists, and NamedTuples such as
    ``TrainState``, field by field); a spec tuple is a leaf."""
    if is_spec(specs):
        return fn(specs, *trees)
    if isinstance(specs, Mapping):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if _is_namedtuple(specs):
        return type(specs)(*(map_specs(fn, s, *(t[i] for t in trees))
                             for i, s in enumerate(specs)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, s, *(t[i] for t in trees))
                           for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree: {specs!r}")


def shard_hint(x: Any, axes: Sequence[Optional[str]]) -> Any:
    """``with_sharding_constraint`` against the active binding: a DTensor
    is redistributed to the hinted placements; a plain tensor, or any
    tensor outside a binding, passes unchanged.

    Axes whose mesh extent doesn't divide the dimension are dropped
    (replicated) rather than erroring, as in the reference.
    """
    binding = _active()
    if binding is None or not isinstance(x, DTensor):
        return x
    mesh, rules = binding
    spec = _drop_nondividing(logical_spec(axes, rules), tuple(x.shape), mesh)
    return move(x, to_placements(spec, mesh))


def move(x: DTensor, placements: Sequence) -> DTensor:
    """``x.redistribute`` to ``placements``, a change of which tensor dim a
    mesh dim shards done by all-to-all on any mesh (``_all_to_all``)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    moved = _all_to_all(x, placements)
    if moved is not None:
        return moved
    return x.redistribute(x.device_mesh, placements)


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        place = tuple(Replicate() if p.is_partial() else p
                      for p in g.placements)
        if place == tuple(g.placements):
            return g
        return g.redistribute(g.device_mesh, place)


def whole_grad(x: Any) -> Any:
    """``x``, whose grad is made whole (a partial sum reduced) before it
    reaches the ops that made ``x``: a shard-level product hands back
    partial-sum grads, which DTensor's rules for some ops cannot take (they
    shard the result unevenly).  Anything but a DTensor is ``x``."""
    if not isinstance(x, DTensor):
        return x
    return _WholeGrad.apply(x)


def whole_rows(x: Any) -> Any:
    """A decode step's residual or branch output (B, 1, D) laid out as its
    embedding is: each data device its rows, whole on every other axis.  A
    row-parallel product leaves it a partial sum; made whole once here,
    every norm and product that reads it runs on each device's own copy.
    Left partial, torch 2.13's DTensor reduce-scattered it at each norm
    and made the normed rows whole again for each product that reads them
    (q, k and v each, the FFN's gate and up each)."""
    return shard_hint(x, ("batch", None, "embed"))


def sp_matmul(x: Any, w: Any) -> Any:
    """``x @ w`` for an activation x (..., D) and a weight w (D, F), each
    device multiplying its own shards.

    DTensor would flatten x's leading axes into rows, which it cannot do
    while two of them are sharded (the sequence-parallel rules shard batch
    and seq) and, in some torch versions, cannot undo in the backward.  So
    for a DTensor x the product is laid out here, mesh axis by mesh axis,
    from w's placement: against a column shard of w (``Shard(1)``) x's
    shards on that axis are gathered (Megatron-SP's entry all-gather), and
    the output is sharded on its last axis; against a row shard
    (``Shard(0)``) x is sharded on D and the output is a partial sum;
    against a replicated w, x keeps its leading shards and the output
    takes them.  The local product then runs on the shards, and the grads
    of x's and w's shards are handed back with the placements that product
    gives them (a partial sum where the other operand was sharded and
    this one was not).  Anything but a DTensor x is ``x @ w``.
    """
    if not isinstance(x, DTensor):
        return x @ w
    last = x.ndim - 1
    x_to, out, gx, gw = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if pw == Shard(1):                      # column-parallel
            x_to.append(Replicate())
            out.append(Shard(last))
            gx.append(Partial())
            gw.append(pw)
        elif pw == Shard(0):                    # row-parallel
            x_to.append(Shard(last))
            out.append(Partial())
            gx.append(Shard(last))
            gw.append(pw)
        else:
            lead = isinstance(px, Shard) and px.dim < last
            x_to.append(px if lead else Replicate())
            out.append(px if lead else Replicate())
            gx.append(x_to[-1])
            gw.append(Partial() if lead else Replicate())
    if tuple(x_to) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, x_to)
    y = x.to_local(grad_placements=gx) @ w.to_local(grad_placements=gw)
    return DTensor.from_local(y, x.device_mesh, out, run_check=False)


def _local_numel(t: DTensor) -> int:
    """Elements of one device's shard of ``t`` (its dims divided evenly)."""
    mesh = t.device_mesh
    return math.prod(t.shape) // math.prod(
        mesh.size(i) for i, p in enumerate(t.placements)
        if isinstance(p, Shard))


def _weight_gathers(x: Any, w: Any, bias: Any
                    ) -> Optional[Tuple[list, list, list]]:
    """The plan of ``tokens_matmul``: (the mesh dims on which w is
    gathered, w's grad placements, the bias's), or None where the product
    keeps ``sp_matmul``'s form."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and (bias is None or isinstance(bias, DTensor))):
        return None
    last = x.ndim - 1
    pb = (bias.placements if bias is not None
          else (Replicate(),) * len(w.placements))
    gather, gw, gb = [], [], []
    for px, pw, p in zip(x.placements, w.placements, pb):
        if not (px.is_replicate() or isinstance(px, Shard)
                and px.dim < last) or isinstance(pw, Partial):
            return None                 # x's channels split, or a partial
        tokens = isinstance(px, Shard)
        if isinstance(pw, Shard):
            # a weight split where x's batch is (FSDP's layout), or where
            # x's tokens are whole (tensor parallelism), keeps sp_matmul
            if not tokens or px.dim == 0:
                return None
            gather.append(len(gw))
            column = pw.dim == 1
            if not (p.is_replicate() or column and p == Shard(0)):
                return None
            gb.append(p if column and isinstance(p, Shard) else Partial())
        elif not p.is_replicate():
            return None
        else:
            gb.append(Partial() if tokens else p)
        gw.append(pw if isinstance(pw, Shard) else
                  Partial() if tokens else pw)
    if not gather:
        return None
    # the bytes each device receives, axis by axis in the order they run:
    # w gathered, against what sp_matmul moves there (x's tokens gathered,
    # and against a row shard the partial output's reduction too)
    mesh = x.device_mesh
    wb = _local_numel(w) * w.element_size()
    xb = _local_numel(x) * x.element_size()
    yb = xb // x.shape[-1] * w.shape[1]
    w_in = x_in = 0
    for i in reversed(gather):
        n = mesh.size(i)
        w_in += wb * (n - 1)
        x_in += (xb + (yb if w.placements[i].dim == 0 else 0)) * (n - 1)
        wb, xb, yb = wb * n, xb * n, yb * n
    return (gather, gw, gb) if w_in < x_in else None


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` gathered along ``dim`` over ``group`` (a mesh and one of its
    dims), differentiably.  Torch 2.11's all-gather takes a contiguous
    input only: a transposed matrix (the tied head, ``embed.T``) gathers
    its contiguous transpose, with no copy."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd          # torch 2.11's name
    if t.ndim == 2 and not t.is_contiguous() and t.T.is_contiguous():
        return gather(t.T, 1 - dim, group).T
    return gather(t.contiguous(), dim, group)


def tokens_matmul(x: Any, w: Any, bias: Any = None) -> Any:
    """``x @ w (+ bias)`` for an activation x (..., D), a weight w (D, F)
    and a bias (F,), each device multiplying its own tokens by the
    gathered weight, as the reference's XLA lays out these products.

    Where a mesh axis shards x's tokens (a leading dim: the sequence under
    the sequence-parallel rules) and w (its rows or its columns),
    ``sp_matmul`` moves the activation: it gathers x's tokens against a
    column shard, and moves x onto its channels against a row shard,
    leaving a partial sum to reduce.  Here w is gathered along its sharded
    dim on that axis instead (innermost axis first: DTensor nests the
    shards of one dim in mesh order), so each device multiplies its own
    tokens by the whole weight and the output keeps x's placements.  A
    bias sharded with w's columns is gathered with them.  w's grad on that
    axis is each device's partial sum, reduce-scattered onto w's shards by
    the gather's backward; on an axis where w is replicated it is what
    ``sp_matmul`` hands back (a partial sum where x's tokens are split).

    The weight form is taken only where the weight's bytes gathered are
    fewer than the activation's that ``sp_matmul`` would move (x's tokens
    gathered; against a row shard, its partial output reduced).  Any other
    layout keeps ``sp_matmul``, the bias added to its output: decode's
    (B, 1, D) rows, whose tokens no axis splits; plain tensors (one device:
    ``place`` lays out nothing on a mesh of one); FSDP's weights, split
    over the batch's devices; a partial x.
    """
    plan = _weight_gathers(x, w, bias)
    if plan is None:
        y = sp_matmul(x, w)
        return y if bias is None else y + bias.to(y.dtype)
    gather, gw, gb = plan
    mesh = x.device_mesh
    wl = w.to_local(grad_placements=gw)
    bl = None if bias is None else bias.to_local(grad_placements=gb)
    for i in reversed(gather):
        wl = _gather(wl, w.placements[i].dim, (mesh, i))
        if bl is not None and isinstance(bias.placements[i], Shard):
            bl = _gather(bl, 0, (mesh, i))
    y = x.to_local(grad_placements=x.placements) @ wl
    if bl is not None:
        y = y + bl.to(y.dtype)
    out = torch.empty(tuple(x.shape[:-1]) + (w.shape[1],), device="meta")
    return DTensor.from_local(y, mesh, x.placements, run_check=False,
                              shape=out.shape, stride=out.stride())


def sp_embedding(ids: Any, table: Any) -> Any:
    """``F.embedding(ids, table)``, each device looking up in its own rows.

    For a DTensor table sharded on its vocab rows (the ``vocab`` rule),
    every device takes the ids of its batch rows whole (their sequence
    gathered), looks up the ids that fall in its rows, zeroes the others,
    and the output is a partial sum over the vocab's mesh axes: the
    vocab-parallel embedding, laid out here because DTensor's own (a
    masked partial) does not survive a table that is also the tied head.
    Anything but a DTensor table is ``F.embedding``.
    """
    import torch.nn.functional as F
    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    ids = replicate_inner(ids)
    id_place = (ids.placements if isinstance(ids, DTensor)
                else (Replicate(),) * mesh.ndim)
    lo, rows = 0, table.shape[0]
    out, grad = [], []
    for i, (pt, pi) in enumerate(zip(table.placements, id_place)):
        if pt == Shard(0):
            rows //= mesh.size(i)
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
            out.append(Partial())
            grad.append(pt)
        else:
            out.append(pi)
            grad.append(Partial() if isinstance(pi, Shard) else pt)
    local = ids.to_local() if isinstance(ids, DTensor) else ids
    local = local - lo * rows
    hit = (local >= 0) & (local < rows)
    y = F.embedding(torch.where(hit, local, 0),
                    table.to_local(grad_placements=grad))
    y = y * hit[..., None].to(y.dtype)
    return DTensor.from_local(y, mesh, out, run_check=False)


def replicate_inner(x: Any) -> Any:
    """A DTensor with every axis but the batch (dim 0) and the last
    gathered; anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1 if x.ndim > 2 else x.ndim
    placements = tuple(Replicate() if isinstance(p, Shard)
                       and 0 < p.dim < last else p for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _all_to_all(x: DTensor, placements: Tuple) -> Optional[DTensor]:
    """``x`` moved to ``placements`` by one all-to-all per mesh dim, where
    the only change is which tensor dim a mesh dim shards; None otherwise,
    and None where another mesh dim shards either of the two tensor dims
    unless it comes earlier in the mesh and keeps its placement: DTensor
    nests the shards of one tensor dim in mesh order, so an earlier mesh
    dim's shard is the whole that the moving one splits or joins (the
    batch, sharded on the data axis, taking the model axis too: (Shard(0),
    Shard(1)) to (Shard(0), Shard(0))).

    DTensor's redistribute does this by all-to-all on a CUDA mesh, but on
    any CPU mesh it all-gathers the whole tensor and keeps a chunk (it
    takes gloo to have no all-to-all), which moves n times the bytes
    through a full-size buffer.  So on a CPU mesh the exchange is done
    here, through the differentiable functional all-to-all, which gloo and
    the dry-run's fake backend both run.
    """
    from torch.distributed import _functional_collectives as funcol

    mesh = x.device_mesh
    src = tuple(x.placements)
    moves = [i for i, (a, b) in enumerate(zip(src, placements)) if a != b]
    if mesh.device_type != "cpu" or not all(
            isinstance(src[i], Shard) and isinstance(placements[i], Shard)
            for i in moves):
        return None
    for i in moves:
        dims = (src[i].dim, placements[i].dim)
        for j in range(len(src)):
            touches = any(isinstance(p, Shard) and p.dim in dims
                          for p in (src[j], placements[j]))
            if j != i and touches and (j > i or src[j] != placements[j]):
                return None
    local = x.to_local()
    for i in moves:
        a, b, n = src[i].dim, placements[i].dim, mesh.size(i)
        send = torch.stack(local.chunk(n, dim=b))      # piece j -> peer j
        got = funcol.all_to_all_single_autograd(send, None, None, (mesh, i))
        local = torch.cat(got.unbind(0), dim=a)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def specs_to_shardings(specs: Any, mesh, rules: Optional[Rules] = None
                       ) -> Any:
    """Map a tree of logical-axis tuples to ``NamedSharding``s (the spec as
    the rules give it; ``place`` drops what does not divide a leaf)."""
    binding = _active()
    rules = rules or (binding[1] if binding else DEFAULT_RULES)
    return map_specs(lambda axes: NamedSharding(mesh, logical_spec(axes, rules)),
                     specs)


def validate_divisibility(shapes: Any, shardings: Any) -> None:
    """Raise early (with a useful message) when a dim doesn't divide."""
    def check(sh, arr):
        shape = getattr(arr, "shape", None)
        if shape is None or not isinstance(sh, NamedSharding):
            return None
        sizes = axis_sizes(sh.mesh)
        for dim, entry in zip(shape, sh.spec):
            if entry is None:
                continue
            size = _extent(entry, sizes)
            if dim % size:
                names = entry if isinstance(entry, tuple) else (entry,)
                raise ValueError(
                    f"dim {dim} not divisible by mesh extent {size} "
                    f"({names}) for shape {tuple(shape)}")
        return None

    _map_shardings(check, shardings, shapes)


def _map_shardings(fn: Callable, shardings: Any, *trees: Any) -> Any:
    """``fn(sharding, *leaves)`` over a tree of ``NamedSharding`` leaves."""
    if isinstance(shardings, NamedSharding) or shardings is None:
        return fn(shardings, *trees)
    if isinstance(shardings, Mapping):
        return {k: _map_shardings(fn, v, *(t[k] for t in trees))
                for k, v in shardings.items()}
    if _is_namedtuple(shardings):
        return type(shardings)(*(_map_shardings(fn, s, *(t[i] for t in trees))
                                 for i, s in enumerate(shardings)))
    return type(shardings)(_map_shardings(fn, s, *(t[i] for t in trees))
                           for i, s in enumerate(shardings))


def gqa_safe_rules(n_kv_heads: int, mesh,
                   base: Optional[Rules] = None) -> Dict[str, AxisName]:
    """Drop kv_proj/kv_heads TP when kv heads don't divide the model axis."""
    rules = dict(DEFAULT_RULES, **(base or {}))
    model_size = axis_sizes(mesh).get("model", 1)
    if n_kv_heads % max(model_size, 1):
        rules["kv_proj"] = None
        rules["kv_heads"] = None
    return rules


def cli_rules(cfg, mesh) -> Dict[str, AxisName]:
    """The reference CLIs' GQA-safe rules, with the q heads replicated too
    where they do not divide the model axis: DTensor cannot split a
    sharded q projection into heads that do not divide it (GSPMD pads)."""
    rules = gqa_safe_rules(cfg.n_kv_heads, mesh)
    if cfg.n_heads % axis_sizes(mesh).get("model", 1):
        rules["heads"] = rules["q_proj"] = None
    return rules

def place(x: Any, sharding: Optional[NamedSharding]) -> Any:
    """``x`` laid out by ``sharding`` on its mesh, the spec's entries that
    do not divide ``x`` dropped: a DTensor holding this rank's shard (each
    rank slices the full ``x`` it holds; nothing is sent).  A mesh of one
    device places nothing: ``x`` stays the local tensor it is, so the
    card's kernels see what they see without a mesh.  A non-tensor (a
    generator) or a ``None`` sharding passes unchanged."""
    if sharding is None or not isinstance(x, torch.Tensor):
        return x
    mesh = sharding.mesh
    if mesh_size(mesh) == 1:
        return x
    spec = _drop_nondividing(sharding.spec, tuple(x.shape), mesh)
    return distribute_tensor(x, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``place`` leaf by leaf over a tree and its sharding tree."""
    return _map_shardings(lambda sh, x: place(x, sh), shardings, tree)
