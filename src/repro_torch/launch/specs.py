"""Parameter counts and MODEL_FLOPS from the real constructors, on fake tensors.

The counting half of ``repro.launch.specs``: ``abstract_params(cfg)`` runs
the port's own ``init_*`` under ``torch._subclasses.fake_tensor
.FakeTensorMode``, so every leaf has the shape the runtime would build and
no leaf holds memory (qwen3-moe-30b-a3b's 122 GB of fp32 params count in
seconds on any host).  It takes the place of the reference's
``jax.eval_shape``: the counts can never drift from what the runtime
builds, and there is no second shape table.  ``param_counts`` /
``expert_param_counts`` classify each leaf by its path string, as the
reference does; ``model_flops`` is the 6·N·D (train) / 2·N·D (serve)
accounting of the §Roofline useful-flops ratio.

The sharded half is the dry-run's contract.  ``input_specs`` /
``decode_input_specs`` give the batch a step consumes, ``abstract_params`` /
``abstract_train_state`` / ``abstract_cache`` the params, the train state and
the decode cache, all from the real constructors, as fake tensors (one
``FakeTensorMode`` for a whole dry-run: the active one, or a new one per
call).  ``attach`` lays a fake tree out on a mesh by its logical specs
(``train_state_specs``, ``cache_logical_specs``, ``model_param_specs``):
fake DTensors on a ``DeviceMesh``, ``Abstract`` records (shape, dtype,
placements, local shape) on an ``AbstractMesh``.  Where the reference
stacks a model's blocks on a leading ``"layers"`` axis the port keeps a list
of per-layer trees, so its specs have no ``"layers"`` entry, and its leaves
have no layer dim.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Iterator, Mapping, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map


def fake_tensors(like: Any = None):
    """A context in which new tensors are fake: the active
    ``FakeTensorMode`` if there is one (so every tree of a dry-run shares
    it), else the mode of ``like``'s fake leaves, else a new one."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    for leaf in tree_leaves(like):
        if isinstance(leaf, FakeTensor):
            return leaf.fake_mode
    return FakeTensorMode()


def abstract_params(cfg: ModelConfig) -> Any:
    """The param tree ``init_*`` builds for ``cfg``, as fake tensors.

    The draws run on a CPU generator with ``device="cpu"``, so counting
    never touches (or initialises) a card.
    """
    from repro_torch.models import encdec, mlp_dlrm, transformer, vlm
    init = {"encdec": encdec.init_encdec, "vlm": vlm.init_vlm,
            "mlp": mlp_dlrm.init_mlp}.get(cfg.family, transformer.init_lm)
    with fake_tensors():
        return init(cfg, torch.Generator(), device="cpu")


def abstract_train_state(cfg: ModelConfig, optimizer) -> Any:
    """``init_train_state``'s ``TrainState`` for ``cfg``, as fake tensors
    (its ``rng`` a real CPU generator)."""
    from repro_torch.train.loop import init_train_state
    with fake_tensors():
        return init_train_state(torch.Generator(), cfg, optimizer,
                                device="cpu")


def abstract_cache(cfg: ModelConfig, params_abs: Any, shape: ShapeSpec
                   ) -> Any:
    """``serve.engine.init_cache`` for the shape's batch and length, as fake
    tensors; an enc-dec cache runs the encoder on fake frames."""
    from repro_torch.serve import engine
    B, S = shape.global_batch, shape.seq_len
    with fake_tensors(params_abs):
        frames = (torch.empty((B, cfg.encoder_seq, cfg.d_model))
                  if cfg.family == "encdec" else None)
        return engine.init_cache(params_abs, cfg, B, S, frames=frames)


# --- sharding attachment --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf laid out on an ``AbstractMesh``: the reference's sharded
    ``ShapeDtypeStruct``, with DTensor placements and the local shard."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: sh.Spec
    placements: Tuple
    local_shape: Tuple[int, ...]


def _contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _laid_out(shape: Tuple[int, ...], dtype: torch.dtype, mesh,
              axes) -> Any:
    """A fake tensor of ``shape`` laid out by the logical ``axes`` under the
    active binding (the axes that do not divide dropped)."""
    shape = tuple(shape)
    spec = sh._drop_nondividing(sh.logical_spec(axes), shape, mesh)
    placements = sh.to_placements(spec, mesh)
    local = sh.local_shape(shape, spec, mesh)
    if isinstance(mesh, AbstractMesh):
        return Abstract(shape, dtype, spec, placements, local)
    from torch.distributed.tensor import DTensor
    with fake_tensors():
        return DTensor.from_local(
            torch.empty(local, dtype=dtype),
            mesh, placements,
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous_stride(shape))


def _sds(shape, dtype, mesh, axes) -> Any:
    if mesh is None:
        with fake_tensors():
            return torch.empty(shape, dtype=dtype)
    return _laid_out(shape, dtype, mesh, axes)


def input_axes(cfg: ModelConfig) -> Dict[str, sh.Spec]:
    """The logical axes of each input of a train / prefill batch."""
    if cfg.family == "mlp":
        return {"features": ("batch", None), "click": ("batch",)}
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "encdec":
        out["frames"] = ("batch", "seq", "embed")
    if cfg.family == "vlm":
        out["patches"] = ("batch", "seq", None)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None
                ) -> Dict[str, Any]:
    """Training / prefill batch stand-ins keyed by family: fake tensors, or
    laid out on ``mesh`` under the active rules.  Token ids are int64, the
    dtype ``data.pipeline.to_device`` gives them."""
    B, S = shape.global_batch, shape.seq_len
    axes = input_axes(cfg)
    if cfg.family == "mlp":
        shapes = {"features": ((B, cfg.mlp_widths[0]), torch.float32),
                  "click": ((B,), torch.float32)}
    else:
        shapes = {"tokens": ((B, S), torch.int64),
                  "labels": ((B, S), torch.int64)}
        if cfg.family == "encdec":
            shapes["frames"] = ((B, cfg.encoder_seq, cfg.d_model),
                                torch.float32)
        if cfg.family == "vlm":
            shapes["patches"] = ((B, cfg.visual_tokens, cfg.visual_width),
                                 torch.float32)
    return {k: _sds(s, dt, mesh, axes[k]) for k, (s, dt) in shapes.items()}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None
                       ) -> Dict[str, Any]:
    """One decode step's tokens (B, 1) and its position.  The port's
    ``decode_step`` takes ``pos`` as a Python int (the reference traces it
    as a scalar); the last row of the cache, ``seq_len - 1``, costs what any
    row does, since decode attends over the whole ``S_max``."""
    B = shape.global_batch
    return {"tokens": _sds((B, 1), torch.int64, mesh, ("batch", None)),
            "pos": shape.seq_len - 1}


def attach(tree_abs: Any, specs: Any, mesh) -> Any:
    """Zip a fake tree with a logical-spec tree under the active binding.

    Mesh axes that don't divide a dimension are dropped per dim (odd vocab
    sizes, 60-expert MoE, 9-head attention are the norm in the assigned
    configs; dropping to replication is the standard fallback).  A leaf
    that is no tensor (the train state's generator) passes unchanged.
    """
    def one(axes, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return _laid_out(tuple(leaf.shape), leaf.dtype, mesh, axes)

    return sh.map_specs(one, specs, tree_abs)


def _augment_data_axis(pspecs: Any) -> Any:
    """ZeRO-style: additionally shard the first free dim over "dp_shard".

    "dp_shard" is a logical alias the launcher maps to the data axis; dims
    that don't divide fall back to replication inside ``attach``.  Tensors
    with no free dim (MoE expert weights: experts x embed x expert_ffn)
    donate their "embed" dim: embed is replicated by the activation rules,
    so DP-sharding it on the *storage* side is always safe.
    """
    def one(axes):
        axes = tuple(axes)
        for i, a in enumerate(axes):
            if a is None:
                return axes[:i] + ("dp_shard",) + axes[i + 1:]
        for i, a in enumerate(axes):
            if a == "embed":
                return axes[:i] + ("dp_shard",) + axes[i + 1:]
        return axes

    return sh.map_specs(one, pspecs)


def train_state_specs(cfg: ModelConfig, zero1: bool = True,
                      fsdp: bool = False) -> Any:
    """Logical-axis tree matching ``TrainState`` (params + AdamW mu/nu).

    ``zero1`` (baseline default): optimizer moments additionally sharded
    over the DP axis; the train step reduces each gradient into its
    moments' layout (a reduce-scatter) and gathers the updated params back
    to theirs.  ``fsdp``: the parameters themselves also DP-sharded
    (ZeRO-3-style).
    """
    from repro_torch.optim.optimizer import AdamWState
    from repro_torch.train.loop import TrainState, model_param_specs
    pspecs = model_param_specs(cfg)
    popt = _augment_data_axis(pspecs) if (zero1 or fsdp) else pspecs
    pmain = _augment_data_axis(pspecs) if fsdp else pspecs
    return TrainState(params=pmain,
                      opt_state=AdamWState(step=(), mu=popt, nu=popt),
                      step=(), rng=(None,))


def cache_logical_specs(cfg: ModelConfig, cache_abs: Any) -> Any:
    """Logical axes for the decode cache: rank-driven defaults.

    KV buffers (L,B,S,K,dh) or (B,S,K,dh) shard batch over DP and expose
    both "kv_seq" and "head_dim" axes; the serve rules map kv_seq -> model
    (SP-decode), and under a mesh ``attention.write_row`` writes the new
    row into the one shard that holds it.

    Recurrent states (B,H,dk,dv)/(B,H,dk)/(B,D) -> batch (+ heads).
    """
    def axes_for(leaf):
        r = len(leaf.shape)
        if r == 5:
            return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        if r == 4:
            # (B,S,K,dh) kv or (B,H,dk,dv) state: kv if dim1 large
            if leaf.shape[1] > 64:
                return ("batch", "kv_seq", "kv_heads", "head_dim")
            return ("batch", "heads", None, None)
        if r == 3:
            return ("batch", "heads", None)
        if r == 2:
            return ("batch", None)
        return tuple([None] * r)

    return tree_map(axes_for, cache_abs)


def _leaves_with_paths(tree: Any, prefix: str = ""
                       ) -> Iterator[Tuple[str, Any]]:
    """(``"a/b/0/c"``, leaf) in ``tree_leaves`` order: dict keys sorted,
    list entries by index (the reference's stacked layer axis is the port's
    list, so its index joins the path and no key name changes)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}")
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix[1:], tree


def _numel(leaf) -> float:
    n = 1.0
    for d in leaf.shape:
        n *= d
    return n


def _is_routed_expert(keys: str) -> bool:
    return (any(k in keys for k in ("w_gate", "w_up", "w_down"))
            and "moe" in keys and "shared" not in keys)


# --- MODEL_FLOPS accounting ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active-per-token) parameter counts from abstract shapes.

    Active excludes the embedding gather but includes the LM head matmul;
    MoE expert tensors count at top_k / max(n_experts, pad_experts_to) (the
    tensors hold the padded count; padding experts never receive routing
    mass), shared experts fully.  Memoized on the (frozen, hashable) config:
    the fake-tensor init runs once per model per process.
    """
    total = 0.0
    active = 0.0
    for keys, leaf in _leaves_with_paths(abstract_params(cfg)):
        n = _numel(leaf)
        total += n
        if "embed" in keys and "lm_head" not in keys and "pos" not in keys:
            if cfg.tie_embeddings and not cfg.family == "mlp":
                active += n       # tied head matmul
            continue              # gather costs ~0 flops
        if "pos_embed" in keys or "dec_pos" in keys:
            continue
        if _is_routed_expert(keys):
            active += n * cfg.moe_top_k / max(cfg.n_experts,
                                              cfg.pad_experts_to, 1)
            continue
        active += n
    return total, active


@functools.lru_cache(maxsize=None)
def expert_param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) parameters of the *routed* expert tensors only.

    The slice of :func:`param_counts` that an expert-parallel axis shards:
    routed ``w_gate``/``w_up``/``w_down`` at their padded allocation,
    excluding the router and shared experts (those replicate over ep).
    Non-MoE configs return ``(0.0, 0.0)``.
    """
    if cfg.n_experts <= 0:
        return 0.0, 0.0
    total = 0.0
    for keys, leaf in _leaves_with_paths(abstract_params(cfg)):
        if _is_routed_expert(keys):
            total += _numel(leaf)
    active = total * cfg.moe_top_k / max(cfg.n_experts,
                                         cfg.pad_experts_to, 1)
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for serve decode."""
    _, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per seq
