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

The sharded half (``input_specs(mesh=…)``, ``attach``,
``train_state_specs``, ``cache_logical_specs``, ``abstract_cache``,
``abstract_train_state``) comes with the mesh (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import functools
from typing import Any, Iterator, Mapping, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig


def abstract_params(cfg: ModelConfig) -> Any:
    """The param tree ``init_*`` builds for ``cfg``, as fake tensors.

    The draws run on a CPU generator with ``device="cpu"``, so counting
    never touches (or initialises) a card.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import encdec, mlp_dlrm, transformer, vlm
    init = {"encdec": encdec.init_encdec, "vlm": vlm.init_vlm,
            "mlp": mlp_dlrm.init_mlp}.get(cfg.family, transformer.init_lm)
    with FakeTensorMode():
        return init(cfg, torch.Generator(), device="cpu")


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
