"""Assigned input-shape presets and the (arch × shape) applicability matrix,
copied from ``repro.configs.shapes``.

LM transformer shapes are seq_len × global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache / recurrent state of
seq_len), not ``train_step``.  ``long_500k`` requires sub-quadratic attention
and only runs for the SSM / hybrid families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: families whose decode state is constant-size (or window-bounded) — the
#: only ones assigned long_500k
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(arch_family: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_family in SUBQUADRATIC_FAMILIES
    return True


def cells(arch_family: str) -> Tuple[str, ...]:
    return tuple(s for s in SHAPES if applicable(arch_family, s))
