"""Architecture registry: the 10 assigned archs + the paper's case study.

Data only, copied from ``repro.configs`` with the port's ``ModelConfig``,
with the assigned input shapes of ``configs.shapes``.
"""
from typing import Dict, List, Tuple

from repro_torch.configs import (dlrm_mlp, hymba_1_5b, internvl2_26b,
                                 minitron_8b, qwen2_5_3b, qwen2_7b,
                                 qwen2_moe_a2_7b, qwen3_moe_30b_a3b,
                                 smollm_135m, whisper_tiny, xlstm_125m)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, cells
from repro_torch.models.config import ModelConfig

_MODULES = [whisper_tiny, qwen2_5_3b, minitron_8b, smollm_135m, qwen2_7b,
            qwen2_moe_a2_7b, qwen3_moe_30b_a3b, xlstm_125m, internvl2_26b,
            hymba_1_5b, dlrm_mlp]

REGISTRY: Dict[str, "module"] = {m.ARCH: m for m in _MODULES}

#: the 10 assigned architectures (dlrm-mlp is the paper's own, extra)
ASSIGNED: Tuple[str, ...] = tuple(m.ARCH for m in _MODULES[:-1])


def get_config(arch: str) -> ModelConfig:
    return REGISTRY[arch].config()


def get_reduced(arch: str) -> ModelConfig:
    return REGISTRY[arch].reduced()


def list_archs() -> List[str]:
    return list(REGISTRY)
