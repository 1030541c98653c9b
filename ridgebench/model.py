"""The port's ``ModelConfig`` for a configuration's file.

The file states the model as it is run (``configs/<name>.json``): its
published keys, and under ``port`` the family, the dtypes, the kernel
flags and the port's own settings.  ``model_config`` maps them onto the
port's fields; a caller may override fields (the tests run the port's
plain float32 path).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(doc: Dict, **override) -> ModelConfig:
    port = doc["port"]
    fields = dict(
        name=port["arch"], family=port["family"],
        n_layers=doc["num_hidden_layers"], d_model=doc["hidden_size"],
        n_heads=doc["num_attention_heads"],
        n_kv_heads=doc["num_key_value_heads"],
        d_ff=doc["intermediate_size"], vocab_size=doc["vocab_size"],
        norm_eps=doc["rms_norm_eps"], rope_theta=doc["rope_theta"],
        tie_embeddings=doc["tie_word_embeddings"],
        compute_dtype=DTYPES[port["compute_dtype"]],
        param_dtype=DTYPES[port["param_dtype"]],
        use_flash=port["use_flash"],
        use_kernel_matmul=port["use_kernel_matmul"],
        qkv_bias=port.get("qkv_bias", False),
        n_experts=doc["num_experts"],
        n_shared_experts=(doc["shared_expert_intermediate_size"]
                          // doc["moe_intermediate_size"]),
        moe_top_k=doc["num_experts_per_tok"],
        moe_d_ff=doc["moe_intermediate_size"],
        capacity_factor=port["capacity_factor"],
        moe_group_tokens=port["moe_group_tokens"],
        router_aux_weight=doc["router_aux_loss_coef"])
    fields.update(override)
    return ModelConfig(**fields)
