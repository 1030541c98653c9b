"""FLOPs and bytes of the MoE decoder LM, from the configuration's file.

Model FLOPs count each product once at 2 x its multiply-adds: the weights a
token uses (in each layer its k routed experts, its router and the shared
experts; capacity slots and dropped choices are not counted), the head
included and the embedding's gather not; and the attention's two products
over the causal (query, key) pairs.  Recomputation (remat) is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Product = Tuple[int, int, int]      # (M, K, N)


def dims(doc: Dict) -> Tuple[int, int, int, int]:
    """(D, H, K, dh)."""
    D, H = doc["hidden_size"], doc["num_attention_heads"]
    return D, H, doc["num_key_value_heads"], D // H


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal attention over S positions sees."""
    return S * (S + 1) // 2


def active_matrix_params(doc: Dict) -> int:
    """Weights of the products one token passes through: every layer's and
    the head's (the embedding is a gather)."""
    D, H, K, dh = dims(doc)
    attn = D * H * dh + 2 * D * K * dh + H * dh * D
    k, Fe = doc["num_experts_per_tok"], doc["moe_intermediate_size"]
    ffn = (D * doc["num_experts"] + k * 3 * D * Fe
           + 3 * D * doc["shared_expert_intermediate_size"])
    return doc["num_hidden_layers"] * (attn + ffn) + D * doc["vocab_size"]


def attention_flops(doc: Dict, B: int, S: int) -> float:
    """Both attention products over every layer's causal pairs."""
    _, H, _, dh = dims(doc)
    return 4.0 * B * H * dh * causal_pairs(S) * doc["num_hidden_layers"]


def forward_flops(doc: Dict, B: int, S: int) -> float:
    """Model FLOPs of one forward over (B, S) tokens."""
    return 2.0 * active_matrix_params(doc) * B * S \
        + attention_flops(doc, B, S)


def ffn_products(doc: Dict, B: int, S: int) -> List[Product]:
    """The products the blocked-matmul kernel runs in one forward: every
    layer's shared experts, one dense SwiGLU FFN."""
    D, F = doc["hidden_size"], doc["shared_expert_intermediate_size"]
    M = B * S
    return [(M, D, F), (M, D, F), (M, F, D)] * doc["num_hidden_layers"]


def product_work(p: Product, elem: int = 2) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one product: inputs read and output written
    once."""
    M, K, N = p
    return 2.0 * M * K * N, float(elem) * (M * K + K * N + M * N)
