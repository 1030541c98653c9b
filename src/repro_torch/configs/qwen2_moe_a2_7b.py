"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L, d_model=2048, 16H MHA (kv=16), vocab=151936; MoE: 60 routed experts
top-4 with per-expert d_ff=1408 + 4 shared experts (shared hidden 5632 =
4x1408), QKV bias.
"""
from repro_torch.models.config import ModelConfig

ARCH = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=5632, vocab_size=151936, qkv_bias=True,
        n_experts=60, n_shared_experts=4, moe_top_k=4, moe_d_ff=1408)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            d_ff=96, vocab_size=512, n_experts=8,
                            n_shared_experts=1, moe_top_k=2, moe_d_ff=24)
