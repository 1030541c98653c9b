"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf].

48L, d_model=2048, 32H GQA kv=4 with explicit head_dim=128, QK-norm,
vocab=151936; MoE: 128 routed experts top-8, per-expert d_ff=768, no shared.
"""
from repro_torch.models.config import ModelConfig

ARCH = "qwen3-moe-30b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=128, d_ff=0, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        n_experts=128, n_shared_experts=0, moe_top_k=8, moe_d_ff=768)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, vocab_size=512, n_experts=8,
                            moe_top_k=2, moe_d_ff=32)
