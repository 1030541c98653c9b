"""qwen2.5-3b [hf:Qwen/Qwen2.5 family; hf]: dense GQA decoder, QKV bias.

36L, d_model=2048, 16H GQA kv=2, d_ff=11008, vocab=151936.
"""
from repro_torch.models.config import ModelConfig

ARCH = "qwen2.5-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, d_ff=11008, vocab_size=151936, qkv_bias=True,
        rope_theta=1_000_000.0)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=160, vocab_size=512)
