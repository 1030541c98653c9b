"""minitron-8b [arXiv:2407.14679; hf]: width-pruned Nemotron-4.

32L, d_model=4096, 32H GQA kv=8, d_ff=16384, vocab=256000.
Nemotron family: squared-ReLU MLP (non-gated), no QKV bias.
"""
from repro_torch.models.config import ModelConfig

ARCH = "minitron-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=16384, vocab_size=256000,
        ffn_activation="relu2", norm="layernorm", norm_eps=1e-5)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=256, vocab_size=512)
