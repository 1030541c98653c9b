"""hymba-1.5b [arXiv:2411.13676; hf]: parallel attention + mamba heads.

32L, d_model=1600, 25H GQA kv=5 (head_dim 64), d_ff=5504, vocab=32001,
ssm_state=16.  Sliding-window attention (1024) everywhere except global
layers (first / middle / last), per the paper's global+local pattern.
"""
from repro_torch.models.config import ModelConfig

ARCH = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", n_layers=32, d_model=1600, n_heads=25,
        n_kv_heads=5, d_ff=5504, vocab_size=32001, ssm_state=16,
        sliding_window=1024, global_attn_layers=(0, 15, 31), ssm_chunk=256)


def reduced() -> ModelConfig:
    return config().replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=128, vocab_size=512, ssm_state=4,
                            sliding_window=8, global_attn_layers=(0, 2),
                            ssm_chunk=8)
