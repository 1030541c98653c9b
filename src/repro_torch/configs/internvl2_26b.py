"""internvl2-26b [arXiv:2404.16821; hf]: InternViT (STUB) + InternLM2-20B LM.

LM backbone: 48L, d_model=6144, 48H GQA kv=8, d_ff=16384, vocab=92553.
Vision frontend stubbed: input_specs provides (B, 256, 3200) InternViT-6B
patch embeddings; the 2-layer MLP connector projects them into the LM.
"""
from repro_torch.models.config import ModelConfig

ARCH = "internvl2-26b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab_size=92553,
        visual_tokens=256, visual_width=3200)


def reduced() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=160, vocab_size=512, visual_tokens=4,
                            visual_width=32)
