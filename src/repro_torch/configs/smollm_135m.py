"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]: llama-arch small LM.

30L, d_model=576, 9H GQA kv=3, d_ff=1536, vocab=49152, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

ARCH = "smollm-135m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=30, d_model=576, n_heads=9,
        n_kv_heads=3, d_ff=1536, vocab_size=49152, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(n_layers=3, d_model=48, n_heads=3, n_kv_heads=3,
                            d_ff=128, vocab_size=512)
