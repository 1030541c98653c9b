"""whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, conv frontend STUB.

4L enc + 4L dec, d_model=384, 6H MHA (kv=6), d_ff=1536, vocab=51865.
GELU MLP, LayerNorm, biased projections, learned decoder positions,
sinusoidal encoder positions, tied embeddings.  Encoder context fixed at
1500 frames (3000-frame mel -> stride-2 conv stub).  The learned position
table is resized to the requested shape for the 32k cells (DESIGN.md note).
"""
from repro_torch.models.config import ModelConfig

ARCH = "whisper-tiny"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="encdec", n_layers=4, d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=51865, encoder_layers=4,
        encoder_seq=1500, qkv_bias=True, ffn_bias=True,
        ffn_activation="gelu", norm="layernorm", norm_eps=1e-5,
        pos_emb="learned", tie_embeddings=True, max_seq_len=448)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, encoder_seq=24, max_seq_len=64)
