"""xlstm-125m [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.

12L, d_model=768, 4H, vocab=50304.  xLSTM[7:1]-style mix: sLSTM at blocks
(3, 11), mLSTM elsewhere (exact positions unpublished for this size; choice
recorded here).  No separate FFN — the blocks carry their own projections.
Unrolled layers (shallow + heterogeneous; see transformer.py docstring).
"""
from repro_torch.models.config import ModelConfig

ARCH = "xlstm-125m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm", n_layers=12, d_model=768, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=50304, slstm_layers=(3, 11),
        ssm_chunk=256, scan_layers=False, tie_embeddings=True,
        pos_emb="none")


def reduced() -> ModelConfig:
    return config().replace(n_layers=3, d_model=48, n_heads=2,
                            n_kv_heads=2, vocab_size=512, slstm_layers=(1,),
                            ssm_chunk=8)
