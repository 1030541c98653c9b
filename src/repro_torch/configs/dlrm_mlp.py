"""dlrm-mlp — the paper's own case study (§III) [arXiv:2104.05158].

DLRM-style MLP tower: 8 fully-connected layers of width 4096 (the paper's
"input output feature map size of 4096"), trained data-parallel with
all-reduce gradient sync.  Batch is swept by the Fig. 4/6 benchmarks.
"""
from repro_torch.models.config import ModelConfig

ARCH = "dlrm-mlp"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="mlp", n_layers=8, d_model=4096, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=0, mlp_widths=(4096,) * 8)


def reduced() -> ModelConfig:
    return config().replace(n_layers=3, mlp_widths=(64,) * 3, d_model=64)
