"""ModelConfig — the architecture description, with torch dtypes.

A copy of ``repro.models.config.ModelConfig`` with two differences: the
dtype fields hold ``torch.dtype`` values, and ``use_pallas_matmul`` is
``use_kernel_matmul`` (it routes the MLP layers through the CUDA kernel in
``repro_torch.kernels``).  Every other field keeps its name and default so
a config compares field by field with the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

Params = Any  # nested dict of tensors
#: a tree of logical-axis tuples, one per param (``*_specs``)
Specs = Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers the whole LM family (dense/MoE/SSM/hybrid/enc-dec)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_emb: str = "rope"            # rope | learned | none
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()   # full-attn layers when windowed
    causal: bool = True
    # ffn
    ffn_activation: str = "swiglu"   # swiglu | gelu
    ffn_bias: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    pad_experts_to: int = 0          # pad expert count for EP divisibility
    moe_group_tokens: int = 2048     # GShard dispatch-group size
    # ssm / hybrid
    ssm_state: int = 0               # per-head SSM state size
    ssm_conv: int = 4                # short conv width
    slstm_layers: Tuple[int, ...] = ()   # xLSTM: which blocks are sLSTM
    ssm_chunk: int = 256             # chunked-scan block length
    # enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder context (audio frames)
    # vlm
    visual_tokens: int = 0
    visual_width: int = 0            # ViT stub embedding width
    # mlp (DLRM case study)
    mlp_widths: Tuple[int, ...] = ()
    # numerics / lowering
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    scan_layers: bool = True
    remat: str = "none"              # none | dots | full
    use_flash: bool = False          # flash-attention kernel path
    use_kernel_matmul: bool = False  # CUDA blocked-matmul kernel path (MLP)
    attn_impl: str = "dense"         # dense | chunked
    attn_block_q: int = 1024         # q-block for chunked attention
    sp_outputs: bool = False         # Megatron-SP row-parallel outputs
    max_seq_len: int = 8192          # learned-pos table size; rope is unbounded

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.dh

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
