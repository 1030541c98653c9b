"""InternVL2-style VLM backbone [arXiv:2404.16821]: the visual connector,
the prefixed forward and decode.

The port of ``src/repro/models/vlm.py``.  The InternViT frontend is a stub
there too: ``forward`` takes precomputed patch embeddings (B, N_vis,
visual_width).  The backbone is the dense decoder of
``models/transformer.py`` (``params["lm"]``) and a 2-layer MLP connector
that projects the patches into its width.  Visual tokens come first, then
the text, and the dense blocks run causal over the joined sequence (RoPE
positions 0 … N_vis + S - 1; with ``cfg.use_flash`` the flash kernel sees
it whole, with ``cfg.use_kernel_matmul`` the FFN products run the
blocked-matmul kernel).

Under a mesh the connector's products run on the shards
(``sharding.sp_matmul``) and the joined sequence and the logits take the
reference's ``shard_hint`` placements.

Decode is the dense path on ``params["lm"]``, as in the reference, which
never puts the visual prefix into the cache: a decode starts at pos 0 with
text only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import shard_hint, sp_matmul
from repro_torch.models import transformer as lm
from repro_torch.models.common import activation, dense_init, init_rng, zeros
from repro_torch.models.config import ModelConfig, Params, Specs


def init_vlm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Params:
    """fp32 weights drawn from ``generator`` (default: a CPU generator at
    its default seed) and placed on ``device`` (None: the card)."""
    gen, dev = init_rng(generator, device)
    return {
        "lm": lm.init_lm(cfg, gen, dev),
        "connector": {
            "w1": dense_init(gen, cfg.visual_width, cfg.d_model, device=dev),
            "b1": zeros((cfg.d_model,), device=dev),
            "w2": dense_init(gen, cfg.d_model, cfg.d_model, device=dev),
            "b2": zeros((cfg.d_model,), device=dev),
        },
    }


def vlm_specs(cfg: ModelConfig) -> Specs:
    return {
        "lm": lm.lm_specs(cfg),
        "connector": {"w1": (None, "embed"), "b1": ("embed",),
                      "w2": ("embed", "embed"), "b2": ("embed",)},
    }


def _project_visual(params: Params, patches: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """patches (B, N_vis, Dv) -> visual tokens (B, N_vis, D): plain products
    in the compute dtype, the bias added before the tanh-form GELU."""
    dt = cfg.compute_dtype
    c = params["connector"]
    h = activation("gelu", sp_matmul(patches.to(dt), c["w1"].to(dt))
                   + c["b1"].to(dt))
    return sp_matmul(h, c["w2"].to(dt)) + c["b2"].to(dt)


def forward(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, S) int, patches (B, N_vis, Dv)) -> (logits over the joined
    sequence (B, N_vis + S, V) in the compute dtype, aux fp32: 0 for the
    dense blocks)."""
    vis = _project_visual(params, patches, cfg)
    txt = lm._embed(params["lm"], tokens, cfg)
    x = shard_hint(torch.cat([vis, txt], dim=1), ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params["lm"]["blocks"]:
        x, a = lm._maybe_remat(lm._apply_dense_block, cfg)(blk, x, cfg)
        if a is not None:
            aux = aux + a
    return shard_hint(lm._head(params["lm"], x, cfg),
                      ("batch", "seq", "vocab")), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The dense KV cache of the language model on ``device`` (None: the
    card)."""
    return lm.init_cache(cfg, batch, max_len, device=device)


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The dense decode step on ``params["lm"]`` (the cache updated in
    place, as ``transformer.decode_step`` does)."""
    return lm.decode_step(params["lm"], tokens, cache, pos, cfg)
