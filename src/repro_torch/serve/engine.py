"""Serving: prefill + batched single-token decode (``serve_step``).

The port of ``src/repro/serve/engine.py`` for every decoding family:
dense, MoE, hybrid (hymba), ssm (xLSTM), enc-dec (whisper) and VLM.
``build_serve_step(cfg)`` returns the one-token decode function of the
config's family (``transformer``, ``encdec`` or ``vlm.decode_step``):
given the params, the cache of the context so far (KV rows, rings,
recurrent states, an enc-dec model's cross K/V), the current token batch
and its position, it gives the logits and the cache, which it updates in
place.  ``greedy_generate`` prefills token by token through it and then
decodes greedily.  The step runs eagerly, as ``decode_step`` does: no
``torch.compile`` and no CUDA graph.  An enc-dec cache needs the encoder's
frames; a VLM decode is text only, from pos 0, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.measure.timers import _synchronizer
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models import vlm as vlm_mod
from repro_torch.models.config import ModelConfig, Params
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY


def build_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, tokens (B, 1), cache, pos) -> (logits (B, 1, V),
    cache)``."""
    if cfg.family == "encdec":
        decode = encdec_mod.decode_step
    elif cfg.family == "vlm":
        decode = vlm_mod.decode_step
    else:
        lm_mod._require_ported(cfg)
        decode = lm_mod.decode_step

    def serve_step(params, tokens, cache, pos):
        return decode(params, tokens, cache, pos, cfg)

    return serve_step


def init_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int,
               frames: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The cache for ``batch`` sequences of up to ``max_len`` tokens, on the
    device of ``params``: zeroed, but an enc-dec model's, whose cross K/V
    are computed from ``frames`` (B, T_enc, D), which it requires."""
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec cache needs the "
                             f"encoder's frames (B, T_enc, D); none given")
        return encdec_mod.init_encdec_cache(params, frames, batch, max_len,
                                            cfg)
    if cfg.family == "vlm":
        return vlm_mod.init_cache(cfg, batch, max_len,
                                  device=params["lm"]["embed"].device)
    lm_mod._require_ported(cfg)
    return lm_mod.init_cache(cfg, batch, max_len,
                             device=params["embed"].device)


def _laid_out(cache: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The cache laid out on the bound mesh by its logical specs (the
    decode rules), when the mesh spans more than one device; as it is
    otherwise (no binding, or one device, where tensors stay local)."""
    from repro_torch.distributed.sharding import (bound_mesh, place_tree,
                                                  specs_to_shardings)
    from repro_torch.launch.mesh import mesh_size
    from repro_torch.launch.specs import cache_logical_specs
    mesh = bound_mesh()
    if mesh is None or mesh_size(mesh) == 1:
        return cache
    return place_tree(cache, specs_to_shardings(
        cache_logical_specs(cfg, cache), mesh))


def greedy_generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                    steps: int, max_len: int,
                    frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill token by token, then greedy-decode ``steps`` tokens.

    prompt (B, S) int -> (B, S + steps), in ``S + steps - 1`` decode steps
    (the first takes ``prompt[:, :1]``); an enc-dec model needs ``frames``
    for its cache.  Under ``torch.no_grad()``.  Each
    step's time goes into ``REGISTRY.histogram("serve.step_seconds")``,
    with a device synchronize inside the timed region, so the card is
    charged for its work and not the enqueue; the whole run is one
    ``serve.generate`` span.
    """
    B, S = prompt.shape
    serve_step = build_serve_step(cfg)
    with torch.no_grad():
        cache = _laid_out(init_cache(params, cfg, B, max_len, frames=frames),
                          cfg)
    sync = _synchronizer(prompt.device)
    tok = prompt[:, :1]
    out = [tok]
    step_hist = REGISTRY.histogram("serve.step_seconds")
    with torch.no_grad(), trace.span("serve.generate", arch=cfg.name,
                                     batch=B, prompt_len=S, steps=steps):
        for t in range(S + steps - 1):
            with step_hist.time():
                logits, cache = serve_step(params, tok, cache, t)
                sync()
            if t + 1 < S:
                tok = prompt[:, t + 1:t + 2]
            else:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            out.append(tok)
    return torch.cat(out, dim=1)
