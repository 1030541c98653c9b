"""Deterministic synthetic data pipeline with per-host sharding, copied from
``repro.data.pipeline``.

The numpy arithmetic is the reference's, so ``batch(step)`` returns its dict
byte for byte (int32 tokens and labels, float32 frames, patches, features
and click); no torch random stream is drawn.  ``to_device`` moves a batch
onto the device the train step runs on.

Production contract: every host derives its shard of each global batch from
(seed, step, host_id) alone — no coordination, no state to checkpoint beyond
the step counter.  That is what makes elastic restarts trivial (a rejoined
or replacement host regenerates exactly its shard) and is the standard
strategy for deterministic multi-host input pipelines.

Synthetic tasks (the repository ships no datasets) that still give a
decreasing loss so the end-to-end examples demonstrate learning:

  * LM families: order-k Markov token streams — a fixed random transition
    table the model can learn (CE drops well below log V).
  * MLP/DLRM: clicks from a random ground-truth logistic model over the
    feature vector.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    global_batch: int = 32
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0
    markov_order: int = 1
    vocab_cap: int = 512        # synthetic stream uses min(vocab, cap)

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLMStream:
    """Markov-chain token stream: fixed transition matrix per seed."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg, self.data = cfg, data
        self.v = min(cfg.vocab_size, data.vocab_cap)
        rng = np.random.default_rng(data.seed)
        # peaked transition table: each token has ~4 likely successors that
        # together carry ~96% of the mass (optimal CE ~ 1.7 nats vs uniform
        # log V ~ 6.2 — a strong, learnable signal for the smoke examples)
        logits = rng.standard_normal((self.v, self.v)).astype(np.float32)
        top = np.argsort(logits, axis=1)[:, -4:]
        boost = np.zeros_like(logits)
        np.put_along_axis(boost, top, 8.0, axis=1)
        p = np.exp(logits * 0.1 + boost)
        self.trans = (p / p.sum(1, keepdims=True)).astype(np.float32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        d = self.data
        rng = np.random.default_rng(
            (d.seed * 1_000_003 + step) * 4096 + d.host_id)
        B, S = d.host_batch, d.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.v, B)
        u = rng.random((B, S)).astype(np.float32)
        cdf = np.cumsum(self.trans, axis=1)
        for t in range(S):
            toks[:, t + 1] = (
                cdf[toks[:, t]] < u[:, t:t + 1]).sum(1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, self.cfg.visual_tokens, self.cfg.visual_width)
            ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticCTRStream:
    """DLRM click stream: y ~ Bernoulli(sigmoid(w·x)) for a fixed hidden w."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg, self.data = cfg, data
        rng = np.random.default_rng(data.seed)
        self.d_in = cfg.mlp_widths[0]
        self.w = (rng.standard_normal(self.d_in) / np.sqrt(self.d_in)
                  ).astype(np.float32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        d = self.data
        rng = np.random.default_rng(
            (d.seed * 1_000_003 + step) * 4096 + d.host_id)
        x = rng.standard_normal((d.host_batch, self.d_in)).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-4.0 * x @ self.w))
        y = (rng.random(d.host_batch) < p).astype(np.float32)
        return {"features": x, "click": y}


def make_stream(cfg: ModelConfig, data: DataConfig):
    if cfg.family == "mlp":
        return SyntheticCTRStream(cfg, data)
    return SyntheticLMStream(cfg, data)


def skip_to(stream, step: int) -> None:
    """Restart support: nothing to do — batches are pure functions of step."""
    return None


def to_device(batch: Dict[str, np.ndarray],
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (None: the card).  Integer
    arrays (token ids, labels) widen to int64, the index dtype torch's
    gathers take; no value changes."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(
                dev, torch.int64 if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}
