"""Quickstart on the PyTorch port: train a ~100M-class LM (SmolLM-135M
family, reduced width) for a few hundred steps with the full production
stack: data pipeline, AdamW + cosine schedule, fault-tolerant runner with
periodic async checkpoints, and a Ridgeline report of the step at the end.

The counterpart of ``examples/quickstart.py``, on the card unless
``--device cpu`` is given.  Where the reference analyses XLA's compiled
step on a TPU spec, this counts one step's F and B_M with
``measure/counters`` and places it on ``h100_sxm``, as ``launch/train.py``'s
closing report does (one device: B_N = 0).

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300] \\
        [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.core import H100_SXM, WorkUnit, analyze
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.device import resolve_device
from repro_torch.measure import counters
from repro_torch.optim.optimizer import AdamW, warmup_cosine
from repro_torch.train.fault_tolerance import ResilientRunner, RunnerConfig
from repro_torch.train.loop import (TrainStepConfig, build_train_step,
                                    init_train_state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # reduced config = same family, one-device sized (full config needs a mesh)
    cfg = get_reduced(args.arch).replace(compute_dtype=torch.float32)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={device}")

    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, args.steps))
    # the state donated, as the reference's jit donates it
    train_step = build_train_step(cfg, opt, TrainStepConfig(donate=True))
    stream = make_stream(cfg, DataConfig(
        seed=0, global_batch=args.batch, seq_len=args.seq))
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device=device)

    with tempfile.TemporaryDirectory(prefix="repro_torch_quickstart_") as d:
        runner = ResilientRunner(
            lambda s, b: train_step(s, to_device(b, device)),
            Checkpointer(d, keep=2),
            RunnerConfig(ckpt_every=100, async_ckpt=True))
        state, history = runner.run(state, stream, n_steps=args.steps)

    first = np.mean([h["ce"] for h in history[:10]])
    last = np.mean([h["ce"] for h in history[-10:]])
    print(f"\nCE: {first:.3f} -> {last:.3f} over {len(history)} steps "
          f"(log V = {np.log(min(cfg.vocab_size, 512)):.3f})")

    # Ridgeline analysis of one counted step (one device -> B_N = 0); a
    # functional step, which leaves ``state`` as it was
    flops, mem_bytes = counters.count(
        build_train_step(cfg, opt, TrainStepConfig()), state,
        to_device(stream.batch(0), device))
    wu = WorkUnit("quickstart_step", flops, mem_bytes, 0.0)
    print(analyze(wu, H100_SXM).summary())
    assert last < first - 0.2, "training did not learn"
    print("OK")


if __name__ == "__main__":
    main()
