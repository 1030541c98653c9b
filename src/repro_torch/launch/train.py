"""Production training launcher, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 64 --reduced --ckpt-dir ckpt/run1 \
        [--device cpu]

The launcher wires together the substrate: the deterministic per-host data
pipeline (``data.pipeline``, its numpy batches moved to the device by
``to_device``), AdamW with warmup-cosine, the fault-tolerant runner
(auto-resume from the latest committed checkpoint, periodic async saves,
straggler flags), and a closing Ridgeline report of the step.

Where the port differs from the reference:

  * params come from ``torch.Generator(device).manual_seed(--seed)`` (torch
    streams, not JAX's), drawn on the device that trains them;
  * ``--device`` defaults to the card; the CPU runs only when asked;
  * ``--mesh`` other than ``1x1`` exits 2: the mesh and its sharding rules
    wait for ROADMAP Queue 1 item 12;
  * the report counts F and B_M of one step on the first batch
    (``measure.counters.count``; B_N = 0 on one card) in place of XLA's
    compiled cost analysis, and places it on ``H100_SXM``.

``--reduced`` trains the CPU-sized config of the same family in fp32
compute, as the reference does.  ``train(args)`` runs one invocation and
returns its state, history and counts; ``main`` is the CLI around it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import H100_SXM, RidgelineAnalysis, WorkUnit, analyze
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.device import resolve_device
from repro_torch.measure import counters
from repro_torch.optim.optimizer import AdamW, warmup_cosine
from repro_torch.train.fault_tolerance import ResilientRunner, RunnerConfig
from repro_torch.train.loop import (TrainState, TrainStepConfig,
                                    build_train_step, init_train_state)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model split; only 1x1 is ported")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What one invocation leaves: the final state (the one saved at
    ``--steps``), the steps it ran, the step itself, and the report of one
    counted step (its ``work`` holds F and B_M)."""

    state: TrainState
    history: List[Dict[str, float]]
    train_step: Any               # (state, batch of tensors) -> (state, m)
    report: RidgelineAnalysis


def train(args: argparse.Namespace) -> TrainRun:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(compute_dtype=torch.float32)
    dev = resolve_device(args.device)

    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    train_step = build_train_step(cfg, opt, TrainStepConfig(
        n_micro=args.n_micro))
    state = init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, opt,
        device=dev)
    stream = make_stream(cfg, DataConfig(
        seed=args.seed, global_batch=args.batch, seq_len=args.seq))
    runner = ResilientRunner(
        lambda s, b: train_step(s, to_device(b, dev)),
        Checkpointer(args.ckpt_dir, keep=3),
        RunnerConfig(ckpt_every=args.ckpt_every),
        on_straggler=lambda ev: print(
            f"[straggler] step {ev.step}: {ev.step_time:.2f}s "
            f"vs EWMA {ev.ewma:.2f}s", file=sys.stderr))
    state, history = runner.run(state, stream, n_steps=args.steps)

    if history:
        first = np.mean([h["ce"] for h in history[:10]])
        last = np.mean([h["ce"] for h in history[-10:]])
        print(f"steps {history[0]['step']}..{history[-1]['step']}  "
              f"CE {first:.4f} -> {last:.4f}")

    # closing Ridgeline report of one step on the first batch
    flops, nbytes = counters.count(train_step, state,
                                   to_device(stream.batch(0), dev))
    report = analyze(WorkUnit(f"{args.arch}/train", flops, nbytes, 0.0),
                     H100_SXM)
    print(report.summary())
    return TrainRun(state, history, train_step, report)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.mesh != "1x1":
        print(f"--mesh {args.mesh}: training over a mesh is not ported yet "
              f"(ROADMAP Queue 1, item 12: mesh and sharding); use 1x1",
              file=sys.stderr)
        return 2
    train(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
