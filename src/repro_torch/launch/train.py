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

  * off a mesh the step writes the new state into the old one's buffers
    (``TrainStepConfig(donate=True)``, the reference's ``donate_argnums``);
    ``TrainRun.train_step`` is that step, so a caller's state advances in
    place;
  * params come from ``torch.Generator(device).manual_seed(--seed)`` (torch
    streams, not JAX's), drawn on the device that trains them;
  * ``--device`` defaults to the card; the CPU runs only when asked;
  * ``--mesh DxM`` (default ``1x1``) trains under a ``(data, model)``
    ``DeviceMesh`` with the serve CLI's rules (``launch.mesh.enter_mesh``):
    the state laid out by ``launch.specs.train_state_specs`` (no ZeRO), the
    batch's rows on the data axis; the step's gradient sync is DTensor's
    (``train.loop``).  The mesh is the world: one process makes ``1x1`` (on
    the card the state stays local tensors); a larger mesh takes that many
    ranks under ``torchrun`` on the CPU (gloo) and several cards on the card
    (ROADMAP Queue 1 item 4).  A mesh that is not the world exits 2.  Each
    rank of a larger world checkpoints the full state into its own
    ``rank<r>/`` under ``--ckpt-dir``;
  * the report counts F and B_M of one step on the first batch
    (``measure.counters.count``; B_N = 0 on one device) in place of XLA's
    compiled cost analysis, and places it on ``H100_SXM``; with a world
    above 1 it counts one device's F, B_M and wire bytes
    (``measure.counters.MeshCounter``).

``--reduced`` trains the CPU-sized config of the same family in fp32
compute, as the reference does.  ``train(args)`` runs one invocation and
returns its state, history and counts; ``main`` is the CLI around it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import H100_SXM, RidgelineAnalysis, WorkUnit, analyze
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NamedSharding, logical_spec,
                                              place, place_tree,
                                              specs_to_shardings)
from repro_torch.launch.mesh import enter_mesh, mesh_size
from repro_torch.launch.specs import input_axes, train_state_specs
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
                    help="data x model split; its product is the world")
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


def train(args: argparse.Namespace) -> Optional[TrainRun]:
    """One invocation; None (after saying why) when ``--mesh`` is not the
    world."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(compute_dtype=torch.float32)
    dev = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = enter_mesh(stack, args.mesh, cfg, dev)
        if mesh is None:
            return None
        return _train(args, cfg, dev, mesh)


def _train(args: argparse.Namespace, cfg, dev: torch.device, mesh
           ) -> TrainRun:
    world = mesh_size(mesh)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    # the state donated, as the reference's jit donates it (the loop keeps
    # a mesh's step functional)
    train_step = build_train_step(cfg, opt, TrainStepConfig(
        n_micro=args.n_micro, donate=True))
    state = place_tree(
        init_train_state(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg, opt, device=dev),
        specs_to_shardings(train_state_specs(cfg, zero1=False), mesh))
    rows = {k: NamedSharding(mesh, logical_spec(axes))
            for k, axes in input_axes(cfg).items()}

    def put(batch):
        return {k: place(v, rows[k]) for k, v in to_device(batch,
                                                           dev).items()}

    stream = make_stream(cfg, DataConfig(
        seed=args.seed, global_batch=args.batch, seq_len=args.seq))
    ckpt_dir = (os.path.join(args.ckpt_dir, f"rank{dist.get_rank()}")
                if world > 1 else args.ckpt_dir)
    runner = ResilientRunner(
        lambda s, b: train_step(s, put(b)),
        Checkpointer(ckpt_dir, keep=3),
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
    if world > 1:
        counter = counters.MeshCounter()
        with counter:
            train_step(state, put(stream.batch(0)))
        flops, nbytes = counter.flops, counter.bytes
        wire = counter.summary.total_wire_bytes
    else:
        # a functional step, which leaves ``state`` as it was
        flops, nbytes = counters.count(
            build_train_step(cfg, opt, TrainStepConfig(n_micro=args.n_micro)),
            state, put(stream.batch(0)))
        wire = 0.0
    report = analyze(WorkUnit(f"{args.arch}/train", flops, nbytes, wire),
                     H100_SXM)
    print(report.summary())
    return TrainRun(state, history, train_step, report)


def main(argv: Optional[List[str]] = None) -> int:
    return 0 if train(parse_args(argv)) is not None else 2


if __name__ == "__main__":
    sys.exit(main())
