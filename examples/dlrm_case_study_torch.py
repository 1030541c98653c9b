"""End-to-end reproduction of the paper's §III case study on the PyTorch
port (the counterpart of ``examples/dlrm_case_study.py``).

1. Sweeps the batch size of the DLRM MLP and places every point on the CLX
   Ridgeline plane (Figs 4a/4c/6a/6b) — printing the region table and the
   ASCII Ridgeline plot.
2. Demonstrates the paper's prescription: with int8 gradient compression the
   network term drops 4x and the network-bound region shrinks — points that
   were network-bound move toward compute-bound.
3. Actually trains the (reduced-width) MLP, on the card unless ``--device
   cpu`` is given, to show the full substrate runs: BCE loss decreases on
   the synthetic CTR stream.

    PYTHONPATH=src python examples/dlrm_case_study_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import CLX, WorkUnit, analyze, ascii_plot
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.device import resolve_device
from repro_torch.models.mlp_dlrm import analytic_work_unit
from repro_torch.optim.compression import Int8Compressor
from repro_torch.optim.optimizer import SGD
from repro_torch.train.loop import (TrainStepConfig, build_train_step,
                                    init_train_state)

WIDTH, LAYERS = 4096, 8


def sweep():
    print("=== Paper §III: DLRM MLP batch sweep on CLX "
          f"(x*={CLX.ridge_memory:.2f}, y*={CLX.ridge_arithmetic:.0f}, "
          f"k*={CLX.ridge_network:.0f}) ===")
    analyses = []
    print(f"{'batch':>6} {'I_A':>8} {'I_M':>6} {'I_N':>8} {'region':>8} "
          f"{'t_comp':>9} {'t_net':>9} {'bound_runtime':>13}")
    for b in (64, 128, 256, 512, 1024, 2048, 4096):
        f, bm, bn = analytic_work_unit(b, WIDTH, LAYERS)
        a = analyze(WorkUnit(f"b{b}", f, bm, bn), CLX)
        analyses.append(a)
        print(f"{b:>6} {a.y:>8.1f} {a.x:>6.2f} "
              f"{a.work.network_intensity:>8.0f} {a.bottleneck.value:>8} "
              f"{a.t_compute*1e3:>8.1f}ms {a.t_network*1e3:>8.1f}ms "
              f"{a.runtime*1e3:>11.1f}ms")
    print("\n" + ascii_plot(analyses, CLX, width=64, height=18))


def sweep_with_compression():
    print("\n=== Beyond paper: int8 error-feedback gradient compression "
          "(B_N / 4) ===")
    frac = Int8Compressor().wire_fraction
    moved = []
    for b in (64, 128, 256, 512):
        f, bm, bn = analytic_work_unit(b, WIDTH, LAYERS)
        before = analyze(WorkUnit(f"b{b}", f, bm, bn), CLX)
        after = analyze(WorkUnit(f"b{b}+int8", f, bm, bn * frac), CLX)
        print(f"batch {b:>5}: {before.bottleneck.value:>8} "
              f"({100*before.peak_fraction:.0f}% peak) -> "
              f"{after.bottleneck.value:>8} ({100*after.peak_fraction:.0f}%)")
        moved.append((before.bottleneck, after.bottleneck))
    assert any(b.value == "network" and a.value != "network"
               for b, a in moved), "compression should move some points"


def train(device: torch.device):
    print(f"\n=== Training the (reduced) DLRM MLP on {device} ===")
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    opt = SGD(learning_rate=0.05, momentum=0.9)
    step = build_train_step(cfg, opt, TrainStepConfig())
    stream = make_stream(cfg, DataConfig(seed=2, global_batch=256))
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device=device)
    losses = []
    for s in range(150):
        state, m = step(state, to_device(stream.batch(s), device))
        losses.append(float(m["loss"]))
        if s % 30 == 0:
            print(f"  step {s:>4}  BCE {losses[-1]:.4f}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"BCE {first:.4f} -> {last:.4f}")
    assert last < first - 0.05
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)
    sweep()
    sweep_with_compression()
    train(device)
