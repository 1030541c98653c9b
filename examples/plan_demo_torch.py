"""Plan a parallelism layout before touching any hardware, with the PyTorch
port's planner (the counterpart of ``examples/plan_demo.py``).

Four views of the same question — "how should I spread this model over a
chip budget?" — all answered analytically (no tensor is drawn on any
device; the parameter counts run the real ``init_*`` on fake tensors):

  1. rank every feasible (dp, tp) mesh for the paper's DLRM MLP on 16 H100
     cards, per collective algorithm;
  2. sweep the batch axis against pure DP over 16 CLX sockets to find where
     the step leaves the network region (the paper's Fig. 6 question,
     generalized);
  3. scaling curve: best projected step time vs chip count — one
     vectorized ``plan_grid`` pass instead of N ``plan()`` calls;
  4. the pipeline axis: the chips × batch surface with pp ≤ 8 stages and
     1F1B microbatching, still a single broadcast pass.

    PYTHONPATH=src python examples/plan_demo_torch.py [--device cpu]

``--device`` is accepted as every example takes it; the planner is host
arithmetic and opens no CUDA context either way.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.hardware import get_hardware
from repro_torch.distributed import collectives
from repro_torch.launch.plan import (format_plan_table, param_counts, plan,
                                     plan_grid)


def main():
    cfg = get_config("dlrm-mlp")
    hw = get_hardware("h100_sxm")
    chips, batch = 16, 512

    # 1. ranked meshes, all collective algorithms
    plans = plan(cfg, hw, chips, batch=batch,
                 algorithms=collectives.ALGORITHMS)
    print(f"== {cfg.name}, batch {batch}, {chips}x {hw.name} ==")
    print(format_plan_table(plans[:6]))

    # 2. the paper's Fig. 6 question generalized: batch sweep of the same
    #    MLP, pure DP over 16 CLX sockets — where does the step leave the
    #    network region?
    clx = get_hardware("clx")
    batches = np.array([256, 512, 1024, 2048, 4096, 8192, 16384])
    n_total, _ = param_counts(cfg)
    flops = 6.0 * n_total * batches / 16
    net = collectives.dp_grad_sync_bytes(n_total * 4.0, 16, "ring")
    res = sweep_mod.sweep(flops, n_total * 4.0, net, clx)
    labels = res.labels()
    print("\n== batch sweep, dp16xtp1 on clx ==")
    for i, b in enumerate(batches):
        print(f"  batch {b:>5}: step {res.runtime[i] * 1e3:8.3f} ms  "
              f"-> {labels[i]}")
    for idx, frm, to in sweep_mod.transitions(res, batches):
        print(f"  {frm} -> {to} between batch {batches[idx - 1]} "
              f"and {batches[idx]}")

    # 3. scaling curve — one vectorized grid pass, not N plan() calls
    print("\n== best projected step time vs chips (one plan_grid pass) ==")
    chips_axis = (1, 2, 4, 8, 16, 32, 64, 128)
    grid = plan_grid(cfg, hw, chips_axis, [4096])
    curve = grid.best_runtime_grid()[:, 0]
    floor = curve[-1]
    for n, t in zip(chips_axis, curve):
        print(f"  {n:>4} chips: {t * 1e3:9.3f} ms  "
              + "#" * max(1, int(t / floor)))

    # 4. open the pipeline axis: chips × batch surface with pp up to 8
    #    stages and 1F1B microbatching, still one broadcast pass
    print("\n== chips x batch surface with --pp 8 (best mesh per point) ==")
    surface = plan_grid(cfg, clx, (8, 16, 32, 64), (256, 1024, 4096),
                        max_pp=8)
    print(f"  {surface.n_candidates} candidates in one pass")
    for c in surface.chips_list:
        for b in surface.batch_list:
            p = surface.best(c, b)
            print(f"  {c:>3} chips, batch {b:>5}: {p.mesh:>14} "
                  f"m={p.microbatches:<4} {p.runtime * 1e3:8.3f} ms "
                  f"({p.bottleneck})")
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="accepted for symmetry with the other examples; "
                         "the planner draws no tensor on any device")
    ap.parse_args()
    main()
