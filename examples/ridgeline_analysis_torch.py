"""Use the Ridgeline as a TOOL on your own PyTorch function (the counterpart
of ``examples/ridgeline_analysis.py``).

This is the paper's contribution packaged as a library: hand
``ridgeline_of`` any function + inputs, and it returns the (F, B_M, B_N)
work unit — F and B_M counted by ``measure/counters`` over one run of the
function on its inputs (on the card unless ``--device cpu`` is given), B_N
given analytically — classifies the bottleneck on your hardware, and
prints the prescription.

Here we analyze three programs with deliberately different bottlenecks on
the H100's datasheet constants (``h100_sxm``): a 4096² bf16 GEMM, a
pointwise stencil, and a toy DP gradient exchange modelled analytically.
Their regions were worked out from ``h100_sxm``'s ridges before the script
first ran, and are the asserts below:

  * the GEMM: F = 2·4096³ = 1.37e11 over B_M = 3 · 4096² · 2 B = 1.01e8 gives
    I_A ≈ 1365 FLOP/B, above y* = 989e12 / 3.35e12 ≈ 295, and B_N = 0:
    compute (as on the reference's TPU spec);
  * the stencil: the counters count no FLOP for elementwise ops
    (``FlopCounterMode`` counts products), so F = 0 against ~2.7e8 eager
    bytes, and B_N = 0: memory (as on the reference's);
  * the DP worker: a 256² GEMM (F = 3.4e7, B_M = 3.9e5 B) and 2·256²·4 =
    5.2e5 wire bytes: t_N = 1.17 µs over t_M = 0.12 µs and t_C = 0.03 µs:
    network (as on the reference's).

    PYTHONPATH=src python examples/ridgeline_analysis_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import H100_SXM, WorkUnit, analyze, ascii_plot
from repro_torch.device import resolve_device
from repro_torch.measure import counters


def ridgeline_of(fn, *args, name: str = "fn", hw=H100_SXM,
                 extra_net_bytes: float = 0.0):
    """Count ``fn(*args)`` and place it on the Ridgeline plane of ``hw``."""
    flops, mem_bytes = counters.count(fn, *args)
    wu = WorkUnit(name, flops, mem_bytes, extra_net_bytes)
    return analyze(wu, hw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((4096, 4096), generator=gen, device=device,
                    dtype=torch.bfloat16)

    gemm = ridgeline_of(lambda x: x @ x, a, name="gemm_4096")
    stencil = ridgeline_of(
        lambda x: x[1:-1] + 0.5 * (x[:-2] + x[2:]), a, name="stencil")
    # toy DP worker: tiny local GEMM + full-gradient exchange (analytic B_N)
    small = torch.randn((256, 256), generator=gen, device=device,
                        dtype=torch.bfloat16)
    dp = ridgeline_of(lambda x: x @ x, small, name="dp_worker",
                      extra_net_bytes=2 * 256 * 256 * 4)

    print(f"Ridgeline on {H100_SXM.name} "
          f"(x*={H100_SXM.ridge_memory:.1f}, "
          f"y*={H100_SXM.ridge_arithmetic:.0f}"
          f", k*={H100_SXM.ridge_network:.0f}):\n")
    for a_ in (gemm, stencil, dp):
        print(" ", a_.summary())
    print("\n" + ascii_plot([gemm, stencil, dp], H100_SXM, width=64,
                            height=16))

    assert gemm.bottleneck.value == "compute"
    assert stencil.bottleneck.value == "memory"
    assert dp.bottleneck.value == "network"
    print("\nOK — three programs, three regions (the reference's three)")


if __name__ == "__main__":
    main()
