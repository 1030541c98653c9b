#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds every CUDA kernel from the sources in the checkout, holds each one
against its plain PyTorch version on the card, drives the port's main path
(the full 8 x 4096 DLRM MLP tower scoring batches of 256, 1024 and 4096
requests through the fused GEMM + bias + ReLU kernel), times it, places it
on the Ridgeline plane of the H100 datasheet spec, and runs the
microbenchmarks.  Any failed check exits nonzero.  The last two lines are
a JSON summary of each kernel and the device line
``{"ok": true, "device": {...}}``.  Every number printed names the card and
its power limit, as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCHES = (256, 1024, 4096)
PARITY_SHAPES = ((4096, 4096, 4096), (256, 4096, 4096), (1000, 4096, 3000),
                 (300, 700, 520), (1, 4100, 17))
ACTS = (None, "relu", "relu2", "silu", "gelu")
#: rel error = max|got - want| / max|want|.  fp32: IEEE FMAs in another
#: summation order than cuBLAS; bf16: one rounding of the output (the
#: bounds of tests/test_kernels.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: kernel-path vs plain-path logits: the plain path rounds each product to
#: bf16 before the bias add, the kernel once after it, over 8 layers
LOGIT_TOL = 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    denom = max(want.abs().max().item(), 1e-6)
    return (got - want).abs().max().item() / denom


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def main() -> int:
    # ---- 1. device ------------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.core.hardware import H100_SXM, H100_SXM_FP32
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.ref import ref_matmul
    from repro_torch.measure import microbench
    from repro_torch.measure.timers import cuda_event_ms, time_callable

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {kind} (count {count})")
    print(smi)

    def say(line: str) -> None:
        print(f"{line} [{card}]", flush=True)

    # ---- 2. build -------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    built = _build.build()
    say(f"built {sorted(built)} in {time.perf_counter() - t0:.2f}s")
    for res in built.values():
        say(f"{res.name}: nvcc {res.seconds:.2f}s -> {res.path.name}")
        print(res.ptxas)

    # ---- 3. kernel parity -----------------------------------------------------
    phase("kernel_parity")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in PARITY_SHAPES:
            a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
            bias = torch.randn((N,), generator=gen, device=dev).to(dtype)
            cases = [(act, bias) for act in ACTS] + [("relu", None)]
            for act, bz in cases:
                got = blocked_matmul(a, b, bias=bz, act=act)
                want = ref_matmul(a, b, bias=bz, act=act)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                name = (f"{str(dtype)[6:]} ({M},{K},{N}) act={act} "
                        f"bias={bz is not None}")
                say(f"  {name}: rel_err {err:.3e} (tol {TOL[dtype]:g})")
                check(got.shape == (M, N) and torch.isfinite(got).all().item(),
                      f"kernel output malformed: {name}")
                check(err < TOL[dtype], f"kernel disagrees: {name}: {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
        a3 = torch.randn((4, 300, 700), generator=gen, device=dev).to(dtype)
        b3 = torch.randn((700, 520), generator=gen, device=dev).to(dtype)
        got = ops.matmul(a3, b3, act="gelu")
        want = ref_matmul(a3.reshape(-1, 700), b3, act="gelu").reshape(4, 300, 520)
        err = rel_err(got, want)
        say(f"  ops.matmul {str(dtype)[6:]} (4,300,700)@(700,520) gelu: "
            f"rel_err {err:.3e}")
        check(got.shape == (4, 300, 520) and err < TOL[dtype],
              f"ops.matmul leading dims {dtype}: {err}")
    say("worst rel_err: " + ", ".join(
        f"{str(k)[6:]} {v:.3e}" for k, v in worst.items()))

    # ---- 4. mlp_serve: the main path -------------------------------------------
    phase("mlp_serve")
    from repro_torch.configs import get_config
    from repro_torch.convert import mlp_params_from_numpy
    from repro_torch.models import mlp_dlrm

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("dlrm-mlp").replace(use_kernel_matmul=True)
    plain_cfg = cfg.replace(use_kernel_matmul=False)
    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)
    rng = np.random.default_rng(0)
    scale = np.float32(1.0 / np.sqrt(W))
    tree = {"layers": [{"w": rng.standard_normal((W, W), np.float32) * scale,
                        "b": rng.standard_normal(W, np.float32) * np.float32(0.1)}
                       for _ in range(L)],
            "head": {"w": rng.standard_normal((W, 1), np.float32) * scale,
                     "b": rng.standard_normal(1, np.float32)}}
    params = mlp_params_from_numpy(tree, device=dev)
    del tree
    feats = {B: torch.from_numpy(rng.standard_normal((B, W), np.float32)).to(dev)
             for B in BATCHES}
    say(f"dlrm-mlp {L} x {W}, compute {str(cfg.compute_dtype)[6:]}, "
        f"params {str(cfg.param_dtype)[6:]}, batches {BATCHES}")

    # the main path: each batch scored once through the kernel path
    blocked_matmul.launches = 0
    logits = {}
    per_forward = []
    for B in BATCHES:
        before = blocked_matmul.launches
        logits[B] = mlp_dlrm.forward(params, feats[B], cfg)
        per_forward.append(blocked_matmul.launches - before)
    torch.cuda.synchronize()
    main_launches = blocked_matmul.launches
    say(f"launches per forward {per_forward}, main path total {main_launches}")
    check(per_forward == [L] * len(BATCHES),
          f"expected {L} kernel launches per forward, got {per_forward}")

    for B in BATCHES:
        want = mlp_dlrm.forward(params, feats[B], plain_cfg)
        got = logits[B]
        check(got.shape == (B,) and torch.isfinite(got).all().item(),
              f"logits malformed at B={B}")
        err = rel_err(got, want)
        say(f"  B={B}: logits kernel vs plain rel_err {err:.3e} "
            f"(tol {LOGIT_TOL:g}), max|logit| {want.abs().max().item():.4g}")
        check(err < LOGIT_TOL, f"kernel-path logits disagree at B={B}: {err}")

    dt = cfg.compute_dtype
    w_c = [lyr["w"].to(dt) for lyr in params["layers"]]
    b_c = [lyr["b"].to(dt) for lyr in params["layers"]]

    def casts(_i):
        for lyr in params["layers"]:
            lyr["w"].to(dt)
            lyr["b"].to(dt)

    cast_ms = cuda_event_ms(casts, iters=10)
    per_batch, work_totals = [], []
    for B in BATCHES:
        h = feats[B].to(dt)
        # rotate through the 8 layers' weights, as the forward does, so no
        # launch finds its 32 MB weight in L2 from the launch before
        k_ms = cuda_event_ms(lambda i: blocked_matmul(
            h, w_c[i % L], bias=b_c[i % L], act="relu"), iters=40)
        p_ms = cuda_event_ms(lambda i: ref_matmul(
            h, w_c[i % L], bias=b_c[i % L], act="relu"), iters=40)
        lib_ms = cuda_event_ms(lambda i: torch.relu(torch.addmm(
            b_c[i % L], h, w_c[i % L])), iters=40)
        err_abs = max_abs(blocked_matmul(h, w_c[0], bias=b_c[0], act="relu"),
                          ref_matmul(h, w_c[0], bias=b_c[0], act="relu"))
        # 100 samples: the p90 has 10 beyond it
        fwd = time_callable(mlp_dlrm.forward, params, feats[B], cfg,
                            device=dev, repeats=100, warmup=2)
        fwd_p90 = float(np.percentile(fwd.samples, 90))
        fwd_plain = time_callable(mlp_dlrm.forward, params, feats[B],
                                  plain_cfg, device=dev, repeats=10, warmup=2)
        fwd_ev = cuda_event_ms(lambda i: mlp_dlrm.forward(params, feats[B], cfg),
                               iters=10)
        layer_flops = 2.0 * B * W * W
        layer_bytes = 2.0 * (B * W + W * W + W + B * W)   # A, W, bias, out
        layer = analyze(WorkUnit(f"layer_b{B}", layer_flops, layer_bytes, 0.0),
                        H100_SXM)
        fwd_flops = L * layer_flops + 2.0 * B * W
        fwd_bytes = L * layer_bytes + L * 6.0 * (W * W + W)  # + fp32->bf16 casts
        whole = analyze(WorkUnit(f"forward_b{B}", fwd_flops, fwd_bytes, 0.0),
                        H100_SXM)
        per_batch.append({
            "shape": [B, W, W], "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": layer.runtime * 1e3,
            "bound_by": "bytes" if layer.bottleneck.value == "memory"
            else "operations", "max_abs_err": err_abs})
        work_totals.append((layer_flops, layer_bytes))
        say(f"  B={B} per layer: kernel {k_ms:.4f} ms "
            f"({layer_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
            f"library addmm+relu {lib_ms:.4f} ms; bound "
            f"{layer.runtime * 1e3:.4f} ms ({layer.bottleneck.value}), "
            f"kernel at {100 * layer.runtime * 1e3 / k_ms:.1f}% of bound; "
            f"max_abs_err {err_abs:.3e}")
        say(f"  B={B} forward: host median {fwd.median * 1e3:.4f} ms, "
            f"p90 {fwd_p90 * 1e3:.4f} ms (n={len(fwd.samples)}), "
            f"{B / fwd.median:.0f} requests/s; card {fwd_ev:.4f} ms, "
            f"plain path host {fwd_plain.median * 1e3:.4f} ms; "
            f"{fwd_flops / fwd.median / 1e12:.1f} TFLOP/s; "
            f"{whole.summary()}; at {100 * whole.runtime / fwd.median:.1f}% "
            f"of bound; weight cast {cast_ms:.4f} ms = "
            f"{100 * cast_ms / fwd_ev:.1f}% of the forward")
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"peak memory allocated {peak / 1e9:.3f} GB; weight casts "
        f"{cast_ms:.4f} ms per forward (bound "
        f"{L * 6.0 * (W * W + W) / H100_SXM.hbm_bw * 1e3:.4f} ms)")

    # ---- 5. microbench ----------------------------------------------------------
    phase("microbench")
    # host cost of one launch through the wrapper (checks, allocation,
    # ctypes call), enqueue only, beside one torch.mm at the same tiny shape
    tiny = torch.randn((64, 64), device=dev)
    for label, fn in (("blocked_matmul", lambda: blocked_matmul(tiny, tiny)),
                      ("torch.mm", lambda: torch.mm(tiny, tiny))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        say(f"host enqueue per call, {label} 64x64x64: {host_us:.2f} us")
    sizes = microbench.FULL_MATMUL_SIZES + (4096,)
    for m in microbench.matmul_benches(sizes, repeats=5, device=dev):
        a = analyze(m.work, H100_SXM_FP32)
        print(json.dumps({**m.to_dict(), "card": card,
                          "bound_s": a.runtime, "bound_by": a.bottleneck.value,
                          "share_of_bound": a.runtime / m.seconds}))
    for m in microbench.memory_benches(microbench.FULL_STREAM_MB,
                                       sizes_kb=microbench.FULL_STREAM_KB,
                                       repeats=5, device=dev):
        a = analyze(m.work, H100_SXM)
        print(json.dumps({**m.to_dict(), "card": card,
                          "bound_s": a.runtime, "bound_by": a.bottleneck.value,
                          "share_of_bound": a.runtime / m.seconds}))

    # ---- summary ------------------------------------------------------------------
    n = L  # launches per batch on the main path
    tot_flops = sum(n * flops for flops, _ in work_totals)
    tot_bytes = sum(n * nbytes for _, nbytes in work_totals)
    t_ops, t_bytes = tot_flops / H100_SXM.peak_flops, tot_bytes / H100_SXM.hbm_bw
    summary = {"kernels": [{
        "name": "blocked_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blocked_matmul.cu",
        "replaces": "src/repro/kernels/blocked_matmul.py:57",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_batch),
        # times are totals over the main path's launches (8 per batch)
        "ms": sum(n * r["kernel_ms"] for r in per_batch),
        "plain_ms": sum(n * r["plain_ms"] for r in per_batch),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(n * r["library_ms"] for r in per_batch),
        "card": card,
        "per_launch": per_batch,
    }]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
