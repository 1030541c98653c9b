#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds every CUDA kernel from the sources in the checkout, holds each one
against its plain PyTorch version on the card, and drives the port's main
paths, each with the launch counts set to 0 just before it and read just
after:

  mlp_serve   the full 8 x 4096 DLRM MLP tower scoring batches of 256, 1024
              and 4096 requests through the fused GEMM + bias + ReLU kernel
              (its Hopper variant, sm90: TMA ring, wgmma, persistent grid);
  lm_prefill  the full smollm-135m (30 layers, width 576, random weights)
              prefilling token batches (8, 2048), (1, 2048) and (4, 1000)
              with every layer's attention in the flash-attention kernel
              (its Hopper variant, sm90: TMA K/V ring, wgmma, the softmax
              under the products), and (8, 2048) once more with the FFN
              products in the blocked matmul kernel too;
  mlp_train   the full tower trained (bf16 compute, fp32 params, AdamW with
              warmup-cosine): the loss falls over 20 steps at B = 1024,
              bf16 grads agree with fp32 grads, three fp32 steps on the card
              agree with the CPU's, the counted FLOPs with the analytic
              count; the step timed and profiled at B = 256, 1024, 4096.
              It launches no kernel of the port (the blocked matmul is
              forward-only, as the JAX package's is);
  calibrate   the smoke calibration suite (fp32 GEMMs through the blocked
              matmul's f32 kernel, saxpy streams, two train steps) and
              fp32 GEMMs at 2048 and 4096, fitted into achievable ceilings
              against h100_sxm_fp32 (a registry entry in a temporary
              directory); the train steps placed on the datasheet and the
              fitted plane.

Every blocked-matmul and flash-attention launch of the first two paths must
take the sm90 variant, every calibration GEMM the f32 variant (the wrappers
count launches by variant).  It times the paths, places them on the
Ridgeline plane of the H100 datasheet spec, times the flash kernel's
earlier mma design beside the sm90 kernel at every prefill shape and the
sm90 GEMM's tile options at every main-path shape, and the host cost of a
launch.  Any failed check exits nonzero
(``chip_mutants.py`` shows that the parity and logits checks fail kernels
with planted faults: late kv tiles and the K/V ring of the flash kernel,
the ring and the last k-step of the sm90 GEMM).  The last two lines are a
JSON summary of each kernel (its times are totals over its own launches on
the main paths) and the device line ``{"ok": true, "device": {...}}``.
Every number printed names the card and its power limit, as ``nvidia-smi``
reports them.
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
#: (M, K, N).  bf16 takes the sm90 kernel wherever K and N are multiples of
#: 8, the wmma kernel at (300, 700, 520) and (1, 4100, 17).  The sm90 edges:
#: ragged M (1000, 3000, 5000) and M = 1; N = 576 (BN 192) and N = 8; K = 64
#: and K = 8 (one k-step, fewer than the ring's stages); 96 tiles (< 132
#: SMs) and 320 (not a multiple of 132)
PARITY_SHAPES = ((4096, 4096, 4096), (256, 4096, 4096), (1000, 4096, 3000),
                 (300, 700, 520), (1, 4100, 17), (1000, 576, 1536),
                 (1, 4096, 4096), (1000, 1536, 576), (300, 64, 8),
                 (130, 8, 520), (3000, 1024, 1000), (5000, 512, 2048))
ACTS = (None, "relu", "relu2", "silu", "gelu")
#: rel error = max|got - want| / max|want|.  fp32: IEEE FMAs in another
#: summation order than cuBLAS; bf16: one rounding of the output (the
#: bounds of tests/test_kernels.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: kernel-path vs plain-path logits: the plain path rounds each product to
#: bf16 before the bias add, the kernel once after it, over 8 layers
LOGIT_TOL = 2e-2
#: flash attention vs ``ref_flash_attention``, by ``row_rel_err``: each
#: output row (one query, one head) is held to its own norm.  An early row
#: averages a few keys and is large, a late one averages ~1000 and is small,
#: so a max over all rows would let the early rows set the limit for all.
#: fp32: FMAs in another order, TF32 off; bf16: p is rounded before P.V and
#: the output once, each by up to 2^-9 (the bounds of tests/test_kernels.py).
#: On an H100 bf16 reads up to 5.1e-3, and the planted faults of
#: chip_mutants.py 0.99-5.4 at the prefill shape.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: (B, S, H, K, dh, causal, window): tests/test_kernels.py's four, a ragged
#: S, S = 1, the smollm-135m prefill launch, and for the sm90 kernel's
#: 128-row tiles: ragged S at 1000 with dh 128 and a window that cuts
#: through 128-key tiles
FLASH_SHAPES = ((2, 512, 4, 2, 64, True, 0), (1, 512, 4, 4, 128, True, 0),
                (1, 1024, 8, 2, 64, True, 256), (2, 512, 6, 3, 64, False, 0),
                (2, 300, 9, 3, 64, True, 0), (2, 1, 9, 3, 128, True, 0),
                (8, 2048, 9, 3, 64, True, 0), (2, 1000, 4, 2, 128, True, 0),
                (1, 777, 4, 2, 64, False, 200))
#: the prefill's token batches (B, S); the first is timed (2048 is
#: SmolLM-135M's trained context), the last is ragged
PREFILL = ((8, 2048), (1, 2048), (4, 1000))
#: flash-path vs plain-path logits by ``row_rel_err`` (each token's row of
#: 49152 logits to its own norm), bf16, 30 layers.  The attention paths
#: round at different places (the plain path scales scores by sqrt(dh) in
#: bf16 and normalises p before its bf16 cast, the kernel scales in fp32
#: and casts the unnormalised p), and each layer's residual carries the
#: difference on.  On an H100 the three batches read 2.7-3.0e-2, and
#: planted faults in the kernel's late kv tiles read 0.58-0.80
#: (chip_mutants.py; PERF.md): 6e-2 is twice the worst reading.
LM_TOL = 6e-2
#: the dlrm-mlp train step: 20 AdamW steps on one fixed batch of 1024, the
#: step timed at three batches (256 below the bf16 ridge, 1024 and 4096
#: above it)
TRAIN_BATCH, TRAIN_STEPS = 1024, 20
STEP_BATCHES = (256, 1024, 4096)
#: bf16-compute grads against fp32-compute grads of one step, per param,
#: ``norm(g_bf16 - g_fp32) / norm(g_fp32)``.  bf16 rounds each product's
#: inputs and output (2^-9), and a ReLU whose input sits within that
#: rounding of 0 passes the backward signal in one path and not the other;
#: the flips compound through the later layers, so layer 0's weight grad
#: is furthest off.  In plain PyTorch on the CPU (8 layers, widths 512 to
#: 2048, batches 256 and 1024, these weights) layer 0's weight grad reads
#: 0.156-0.162 at every width and the last layers 0.01-0.02; a wrong
#: backward (a lost grad, a swapped layer) reads ~1.  0.3 is twice the worst
#: reading.  On an H100: 0.1593 (layer 0's weight) down to 0.0187 (PERF.md).
GRAD_TOL = 0.3
#: the fp32 step on the card (cuBLAS, TF32 off) against the same step on the
#: CPU, 4 layers of 512 at B 256, three AdamW steps.  The products sum in
#: other orders (~1e-6 relative): loss and grad norm within 1e-5.  AdamW
#: divides each grad by its own RMS, so an element whose grad is near eps
#: (1e-8) can move by a few 1e-3 of lr: params within 1e-4 of the largest.
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "params": 1e-4}
#: the gate of benchmarks/run.py on the counted / analytic FLOP ratio of the
#: dlrm-mlp step (the analytic 6·B·W²·L counts layer 0's input grad, which
#: the step never forms: 23/24 = 0.958 at 8 layers)
FLOP_RATIO = (0.9, 1.3)
#: fp32 GEMMs the calibration fit also reads beyond the smoke suite's sizes
#: (the peak is reached only there)
CAL_BIG = (2048, 4096)


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


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows (the last dim) of |got_row - want_row| / |want_row|."""
    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-6)
    return (num / den).max().item()


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def sm90_option(sm90, a: torch.Tensor, b: torch.Tensor, bias, act, plan):
    """One launch of ``sm90`` (the second entry point ``blocked_matmul.bind``
    returns) with the tiles of ``plan``, past the wrapper and its counters."""
    from repro_torch.kernels.blocked_matmul import _ACT_CODE
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = sm90(a.data_ptr(), b.data_ptr(),
              None if bias is None else bias.data_ptr(), out.data_ptr(),
              M, N, K, _ACT_CODE[act], plan.bn, int(plan.n_fastest),
              torch.cuda.current_stream(a.device).cuda_stream)
    check(rc == 0, f"sm90 {plan} failed at ({M},{K},{N}): CUDA error {rc}")
    return out


def flash_option(fns, kind: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """One causal launch of the ``kind`` kernel of ``fns`` (what
    ``flash_attention.bind`` returns) on model-layout q, k, v, past the
    wrapper and its counters."""
    from repro_torch.kernels import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty_like(qt)
    rc = fa.launch(fns, kind, qt, kt, vt, out, True, 0, q.shape[1])
    check(rc == 0, f"flash {kind} failed at {tuple(q.shape)}: CUDA error {rc}")
    return out.transpose(1, 2)


def attn_work(B: int, S: int, H: int, K: int, dh: int, causal: bool,
              elem: int):
    """(FLOP, bytes) one flash launch needs: the Q.K^T and P.V products over
    the (q, k) pairs that are visible (causal: S(S+1)/2 per head), and q, k,
    v read once and o written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4.0 * B * H * dh * pairs, float(elem) * (2 * B * S * H * dh
                                                    + 2 * B * S * K * dh)


def smollm_tree(cfg, rng: np.random.Generator) -> dict:
    """Random smollm-135m weights in the JAX package's scanned layout (every
    block leaf stacked on a leading layer axis): ``dense_init`` and
    ``embed_init`` scales, norm scales moved away from 1."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def dense(*shape):
        return rng.standard_normal(shape, np.float32) \
            * np.float32(1.0 / np.sqrt(shape[-2]))

    def scale(*shape):
        return np.float32(1.0) + np.float32(0.1) \
            * rng.standard_normal(shape, np.float32)

    return {
        "embed": rng.standard_normal((cfg.vocab_size, d), np.float32)
        * np.float32(0.02),
        "blocks": {
            "attn_norm": {"scale": scale(L, d)},
            "attn": {"wq": dense(L, d, cfg.q_dim), "wk": dense(L, d, cfg.kv_dim),
                     "wv": dense(L, d, cfg.kv_dim), "wo": dense(L, cfg.q_dim, d)},
            "ffn_norm": {"scale": scale(L, d)},
            "ffn": {"w_gate": dense(L, d, f), "w_up": dense(L, d, f),
                    "w_down": dense(L, f, d)},
        },
        "final_norm": {"scale": scale(d)},
    }


def dlrm_tree(cfg, rng: np.random.Generator) -> dict:
    """Random dlrm-mlp weights: dense layers at 1/sqrt(width), biases at
    0.1, one head column."""
    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)
    scale = np.float32(1.0 / np.sqrt(W))
    return {"layers": [{"w": rng.standard_normal((W, W), np.float32) * scale,
                        "b": rng.standard_normal(W, np.float32)
                        * np.float32(0.1)} for _ in range(L)],
            "head": {"w": rng.standard_normal((W, 1), np.float32) * scale,
                     "b": rng.standard_normal(1, np.float32)}}


def bound_of(flops: float, nbytes: float, hw) -> tuple:
    """(least ms, "operations" or "bytes") for the work on ``hw``."""
    t_ops, t_bytes = flops / hw.peak_flops, nbytes / hw.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tree_rel_err(got, want) -> float:
    """max |got - want| over every leaf / max |want| over every leaf."""
    from repro_torch.tree import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    scale = max(x.abs().max().item() for x in w)
    return max((a.cpu() - b.cpu()).abs().max().item()
               for a, b in zip(g, w)) / scale


def grads(cfg, params, batch) -> list:
    """One step's grads of ``params`` (in ``tree_leaves`` order)."""
    from repro_torch.train.loop import make_loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = make_loss_fn(cfg)(tree_unflatten(params, leaves), batch)
    return list(torch.autograd.grad(loss, leaves))


def click_batch(rng: np.random.Generator, B: int, W: int, dev) -> dict:
    """Features N(0, 1) and 30% clicks, from numpy."""
    return {"features": torch.from_numpy(
                rng.standard_normal((B, W), np.float32)).to(dev),
            "click": torch.from_numpy(
                (rng.random(B) < 0.3).astype(np.float32)).to(dev)}


def profile_kernels(fn) -> list:
    """(name, launches, ms) of every kernel the profiler saw in one ``fn()``
    (the device's rows only: a CPU op's row counts its kernels too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(r.key, r.count, r.self_device_time_total / 1e3)
            for r in prof.key_averages() if r.device_type == DeviceType.CUDA]


def is_gemm(kernel_name: str) -> bool:
    """cuBLAS and CUTLASS product kernels, by name."""
    name = kernel_name.lower()
    return any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass"))


def mlp_train(dev, say, cfg, rng: np.random.Generator) -> list:
    """The dlrm-mlp train path: (a) ``TRAIN_STEPS`` AdamW steps on one batch
    with the loss falling, (b) bf16 against fp32 grads, (c) three fp32 steps
    on the card against the CPU, (d) counted against analytic FLOPs, (e) the
    step timed at ``STEP_BATCHES``.  Returns (B, WorkUnit, host median s)
    of each timed step for the Ridgeline placement."""
    from repro_torch.convert import mlp_params_from_numpy
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.measure import counters
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    from repro_torch.models.mlp_dlrm import analytic_work_unit
    from repro_torch.optim.optimizer import (AdamW, apply_updates,
                                             warmup_cosine)
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves, tree_unflatten

    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)
    params = mlp_params_from_numpy(dlrm_tree(cfg, rng), device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 5, TRAIN_STEPS))
    step = loop.build_train_step(cfg, opt)
    fresh = loop.TrainState(params, opt.init(params),
                            torch.zeros((), dtype=torch.int32, device=dev),
                            None)
    say(f"dlrm-mlp {L} x {W}: {n_params} fp32 params, compute "
        f"{str(cfg.compute_dtype)[6:]}, AdamW (warmup_cosine 1e-3, 5, "
        f"{TRAIN_STEPS}), clip 1.0")

    # (a) the loss falls over TRAIN_STEPS steps on one fixed batch
    batch = click_batch(rng, TRAIN_BATCH, W, dev)
    state, losses = fresh, []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [x.item() for x in losses]
    say(f"  (a) B={TRAIN_BATCH} loss over {TRAIN_STEPS} steps: "
        + " ".join(f"{x:.4f}" for x in losses))
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(int(state.step) == TRAIN_STEPS, f"step counter {int(state.step)}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) and losses[-1] < losses[0],
          f"the train loss does not fall: {losses}")
    del state

    # (b) bf16-compute grads against fp32-compute grads of one step
    g16 = grads(cfg, params, batch)
    g32 = grads(cfg.replace(compute_dtype=torch.float32), params, batch)
    names = [f"head.{k}" for k in ("b", "w")] + [
        f"layer{i}.{k}" for i in range(L) for k in ("b", "w")]
    errs = [(torch.linalg.vector_norm(a.float() - b)
             / torch.linalg.vector_norm(b)).item() for a, b in zip(g16, g32)]
    say("  (b) grads bf16 vs fp32 compute (TF32 off), norm rel err per "
        f"param (tol {GRAD_TOL:g}): "
        + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, errs)))
    check(all(np.isfinite(errs)) and max(errs) < GRAD_TOL,
          f"bf16 grads disagree with fp32: {max(errs)}")
    del g16, g32

    # (c) three fp32 steps at 4 x 512, B 256: the card against the CPU
    small = cfg.replace(n_layers=4, mlp_widths=(512,) * 4, d_model=512,
                        compute_dtype=torch.float32)
    tree = dlrm_tree(small, rng)
    sb = click_batch(rng, 256, 512, "cpu")
    sides = {}
    for d in (dev, torch.device("cpu")):
        p = mlp_params_from_numpy(tree, device=d)
        st = loop.TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=d), None)
        s_step = loop.build_train_step(small, opt)
        ms = []
        for _ in range(3):
            st, m = s_step(st, {k: v.to(d) for k, v in sb.items()})
            ms.append(m)
        sides[d.type] = (st, ms)
    (gst, gms), (cst, cms) = sides[dev.type], sides["cpu"]
    rel = {"loss": max(abs(a["loss"].item() - b["loss"].item())
                       / abs(b["loss"].item()) for a, b in zip(gms, cms)),
           "grad_norm": max(abs(a["grad_norm"].item() - b["grad_norm"].item())
                            / abs(b["grad_norm"].item())
                            for a, b in zip(gms, cms)),
           "params": tree_rel_err(gst.params, cst.params)}
    say("  (c) 3 fp32 AdamW steps, 4 x 512 at B=256, card vs CPU: "
        + ", ".join(f"{k} {v:.3e} (tol {STEP_TOL[k]:g})"
                    for k, v in rel.items()))
    check(all(rel[k] < STEP_TOL[k] for k in rel),
          f"the card's fp32 steps disagree with the CPU's: {rel}")

    # (d) + (e): the step at each batch, counted and timed
    placed = []
    for B in STEP_BATCHES:
        b_ = click_batch(rng, B, W, dev)
        flops, nbytes = counters.count(step, fresh, b_)
        analytic = analytic_work_unit(B, W, L)[0]
        ratio = flops / analytic
        say(f"  (d) B={B}: counted F {flops:.6g}, B_M {nbytes:.6g} (eager "
            f"ops); analytic 6BW^2L {analytic:.6g}; ratio {ratio:.4f} "
            f"(gate {FLOP_RATIO})")
        check(FLOP_RATIO[0] < ratio < FLOP_RATIO[1],
              f"counted/analytic FLOPs {ratio} at B={B}")
        host = time_callable(step, fresh, b_, device=dev, repeats=30,
                             warmup=3)
        p90 = float(np.percentile(host.samples, 90))
        card_ms = cuda_event_ms(lambda i: step(fresh, b_), iters=10)
        g = grads(cfg, params, b_)
        g = tree_unflatten(params, g)
        upd_ms = cuda_event_ms(lambda i: apply_updates(
            params, opt.update(g, fresh.opt_state, params)[0]), iters=10)
        kern = profile_kernels(lambda: step(fresh, b_))
        k_ms = sum(ms for _, _, ms in kern)
        gemm_ms = sum(ms for n, _, ms in kern if is_gemm(n))
        work = WorkUnit(f"train_step_mlp_b{B}", flops, nbytes, 0.0)
        a = analyze(work, H100_SXM)
        a_gemm = analyze(WorkUnit("gemms", flops, 0.0, 0.0), H100_SXM)
        placed.append((B, work, host.median))
        say(f"  (e) B={B} step: host median {host.median * 1e3:.4f} ms, p90 "
            f"{p90 * 1e3:.4f} ms (n={len(host.samples)}); card "
            f"{card_ms:.4f} ms; optimizer update + apply alone {upd_ms:.4f} "
            f"ms; {flops / host.median / 1e12:.1f} TFLOP/s; h100_sxm: "
            f"{a.summary()}; at {100 * a.runtime / host.median:.1f}% of "
            f"bound (its products alone {a_gemm.runtime * 1e3:.4f} ms)")
        say(f"  (e) B={B} profile of one step: {len(kern)} kernel names, "
            f"{sum(n for _, n, _ in kern)} launches, {k_ms:.4f} ms of kernels "
            f"({100 * k_ms / card_ms:.1f}% of the card time); GEMMs "
            f"{gemm_ms:.4f} ms ({100 * gemm_ms / k_ms:.1f}%), the rest "
            f"(elementwise: casts, ReLU masks, AdamW) "
            f"{k_ms - gemm_ms:.4f} ms; by name, most first:")
        for name, n, ms in sorted(kern, key=lambda x: -x[2])[:12]:
            say(f"    {ms:9.4f} ms {100 * ms / k_ms:5.1f}% x{n:<4d} "
                f"{name[:110]}")
        del g, b_
    return placed


def calibrate(dev, say, card: str, placed: list, cfg) -> list:
    """The calibration path: ``default_suite(smoke=True)`` and the fp32
    GEMMs at ``CAL_BIG``, all through the blocked matmul's f32 kernel,
    fitted against ``h100_sxm_fp32`` into a registry entry in a temporary
    directory; then the train steps of ``placed`` on both planes.  Returns
    the blocked matmul's launches by variant in the suite (read before the
    per-launch timing below) and the f32 kernel's summary rows, each size's
    launches counted from the suite's calls."""
    import tempfile
    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)

    from repro_torch.core.hardware import (H100_SXM, H100_SXM_FP32,
                                           get_hardware)
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.ref import ref_matmul
    from repro_torch.measure import calibrate as cal
    from repro_torch.models.mlp_dlrm import analytic_work_unit
    from repro_torch.measure import microbench
    from repro_torch.measure.timers import kernel_ms

    passes, r = 3, 9
    suite = microbench.default_suite(smoke=True, passes=passes, repeats=r,
                                     device=dev)
    big = microbench.matmul_benches(CAL_BIG, repeats=r, device=dev)
    torch.cuda.synchronize()
    launched = dict(blocked_matmul.launches_by_variant)
    # each bench: a probe call, 2 warmups and r timed calls, in each pass
    calls = {s: passes * (3 + r) for s in microbench.SMOKE_MATMUL_SIZES}
    calls.update({s: 3 + r for s in CAL_BIG})
    for m in suite + big:
        spec = H100_SXM_FP32 if m.category != "memory" else H100_SXM
        a = analyze(m.work, spec)
        print(json.dumps({**m.to_dict(), "card": card, "bound_spec": spec.name,
                          "bound_s": a.runtime, "bound_by": a.bottleneck.value,
                          "share_of_bound": a.runtime / m.seconds}))
    fit = [m for m in suite if m.category != "step"] + big
    steps = [m for m in suite if m.category == "step"]
    calib = cal.fit_ceilings(fit, H100_SXM_FP32, validation=steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = calib.save(tmp)
        loaded = get_hardware(H100_SXM_FP32.name, calibrated=True,
                              registry_dir=tmp)
    check(loaded == calib.spec(), "the registry entry does not load back")
    for line in calib.summary().splitlines():
        say(line)
    say(f"wrote {os.path.basename(path)} (to a temporary directory); NET "
        f"ceiling: {calib.net_bw:.4g} B/s, {calib.sources['net_bw']} (one "
        f"rank, no collective benches)")
    check(calib.sources["net_bw"] == "datasheet"
          and calib.sources["peak_flops"] == "measured"
          and calib.sources["hbm_bw"] == "measured",
          f"sources {calib.sources}")
    for name, e in calib.errors("validation").items():
        say(f"  validation {name}: model {100 * e:+.1f}% against measured")

    # each step as counted (eager traffic) and in the paper's accounting
    # (6BW²L, the weights read once), on the datasheet plane and on the
    # fitted one (an fp32 ceiling: the GEMMs it was fitted on are fp32)
    fitted = calib.spec()
    for B, work, host_s in placed:
        F, B_M, _ = analytic_work_unit(B, W, L)
        for w in (work, WorkUnit(f"paper_mlp_b{B}", F, B_M, 0.0)):
            for spec in (H100_SXM, fitted):
                a = analyze(w, spec)
                say(f"  train step B={B} on {spec.name}: {a.summary()}; "
                    f"bound {a.runtime * 1e3:.4f} ms = "
                    f"{100 * a.runtime / host_s:.1f}% of the host median "
                    f"{host_s * 1e3:.4f} ms")

    rows = []
    for s in microbench.SMOKE_MATMUL_SIZES + CAL_BIG:
        gen = torch.Generator(device=dev).manual_seed(s)
        a_ = torch.randn((s, s), generator=gen, device=dev)
        b_ = torch.randn((s, s), generator=gen, device=dev)
        k_ms = kernel_ms(lambda i: blocked_matmul(a_, b_), iters=20)
        p_ms = kernel_ms(lambda i: ref_matmul(a_, b_), iters=20)
        lib_ms = kernel_ms(lambda i: torch.mm(a_, b_), iters=20)
        got, want = blocked_matmul(a_, b_), ref_matmul(a_, b_)
        err_abs, err = max_abs(got, want), rel_err(got, want)
        check(err < TOL[torch.float32],
              f"f32 blocked matmul disagrees at {s}^3: {err}")
        flops, nbytes = 2.0 * s ** 3, 3.0 * 4 * s * s
        b_ms, b_by = bound_of(flops, nbytes, H100_SXM_FP32)
        rows.append({
            "path": "calibrate", "shape": [s, s, s], "dtype": "f32",
            "act": None, "launches": calls[s], "kernel_ms": k_ms,
            "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err_abs, "flops": flops,
            "bytes": nbytes})
        say(f"  blocked_matmul f32 {s}^3 per launch: kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
            f"library torch.mm fp32 (TF32 off) {lib_ms:.4f} ms "
            f"({k_ms / lib_ms:.2f}x); bound {b_ms:.4f} ms ({b_by}, "
            f"h100_sxm_fp32), kernel at {100 * b_ms / k_ms:.1f}% of bound; "
            f"{calls[s]} calibration launches; rel_err {err:.3e}")
    return launched, rows


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
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ref import ref_flash_attention, ref_matmul
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)

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
            var = bm.variant(M, N, K, dtype, True)   # fresh tensors: aligned
            cases = [(act, bias) for act in ACTS] + [("relu", None)]
            for act, bz in cases:
                before = dict(blocked_matmul.launches_by_variant)
                got = blocked_matmul(a, b, bias=bz, act=act)
                want = ref_matmul(a, b, bias=bz, act=act)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                name = (f"{str(dtype)[6:]} ({M},{K},{N}) act={act} "
                        f"bias={bz is not None} {var}")
                say(f"  {name}: rel_err {err:.3e} (tol {TOL[dtype]:g})")
                check(blocked_matmul.launches_by_variant[var]
                      == before[var] + 1, f"{name}: not one {var} launch")
                check(got.shape == (M, N) and torch.isfinite(got).all().item(),
                      f"kernel output malformed: {name}")
                check(err < TOL[dtype], f"kernel disagrees: {name}: {err}")
                worst[(dtype, var)] = max(worst.get((dtype, var), 0.0), err)
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
        f"{str(d)[6:]} {var} {v:.3e}" for (d, var), v in worst.items()))

    # ---- 4. flash attention parity ----------------------------------------------
    phase("flash_parity")
    worst = {}

    def flash_case(name, dtype, call, want, dh):
        """One wrapper call: it must take the variant the rule names, be
        finite, and agree with ``want`` row by row."""
        var = fa.variant(dtype, dh, True)   # fresh tensors: TMA reads them
        before = dict(flash_attention_bhsd.launches_by_variant)
        got = call()
        torch.cuda.synchronize()
        err = row_rel_err(got, want)
        name = f"{str(dtype)[6:]} {name} {var}"
        say(f"  {name}: row_rel_err {err:.3e} (tol {FLASH_TOL[dtype]:g})")
        check(flash_attention_bhsd.launches_by_variant
              == {**before, var: before[var] + 1}, f"{name}: not one {var} launch")
        check(got.shape == want.shape and torch.isfinite(got).all().item(),
              f"flash output malformed: {name}")
        check(err < FLASH_TOL[dtype], f"flash kernel disagrees: {name}: {err}")
        worst[(dtype, var)] = max(worst.get((dtype, var), 0.0), err)
        return got

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, K, dh, causal, window in FLASH_SHAPES:
            q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=dev)
                       .to(dtype) for n in (H, K, K))
            got = flash_case(
                f"B{B} S{S} H{H} K{K} dh{dh} causal={causal} window={window}",
                dtype,
                lambda: ops.flash_attention(q, k, v, causal=causal,
                                            window=window),
                ref_flash_attention(q, k, v, causal=causal, window=window), dh)
            check(got.is_contiguous(), "flash output not contiguous")
        # the (B, H, S, dh) entry point, keys at or past seq_len masked: junk
        # 1e4 in k; NaN in k and v (the kernels must never read them into a
        # product: the reference gets the same keys with the junk zeroed);
        # seq_len 0 (every row sees no key: 0)
        for junk, seq_len in ((1e4, 300), (float("nan"), 300),
                              (float("nan"), 0)):
            q, k, v = (torch.randn((2, n, 384, 64), generator=gen, device=dev)
                       .to(dtype) for n in (6, 2, 2))
            clean_k, clean_v = k.clone(), v.clone()
            clean_k[:, :, seq_len:] = 0.0
            clean_v[:, :, seq_len:] = 0.0
            k[:, :, seq_len:] = junk
            if junk != junk:
                v[:, :, seq_len:] = junk
            want = ref_flash_attention(
                q.transpose(1, 2), clean_k.transpose(1, 2),
                clean_v.transpose(1, 2), causal=True,
                seq_len=seq_len).transpose(1, 2)
            got = flash_case(
                f"flash_attention_bhsd (2,6,384,64) seq_len={seq_len} "
                f"junk {junk:g}", dtype,
                lambda: flash_attention_bhsd(q, k, v, causal=True,
                                             seq_len=seq_len), want, 64)
            if seq_len == 0:
                check(torch.equal(got, torch.zeros_like(got)),
                      f"seq_len 0 {dtype}: rows that see no key are not 0")
    say("worst row_rel_err: " + ", ".join(
        f"{str(d)[6:]} {var} {v:.3e}" for (d, var), v in worst.items()))

    # ---- 5. mlp_serve: the first main path ----------------------------------------
    phase("mlp_serve")
    from repro_torch.configs import get_config
    from repro_torch.convert import mlp_params_from_numpy
    from repro_torch.models import mlp_dlrm

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("dlrm-mlp").replace(use_kernel_matmul=True)
    plain_cfg = cfg.replace(use_kernel_matmul=False)
    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)
    rng = np.random.default_rng(0)
    params = mlp_params_from_numpy(dlrm_tree(cfg, rng), device=dev)
    feats = {B: torch.from_numpy(rng.standard_normal((B, W), np.float32)).to(dev)
             for B in BATCHES}
    say(f"dlrm-mlp {L} x {W}, compute {str(cfg.compute_dtype)[6:]}, "
        f"params {str(cfg.param_dtype)[6:]}, batches {BATCHES}")

    # the main path: each batch scored once through the kernel path
    blocked_matmul.launches = 0
    blocked_matmul.launches_by_variant = dict.fromkeys(bm.VARIANTS, 0)
    logits = {}
    per_forward = []
    for B in BATCHES:
        before = blocked_matmul.launches
        logits[B] = mlp_dlrm.forward(params, feats[B], cfg)
        per_forward.append(blocked_matmul.launches - before)
    torch.cuda.synchronize()
    main_launches = blocked_matmul.launches
    mlp_variants = dict(blocked_matmul.launches_by_variant)
    say(f"launches per forward {per_forward}, main path total {main_launches}"
        f", by variant {mlp_variants}")
    check(per_forward == [L] * len(BATCHES),
          f"expected {L} kernel launches per forward, got {per_forward}")
    check(mlp_variants == {**dict.fromkeys(bm.VARIANTS, 0),
                           "sm90": L * len(BATCHES)},
          f"every mlp_serve launch must take the sm90 kernel: {mlp_variants}")

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

    cast_ms = kernel_ms(casts, iters=10)
    per_batch = []
    for B in BATCHES:
        h = feats[B].to(dt)
        # rotate through the 8 layers' weights, as the forward does, so no
        # launch finds its 32 MB weight in L2 from the launch before
        k_ms = kernel_ms(lambda i: blocked_matmul(
            h, w_c[i % L], bias=b_c[i % L], act="relu"), iters=40)
        p_ms = kernel_ms(lambda i: ref_matmul(
            h, w_c[i % L], bias=b_c[i % L], act="relu"), iters=40)
        lib_ms = kernel_ms(lambda i: torch.relu(torch.addmm(
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
        fwd_kern = kernel_ms(lambda i: mlp_dlrm.forward(params, feats[B], cfg),
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
            "path": "mlp_serve", "shape": [B, W, W], "act": "relu",
            "launches": L, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": layer.runtime * 1e3,
            "bound_by": "bytes" if layer.bottleneck.value == "memory"
            else "operations", "max_abs_err": err_abs,
            "flops": layer_flops, "bytes": layer_bytes})
        say(f"  B={B} per layer: kernel {k_ms:.4f} ms "
            f"({layer_flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
            f"library addmm+relu {lib_ms:.4f} ms; bound "
            f"{layer.runtime * 1e3:.4f} ms ({layer.bottleneck.value}), "
            f"kernel at {100 * layer.runtime * 1e3 / k_ms:.1f}% of bound; "
            f"max_abs_err {err_abs:.3e}")
        say(f"  B={B} forward: host median {fwd.median * 1e3:.4f} ms, "
            f"p90 {fwd_p90 * 1e3:.4f} ms (n={len(fwd.samples)}), "
            f"{B / fwd.median:.0f} requests/s; card {fwd_ev:.4f} ms "
            f"(kernels {fwd_kern:.4f} ms), "
            f"plain path host {fwd_plain.median * 1e3:.4f} ms; "
            f"{fwd_flops / fwd.median / 1e12:.1f} TFLOP/s; "
            f"{whole.summary()}; at {100 * whole.runtime / fwd.median:.1f}% "
            f"of bound; weight cast {cast_ms:.4f} ms = "
            f"{100 * cast_ms / fwd_ev:.1f}% of the forward")
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"peak memory allocated {peak / 1e9:.3f} GB; weight casts "
        f"{cast_ms:.4f} ms per forward (bound "
        f"{L * 6.0 * (W * W + W) / H100_SXM.hbm_bw * 1e3:.4f} ms)")

    # ---- 6. lm_prefill: the second main path ----------------------------------------
    phase("lm_prefill")
    import torch.nn.functional as F

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params

    lm_cfg = get_config("smollm-135m").replace(use_flash=True)
    lm_plain = lm_cfg.replace(use_flash=False)
    lm_kmm = lm_cfg.replace(use_kernel_matmul=True)
    NL, d, V = lm_cfg.n_layers, lm_cfg.d_model, lm_cfg.vocab_size
    H, K, dh, f = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.dh, lm_cfg.d_ff
    bf16 = lm_cfg.compute_dtype
    t0 = time.perf_counter()
    lm_params = lm_params_from_numpy(
        smollm_tree(lm_cfg, np.random.default_rng(0)), device=dev)
    n_params = count_params(lm_params)
    tok_rng = np.random.default_rng(1)
    tokens = {bs: torch.from_numpy(tok_rng.integers(0, V, bs)).to(dev)
              for bs in PREFILL}
    say(f"smollm-135m: {NL} layers, d {d}, {H} query / {K} kv heads, dh {dh}, "
        f"d_ff {f}, vocab {V}, tied embeddings; {n_params} fp32 params from "
        f"numpy seed 0 in {time.perf_counter() - t0:.2f}s; compute "
        f"{str(bf16)[6:]}; batches {PREFILL}")

    # the main path: each batch prefilled once with use_flash, and the timed
    # batch once more with the FFN products in the blocked-matmul kernel too
    runs = [(bs, lm_cfg) for bs in PREFILL] + [(PREFILL[0], lm_kmm)]
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
    blocked_matmul.launches = 0
    blocked_matmul.launches_by_variant = dict.fromkeys(bm.VARIANTS, 0)
    lm_logits, per_fwd = [], []
    for bs, c in runs:
        f0, m0 = flash_attention_bhsd.launches, blocked_matmul.launches
        lm_logits.append(transformer.forward(lm_params, tokens[bs], c)[0])
        per_fwd.append((flash_attention_bhsd.launches - f0,
                        blocked_matmul.launches - m0))
    torch.cuda.synchronize()
    lm_launches = {"flash_attention_bhsd": flash_attention_bhsd.launches,
                   "blocked_matmul": blocked_matmul.launches}
    lm_variants = dict(blocked_matmul.launches_by_variant)
    flash_variants = dict(flash_attention_bhsd.launches_by_variant)
    say(f"(flash, blocked_matmul) launches per forward {per_fwd}; main path "
        f"totals {lm_launches}; flash by variant {flash_variants}; "
        f"blocked_matmul by variant {lm_variants}")
    check(per_fwd == [(NL, 0)] * len(PREFILL) + [(NL, 3 * NL)],
          f"expected {NL} flash launches per forward and {3 * NL} blocked "
          f"matmul launches with use_kernel_matmul, got {per_fwd}")
    check(lm_variants == {**dict.fromkeys(bm.VARIANTS, 0), "sm90": 3 * NL},
          f"every lm_prefill blocked-matmul launch must take the sm90 "
          f"kernel: {lm_variants}")
    check(flash_variants == {**dict.fromkeys(fa.VARIANTS, 0),
                             "sm90": NL * len(runs)},
          f"every lm_prefill flash launch must take the sm90 kernel: "
          f"{flash_variants}")

    for (bs, c), got in zip(runs, lm_logits):
        B, S = bs
        label = f"B={B} S={S}" + (" use_kernel_matmul" if c.use_kernel_matmul
                                  else "")
        check(got.shape == (B, S, V) and torch.isfinite(got).all().item(),
              f"prefill logits malformed at {label}")
        want = transformer.forward(lm_params, tokens[bs], lm_plain)[0]
        err = row_rel_err(got, want)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        say(f"  {label}: logits kernel path vs plain path row_rel_err "
            f"{err:.3e} (tol {LM_TOL:g}), max|logit| "
            f"{want.abs().max().item():.4g}, argmax agrees on "
            f"{100 * agree:.2f}% of rows")
        check(err < LM_TOL, f"prefill logits disagree at {label}: {err}")
        del want
    del lm_logits, got          # 1.6 GB each at (8, 2048): not in the peak below

    # the timed batch: host clock (each sample ends in a synchronize) and
    # card clock; analytic F and B_M placed on the h100_sxm plane
    B0, S0 = PREFILL[0]
    T = B0 * S0
    toks = tokens[PREFILL[0]]
    torch.cuda.reset_peak_memory_stats(dev)
    transformer.forward(lm_params, toks, lm_cfg)
    torch.cuda.synchronize()
    lm_peak = torch.cuda.max_memory_allocated(dev)
    lm_fwd = time_callable(transformer.forward, lm_params, toks, lm_cfg,
                           device=dev, repeats=30, warmup=3)
    lm_p90 = float(np.percentile(lm_fwd.samples, 90))
    lm_ev = cuda_event_ms(lambda i: transformer.forward(lm_params, toks, lm_cfg),
                          iters=10)
    kmm_ev = cuda_event_ms(lambda i: transformer.forward(lm_params, toks, lm_kmm),
                           iters=10)
    plain_ev = cuda_event_ms(
        lambda i: transformer.forward(lm_params, toks, lm_plain), iters=5)
    attn_flops, _ = attn_work(B0, S0, H, K, dh, True, 2)
    layer_flops = (2.0 * T * d * (2 * lm_cfg.q_dim + 2 * lm_cfg.kv_dim)
                   + 3 * 2.0 * T * d * f + attn_flops)
    lm_flops = NL * layer_flops + 2.0 * T * d * V        # + tied head
    # least bytes: fp32 params read once, bf16 logits written, tokens read
    lm_bytes = 4.0 * n_params + 2.0 * T * V + 8.0 * T
    lm_bound = analyze(WorkUnit(f"smollm_prefill_b{B0}_s{S0}", lm_flops,
                                lm_bytes, 0.0), H100_SXM)
    say(f"  B={B0} S={S0} forward (use_flash): host median "
        f"{lm_fwd.median * 1e3:.4f} ms, p90 {lm_p90 * 1e3:.4f} ms "
        f"(n={len(lm_fwd.samples)}), {T / lm_fwd.median:.0f} tokens/s; card "
        f"{lm_ev:.4f} ms; {lm_flops / lm_fwd.median / 1e12:.1f} TFLOP/s; "
        f"{lm_bound.summary()}; at "
        f"{100 * lm_bound.runtime / lm_fwd.median:.1f}% of bound; peak memory "
        f"allocated {lm_peak / 1e9:.3f} GB")
    say(f"  B={B0} S={S0} forward card time: use_flash {lm_ev:.4f} ms, "
        f"use_flash + use_kernel_matmul {kmm_ev:.4f} ms, plain path "
        f"{plain_ev:.4f} ms")

    # where the card's time goes in one forward, with and without the FFN
    # products in the blocked matmul: every kernel the profiler saw, by
    # name, summed; their total against the unprofiled card time (a row of
    # a CPU op also counts its kernels' time as its own, so only the
    # device's rows are summed)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for label, c, card_ms in (
            ("use_flash", lm_cfg, lm_ev),
            ("use_flash + use_kernel_matmul", lm_kmm, kmm_ev)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            transformer.forward(lm_params, toks, c)
            torch.cuda.synchronize()
        kern = [(r.key, r.count, r.self_device_time_total / 1e3)
                for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA]
        kern_ms = sum(ms for _, _, ms in kern)
        check(kern_ms > 0, "the profiler saw no kernel time on the card")
        say(f"  B={B0} S={S0} profile of one forward ({label}): {len(kern)} "
            f"kernel names, {sum(n for _, n, _ in kern)} launches, "
            f"{kern_ms:.4f} ms of kernels = {100 * kern_ms / card_ms:.1f}% of "
            f"the unprofiled card time {card_ms:.4f} ms; by name, most first:")
        for name, n, ms in sorted(kern, key=lambda x: -x[2])[:20]:
            say(f"    {ms:9.4f} ms {100 * ms / kern_ms:5.1f}% x{n:<4d} "
                f"{name[:110]}")

    # per launch, at each main-path shape: the kernel, its plain version,
    # the earlier mma design (called past the wrapper, in turns: the kernel,
    # mma, the kernel again), and the library's one call (SDPA, timed as a
    # yardstick only: the port never calls it); q, k, v of (8, 2048) are
    # 31 MB, so they sit in L2, as they do in the forward, which has just
    # written them
    flash_fns = fa._launcher()
    flash_rows = []
    for B, S in PREFILL:
        n_launch = NL * sum(1 for bs, _ in runs if bs == (B, S))
        q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=dev).to(bf16)
                   for n in (H, K, K))
        k_ms = kernel_ms(lambda i: ops.flash_attention(q, k, v), iters=20)
        mma_ms = kernel_ms(lambda i: flash_option(flash_fns, "mma", q, k, v),
                           iters=20)
        k_ms_again = kernel_ms(lambda i: ops.flash_attention(q, k, v), iters=20)
        p_ms = kernel_ms(lambda i: ref_flash_attention(q, k, v), iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = kernel_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        want = ref_flash_attention(q, k, v)
        got = ops.flash_attention(q, k, v)
        err_abs, err = max_abs(got, want), row_rel_err(got, want)
        check(err < FLASH_TOL[bf16],
              f"flash kernel disagrees at the prefill's ({B},{S}): {err}")
        e_mma = row_rel_err(flash_option(flash_fns, "mma", q, k, v), want)
        check(e_mma < FLASH_TOL[bf16],
              f"flash mma disagrees at the prefill's ({B},{S}): {e_mma}")
        flops, nbytes = attn_work(B, S, H, K, dh, True, 2)
        b_ms, b_by = bound_of(flops, nbytes, H100_SXM)
        flash_rows.append({
            "path": "lm_prefill", "shape": [B, S, H, K, dh], "causal": True,
            "launches": n_launch, "kernel_ms": k_ms,
            "kernel_ms_again": k_ms_again, "mma_ms": mma_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err_abs, "flops": flops, "bytes": nbytes})
        say(f"  flash B={B} S={S} H={H} K={K} dh={dh} per launch: kernel "
            f"(sm90) {k_ms:.4f} / {k_ms_again:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), earlier mma design "
            f"{mma_ms:.4f} ms ({mma_ms / k_ms:.2f}x the kernel); plain "
            f"{p_ms:.4f} ms, library SDPA {lib_ms:.4f} ms "
            f"({k_ms / lib_ms:.2f}x); bound {b_ms:.4f} ms ({b_by}), kernel at "
            f"{100 * b_ms / k_ms:.1f}% of bound; {n_launch} main-path "
            f"launches; max_abs_err {err_abs:.3e}, row_rel_err {err:.3e} "
            f"(mma {e_mma:.3e}; tol {FLASH_TOL[bf16]:g})")
    attn_ms = NL * flash_rows[0]["kernel_ms"]
    say(f"  B={B0} S={S0}: {NL} flash launches take {attn_ms:.4f} ms = "
        f"{100 * attn_ms / lm_ev:.1f}% of the forward's card time")

    # the FFN products of the use_kernel_matmul forward, per launch
    ffn = {n: lm_params["blocks"][0]["ffn"][n].to(bf16)
           for n in ("w_gate", "w_up", "w_down")}
    x_in = torch.randn((T, d), generator=gen, device=dev).to(bf16)
    x_mid = torch.randn((T, f), generator=gen, device=dev).to(bf16)
    ffn_rows = []
    for a_, b_, act in ((x_in, ffn["w_gate"], "silu"), (x_in, ffn["w_up"], None),
                        (x_mid, ffn["w_down"], None)):
        M, Kd = a_.shape
        N = b_.shape[1]
        k_ms = kernel_ms(lambda i: blocked_matmul(a_, b_, act=act), iters=20)
        p_ms = kernel_ms(lambda i: ref_matmul(a_, b_, act=act), iters=20)
        lib_ms = kernel_ms(
            (lambda i: F.silu(torch.mm(a_, b_))) if act
            else (lambda i: torch.mm(a_, b_)), iters=20)
        got, want = blocked_matmul(a_, b_, act=act), ref_matmul(a_, b_, act=act)
        err_abs, err = max_abs(got, want), rel_err(got, want)
        check(err < TOL[bf16],
              f"blocked matmul disagrees at the FFN's ({M},{Kd},{N}): {err}")
        flops, nbytes = 2.0 * M * Kd * N, 2.0 * (M * Kd + Kd * N + M * N)
        b_ms, b_by = bound_of(flops, nbytes, H100_SXM)
        ffn_rows.append({
            "path": "lm_prefill", "shape": [M, Kd, N], "act": act,
            "launches": NL, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err_abs, "flops": flops, "bytes": nbytes})
        say(f"  blocked_matmul ({M},{Kd},{N}) act={act} per launch: kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.4f} ms, library mm{'+silu' if act else ''} "
            f"{lib_ms:.4f} ms ({k_ms / lib_ms:.2f}x); bound "
            f"{b_ms:.4f} ms "
            f"({b_by}); max_abs_err {err_abs:.3e}, rel_err {err:.3e} "
            f"(tol {TOL[bf16]:g})")
    del got, want

    # ---- 7. mlp_train: the third main path --------------------------------------
    phase("mlp_train")
    for counted in (blocked_matmul, flash_attention_bhsd):
        counted.launches = 0
    placed = mlp_train(dev, say, get_config("dlrm-mlp"),
                       np.random.default_rng(2))
    torch.cuda.synchronize()
    say(f"kernel launches during mlp_train: blocked_matmul "
        f"{blocked_matmul.launches}, flash {flash_attention_bhsd.launches}")
    check(blocked_matmul.launches == 0 and flash_attention_bhsd.launches == 0,
          "the train step reached a forward-only kernel")

    # ---- 8. calibrate: the fourth main path -------------------------------------
    phase("calibrate")
    blocked_matmul.launches = 0
    blocked_matmul.launches_by_variant = dict.fromkeys(bm.VARIANTS, 0)
    flash_attention_bhsd.launches = 0
    cal_variants, f32_rows = calibrate(dev, say, card, placed,
                                       get_config("dlrm-mlp"))
    cal_launches = sum(r["launches"] for r in f32_rows)
    say(f"blocked_matmul launches during calibrate, by variant: "
        f"{cal_variants} (the suite's GEMMs: {cal_launches})")
    check(cal_variants == {**dict.fromkeys(bm.VARIANTS, 0), "f32": cal_launches}
          and flash_attention_bhsd.launches == 0,
          f"the calibration GEMMs must each launch the f32 kernel once: "
          f"{cal_variants}")

    # ---- 9. tile_options ------------------------------------------------------
    phase("tile_options")
    # the sm90 kernel at every main-path shape under each tile width and
    # order, beside tile_plan's choice (PERF.md reads the rule off these);
    # each call takes the next of 8 weights, as a forward's layers do
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, sm90 = bm._launcher()
    for row in per_batch + ffn_rows:
        M, Kd, N = row["shape"]
        a_ = torch.randn((M, Kd), generator=gen, device=dev).to(bf16)
        bs_ = [(torch.randn((Kd, N), generator=gen, device=dev)
                / Kd ** 0.5).to(bf16) for _ in range(L)]
        bz = (torch.randn((N,), generator=gen, device=dev).to(bf16)
              if row["act"] == "relu" else None)
        rule = bm.tile_plan(M, N, Kd, n_sms)
        timed = []
        for bn in bm.SM90_BN:
            for n_fastest in (True, False):
                plan = bm.Plan(bn, n_fastest)
                ms = kernel_ms(lambda i: sm90_option(
                    sm90, a_, bs_[i % L], bz, row["act"], plan), iters=40)
                timed.append((ms, plan))
        best_ms, best = min(timed)
        say(f"  ({M},{Kd},{N}) act={row['act']}: rule {tuple(rule)} "
            f"{dict((p, t) for t, p in timed)[rule]:.4f} ms; best "
            f"{tuple(best)} {best_ms:.4f} ms; all (bn, n_fastest) ms: "
            + ", ".join(f"{tuple(p)} {t:.4f}" for t, p in timed))
    del a_, bs_

    # ---- 10. microbench -------------------------------------------------------
    phase("microbench")
    # host cost of one launch through the wrapper (checks, allocation,
    # tensor-map encoding, ctypes call), enqueue only, beside one torch call
    # of the same shape; at the B=256 layer, beside the kernel's card time
    tiny = torch.randn((64, 64), device=dev)
    tiny16 = tiny.to(bf16)
    h256 = feats[256].to(bf16)
    for label, fn in (
            ("blocked_matmul f32 64x64x64",
             lambda: blocked_matmul(tiny, tiny)),
            ("torch.mm f32 64x64x64", lambda: torch.mm(tiny, tiny)),
            ("blocked_matmul sm90 64x64x64",
             lambda: blocked_matmul(tiny16, tiny16)),
            ("torch.mm bf16 64x64x64", lambda: torch.mm(tiny16, tiny16)),
            ("blocked_matmul sm90 (256,4096,4096) relu",
             lambda: blocked_matmul(h256, w_c[0], bias=b_c[0], act="relu")),
            ("torch.addmm+relu (256,4096,4096)",
             lambda: torch.relu(torch.addmm(b_c[0], h256, w_c[0])))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
        say(f"host enqueue per call, {label}: {host_us:.2f} us")
    ev_ms = cuda_event_ms(lambda i: blocked_matmul(
        h256, w_c[i % L], bias=b_c[i % L], act="relu"), iters=40)
    say(f"card time per call, blocked_matmul sm90 (256,4096,4096) relu: "
        f"kernel {per_batch[0]['kernel_ms'] * 1e3:.2f} us, back-to-back calls "
        f"between CUDA events {ev_ms * 1e3:.2f} us")

    # ---- summary ------------------------------------------------------------------
    def entry(name: str, source: str, replaces: str, launches: int,
              rows: list, by_variant: dict) -> dict:
        """Times are totals over the kernel's own main-path launches: each
        per-launch time times the launches at that shape.  The bound: the
        operations over the peak of their type (bf16 tensor cores, fp32
        CUDA cores) against all the bytes over the memory rate."""
        check(sum(r["launches"] for r in rows) == launches,
              f"{name}: timed rows cover {sum(r['launches'] for r in rows)} "
              f"launches, the main paths made {launches}")
        peak = {"bf16": H100_SXM.peak_flops, "f32": H100_SXM_FP32.peak_flops}
        t_ops = sum(r["launches"] * r["flops"] / peak[r.get("dtype", "bf16")]
                    for r in rows)
        t_bytes = sum(r["launches"] * r["bytes"] for r in rows) \
            / H100_SXM.hbm_bw
        b_ms = max(t_ops, t_bytes) * 1e3
        b_by = "operations" if t_ops >= t_bytes else "bytes"
        return {
            "name": name, "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches,
            "launches_by_variant": by_variant,
            "times": "ms, plain_ms, library_ms and bound_ms are totals over "
                     "the kernel's own launches on the main paths",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["launches"] * r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["launches"] * r["plain_ms"] for r in rows),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sum(r["launches"] * r["library_ms"] for r in rows),
            **({"mma_ms": sum(r["launches"] * r["mma_ms"] for r in rows)}
               if all("mma_ms" in r for r in rows) else {}),
            "card": card, "per_launch": rows}

    summary = {"kernels": [
        entry("blocked_matmul",
              "src/repro_torch/kernels/csrc/blocked_matmul.cu",
              "src/repro/kernels/blocked_matmul.py:57",
              main_launches + lm_launches["blocked_matmul"] + cal_launches,
              per_batch + ffn_rows + f32_rows,
              {v: mlp_variants[v] + lm_variants[v] + cal_variants[v]
               for v in bm.VARIANTS}),
        entry("flash_attention_bhsd",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:75",
              lm_launches["flash_attention_bhsd"], flash_rows,
              flash_variants),
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
