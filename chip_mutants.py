#!/usr/bin/env python3
"""Planted faults in both CUDA kernels, held to chip_smoke.py's checks.

    python3 chip_mutants.py        # from the repository root; needs one card

A check that passes the real kernel shows little unless it fails a wrong
one.  Each mutant is a kernel source with one planted fault:

  flash_attention.cu (the sm90 kernel; the first two are wrong in rows
  past key 1024 only, where an output row averages ~1000 keys and is small)
    skip_tile_16    the kv tile at keys 1024-1151 (tile 16 of 64 keys in the
                    first design) is skipped when a later tile follows it
    stale_alpha_16  at the kv tiles from key 1024 up, acc is not rescaled by
                    alpha when a tile raises the row's running max
    release_v_early each V stage is released as soon as it has landed, a tile
                    before the P.V wgmma that reads it is issued, so the
                    producer's next TMA load may overwrite it first (released
                    right after that wgmma's issue instead, it read the same
                    as the real kernel: the load lands after the read)
  blocked_matmul.cu (the sm90 kernel)
    release_early   each ring stage is released one k-step early: right
                    after the wgmma that reads it is issued, not once it has
                    retired, so the producer's next TMA load may overwrite
                    it while it is read
    skip_last_k     the last k-step's wgmma is skipped (its stage is still
                    waited for and released)
  blocked_matmul.cu (the f32 kernel)
    f32_release_early  four K tiles in flight in a ring of four stages: the
                    stage of tile kt is refilled with tile kt + 4 right
                    after the barrier, while tile kt is read from it
    f32_skip_last_k    a ragged last K tile (K % 16 != 0) is never read
    f32_edge_mask      A's rows are copied up to M - 1 only: the last output
                    row misses A . B

Each mutant is compiled from an edited copy of the source written under
``build/mutants/`` (the checkout's sources stay as they are; the copies
include ``csrc/sm90.cuh``) and swapped in for the real kernel, the real
kernel first.  A flash mutant is held to the kernel alone at the
smollm-135m prefill shape (8, 2048, 9/3 heads, dh 64, bf16) and to the
whole prefill forward at (8, 2048) (``row_rel_err`` against FLASH_TOL and
LM_TOL).  An sm90 GEMM mutant is held to the kernel alone
at the ten main-path shapes, the decode's four included (``rel_err``
against TOL), and to the logits of the dlrm-mlp forward at B = 256 and 4096
(LOGIT_TOL), of the prefill forward at (8, 2048) with ``use_kernel_matmul``
(LM_TOL) and of DECODE_STEPS teacher-forced decode steps at B = 8 with it
(DECODE_TOL).  An f32 mutant is
held to chip_smoke.py's fp32 checks: the fp32 parity shapes that take the
f32 kernel and the calibration sizes (``rel_err`` against TOL).

The same machinery builds design alternatives of the sm90 kernels, which
the real ones were chosen over; each must pass the kernel check at the
shapes it is timed at, beside the real kernel with the same tiles
(``kernel_ms``):

  flash_attention.cu
    q_rows_128      128-row q tiles at dh 64: two consumer warpgroups in one
                    block an SM (timed at the three prefill shapes)
    pingpong        at dh 128, the two consumer warpgroups take turns on
                    named barriers to issue their products (FlashAttention-
                    3's ping-pong) instead of issuing them when ready (timed
                    at (2, 2048, 9/3 heads, dh 128))
  blocked_matmul.cu
    split_k2/4/8    K split 2, 4 or 8 ways: each CTA sums one part of K
                    into an fp32 workspace the launcher allocates, and a
                    second kernel adds the parts, the bias and act (timed at
                    the memory-bound (256, 4096, 4096), where the 128-row
                    tiles alone fill few SMs; K a multiple of 64 * splits)
    act_switch      the epilogue switches on the activation per element, in
                    one instantiation, instead of one instantiation per act
    (the f32 kernel, timed at the calibration sizes)
    f32_tile_128x128, f32_tile_128x64, f32_tile_64x64
                    another tile (64x64 at 4 rows a thread) in place of
                    64x128, where the rule takes 64x128
    f32_bk32        K stages of 32 (3 of them) instead of 4 of 16
    f32_stages3, f32_stages6   3 or 6 stages of 16
    f32_no_pad      A's rows unpadded in shared memory (64 bytes apart)
    f32_split_k2/4/8   K split 2, 4 or 8 ways into an fp32 workspace the
                    launcher allocates, a second kernel adding the parts,
                    the bias and act (at 64^3-1024^3, where the rule's tiles
                    number fewer than the SMs)

Exits 0 when the real kernels pass every check, each flash mutant fails
both of its checks (the ring race: either), each sm90 GEMM mutant fails the
kernel check at some main-path shape, each f32 mutant fails an fp32 check,
and each alternative passes.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke     # also puts src/ on sys.path

#: teacher-forced decode steps (B = 8, cache 2048) an sm90 GEMM mutant's
#: logits are held to the prefill's over (DECODE_TOL)
DECODE_STEPS = 32

#: the f32 GEMM's planted faults (names start "f32_": they are held to the
#: fp32 checks, the others to the sm90 ones)
_F32_MUTANTS = {
    # 4 tiles in flight in a ring of 4: tile kt + 4 is copied into the stage
    # of tile kt right after the barrier, while tile kt is read from it
    "f32_release_early": [
        ("  for (int s = 0; s < S - 1; ++s) {\n    if (s < k_tiles)",
         "  for (int s = 0; s < S; ++s) {\n    if (s < k_tiles)"),
        ("cp_async_wait<S - 2>();", "cp_async_wait<S - 1>();"),
        ("if (kt + S - 1 < k_tiles) load_tile(kt + S - 1);",
         "if (kt + S < k_tiles) load_tile(kt + S);")],
    # a ragged last K tile (K % 16 != 0) is never read
    "f32_skip_last_k": [("  const int k_tiles = (K + BK - 1) / BK;\n",
                         "  const int k_tiles = K / BK;\n")],
    # A's rows are read up to M - 1: the last row of the output misses A . B
    "f32_edge_mask": [("const bool in = m0 + r < M && k0 + kc < K;",
                       "const bool in = m0 + r + 1 < M && k0 + kc < K;")],
}

#: source -> mutant name -> [(text of the kernel, its replacement), ...]
MUTANTS = {
    "flash_attention": {
        "skip_tile_16": [(
            "      if (tile_needs_mask(p, r0, k0))\n",
            "      if (k0 == 1024 && t + 1 < n) {  // every key masked\n"
            "        for (int i = 0; i < kSmBN / 2; ++i) sc[i] = kNegInf;\n"
            "        softmax_tile<false>(sc, m, l, alpha, row, k0, p, c2);\n"
            "      } else if (tile_needs_mask(p, r0, k0))\n")],
        "stale_alpha_16": [(
            "for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i / 2) % 2];",
            "for (int i = 0; i < DH / 2; ++i)\n"
            "          if ((kt_last - 1 - t) * kSmBN < 1024)\n"
            "            acc[i] *= alpha[(i / 2) % 2];")],
        "release_v_early": [
            ("        if (lane == 0) mbar_arrive(&v_empty[ps]);  // its P . V "
             "has retired\n", ""),
            ("      if (lane == 0) mbar_arrive(&v_empty[ps]);  // the last "
             "P . V retired\n", ""),
            ("      mbar_wait(&v_full[0], 0);\n",
             "      mbar_wait(&v_full[0], 0);\n"
             "      if (lane == 0) mbar_arrive(&v_empty[0]);\n"),
            ("        mbar_wait(&v_full[s], phase);\n",
             "        mbar_wait(&v_full[s], phase);\n"
             "        if (lane == 0) mbar_arrive(&v_empty[s]);\n")],
    },
    "blocked_matmul": {
        "release_early": [
            ("        if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);\n",
             "        if (lane == 0) mbar_arrive(&empty[s]);\n"),
            ("      if (lane == 0) mbar_arrive(&empty[prev]);\n", "")],
        "skip_last_k": [("for (int kk = 0; kk < kSmBK / 16; ++kk)",
                         "for (int kk = 0; kk < (ks + 1 < k_steps ? kSmBK / 16"
                         " : 0); ++kk)")],
        **_F32_MUTANTS,
    },
}


_SPLIT_KERNEL = "  const int tiles = m_tiles * n_tiles;\n"
_SPLIT_DECODE = (
    "    m0 = (n_fastest ? t / n_tiles : t % m_tiles) * kSmBM;\n"
    "    n0 = (n_fastest ? t % n_tiles : t / m_tiles) * BN;\n")
_SPLIT_STORE = """      {   // this K part's fp32 sums, for splitk_finish
        const int row0 = m0 + 64 * cw + 16 * warp + lane / 4;
        float* part = ws + (int64_t)(t / (m_tiles * n_tiles)) * M * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row0 + 8 * h < M && col < N)
              *reinterpret_cast<float2*>(part + (int64_t)(row0 + 8 * h) * N
                                         + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
"""
_SPLIT_FINISH = """// Adds the kSplits parts, the bias and act; one cast.  Four columns a thread.
__global__ void splitk_finish(const float* __restrict__ ws,
                              const __nv_bfloat16* __restrict__ bias,
                              __nv_bfloat16* __restrict__ C, int M, int N,
                              int act) {
  const int64_t MN = (int64_t)M * N;
  const int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= MN) return;
  float y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) y[c] = 0.0f;
  for (int s = 0; s < kSplits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + s * MN + i);
    y[0] += p.x; y[1] += p.y; y[2] += p.z; y[3] += p.w;
  }
  const int col = static_cast<int>(i % N);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    y[c] = apply_act(y[c] + (bias ? __bfloat162float(bias[col + c]) : 0.0f),
                     act);
  *reinterpret_cast<uint2*>(C + i) =
      make_uint2(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]));
}

"""
_SPLIT_LAUNCH = """  static float* ws = nullptr;   // the parts' fp32 sums, grown as needed
  static size_t ws_elems = 0;
  if ((size_t)kSplits * M * N > ws_elems) {
    cudaFree(ws);
    ws_elems = (size_t)kSplits * M * N;
    rc = cudaMalloc(&ws, ws_elems * sizeof(float));
    if (rc != cudaSuccess) return rc;
  }
  gemm_sm90_kernel<BN><<<grid, kSmThreads, Cfg::kSmem, stream>>>(
      ta, tb, bias, C, M, N, K, act, n_fastest, ws);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  splitk_finish<<<((int64_t)M * N / 4 + 255) / 256, 256, 0, stream>>>(
      ws, bias, C, M, N, act);
  return cudaGetLastError();
"""


def _split_k(n: int) -> list:
    return [
        ("constexpr int kBoxBytes = kSmBK * 64 * 2;",
         f"constexpr int kSplits = {n};\nconstexpr int kBoxBytes = kSmBK * 64 * 2;"),
        ("int act, int n_fastest) {", "int act, int n_fastest, float* ws) {"),
        (_SPLIT_KERNEL,
         "  const int tiles = m_tiles * n_tiles * kSplits;\n"
         "  const int k_per = k_steps / kSplits;\n"),
        (_SPLIT_DECODE, "    const int u = t % (m_tiles * n_tiles);\n"
         + _SPLIT_DECODE.replace("? t", "? u").replace(": t", ": u")),
        ("for (int ks = 0; ks < k_steps; ++ks) {\n          mbar_wait",
         "const int k0 = t / (m_tiles * n_tiles) * k_per;\n"
         "        for (int ks = k0; ks < k0 + k_per; ++ks) {\n          mbar_wait"),
        ("for (int ks = 0; ks < k_steps; ++ks) {\n        mbar_wait",
         "for (int ks = 0; ks < k_per; ++ks) {\n        mbar_wait"),
        ("      sm90_epilogue<BN>(acc, m0 + 64 * cw + 16 * warp + lane / 4, n0,"
         " M, N,\n                        bias, C, act);\n", _SPLIT_STORE),
        ("bool aligned(const void* p, uintptr_t bytes) {",
         _SPLIT_FINISH + "bool aligned(const void* p, uintptr_t bytes) {"),
        ("  gemm_sm90_kernel<BN><<<grid, kSmThreads, Cfg::kSmem, stream>>>(\n"
         "      ta, tb, bias, C, M, N, K, act, n_fastest);\n"
         "  return cudaGetLastError();\n", _SPLIT_LAUNCH),
        ("(tiles < sms[dev] ? tiles : sms[dev])",
         "(tiles * kSplits < sms[dev] ? tiles * kSplits : sms[dev])"),
    ]


_F32_SPLIT_FINISH = """// Adds the kSplits parts, the bias and act.  Four columns a thread.
__global__ void ring_splitk_finish(const float* __restrict__ ws,
                                   const float* __restrict__ bias,
                                   float* __restrict__ C, int M, int N,
                                   int act) {
  const int64_t MN = (int64_t)M * N;
  const int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= MN) return;
  float4 y = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < kSplits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + s * MN + i);
    y.x += p.x; y.y += p.y; y.z += p.z; y.w += p.w;
  }
  const int col = static_cast<int>(i % N);
  const float* bz = bias ? bias + col : nullptr;
  y.x = apply_act(y.x + (bz ? bz[0] : 0.0f), act);
  y.y = apply_act(y.y + (bz ? bz[1] : 0.0f), act);
  y.z = apply_act(y.z + (bz ? bz[2] : 0.0f), act);
  y.w = apply_act(y.w + (bz ? bz[3] : 0.0f), act);
  *reinterpret_cast<float4*>(C + i) = y;
}

"""
_F32_SPLIT_LAUNCH = """  static float* ws = nullptr;   // the parts' fp32 sums, grown as needed
  static size_t ws_elems = 0;
  if ((size_t)kSplits * M * N > ws_elems) {
    cudaFree(ws);
    ws_elems = (size_t)kSplits * M * N;
    rc = cudaMalloc(&ws, ws_elems * sizeof(float));
    if (rc != cudaSuccess) return rc;
  }
  gemm_f32_ring_kernel<BM, BN, TM>
      <<<static_cast<int>(tiles) * kSplits, Cfg::kThreads, Cfg::kSmem,
         stream>>>(a, b, bias, C, M, N, K, act, ws);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  ring_splitk_finish<<<((int64_t)M * N / 4 + 127) / 128, 128, 0, stream>>>(
      ws, bias, C, M, N, act);
  return cudaGetLastError();
"""


def _f32_split_k(n: int) -> list:
    """The f32 kernel with K split ``n`` ways: CTA ``part * tiles + t``
    sums its part of K's tiles for output tile t into an fp32 workspace the
    launcher allocates, and a second kernel adds the parts, the bias and
    act."""
    return [
        ("constexpr int kRingPadA = 4;",
         f"constexpr int kRingPadA = 4;\nconstexpr int kSplits = {n};"),
        ("                     int M, int N, int K, int act) {",
         "                     int M, int N, int K, int act, float* ws) {"),
        ("  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % "
         "n_tiles) * BN;\n",
         "  const int tiles = n_tiles * ((M + BM - 1) / BM);\n"
         "  const int part = blockIdx.x / tiles, t = blockIdx.x % tiles;\n"
         "  const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;\n"),
        ("  const int k_tiles = (K + BK - 1) / BK;\n",
         "  const int k_all = (K + BK - 1) / BK;\n"
         "  const int k_per = (k_all + kSplits - 1) / kSplits;\n"
         "  const int k_first = part * k_per;\n"
         "  const int k_tiles = max(0, min(k_all - k_first, k_per));\n"),
        ("    const int k0 = kt * BK;\n", "    const int k0 = (k_first + kt) * BK;\n"),
        ("  const int row0 = m0 + wm, col0 = n0 + wn;\n  switch (act) {",
         "  const int row0 = m0 + wm, col0 = n0 + wn;\n"
         "  ring_store_tile<TM, kNone>(acc, row0, col0, M, N, nullptr,\n"
         "                             ws + (int64_t)part * M * N);\n"
         "  if (ws == nullptr) switch (act) {"),
        ("bool aligned(const void* p, uintptr_t bytes) {",
         _F32_SPLIT_FINISH + "bool aligned(const void* p, uintptr_t bytes) {"),
        ("  gemm_f32_ring_kernel<BM, BN, TM>\n"
         "      <<<static_cast<int>(tiles), Cfg::kThreads, Cfg::kSmem, stream>>>(\n"
         "          a, b, bias, C, M, N, K, act);\n"
         "  return cudaGetLastError();\n", _F32_SPLIT_LAUNCH),
        ("  if (tiles > 0x7fffffff)", "  if (tiles * kSplits > 0x7fffffff)"),
    ]


#: the f32 GEMM's designs that lost.  A tile alternative runs in place of
#: the 64x128 tile (it is launched with the 64x128 tile's arguments).
_F32_ALTERNATIVES = {
    **{f"f32_tile_{bm_}x{bn_}": [("launch_ring<64, 128, 8>(",
                                  f"launch_ring<{bm_}, {bn_}, {tm}>(")]
       for bm_, bn_, tm in ((128, 128, 8), (128, 64, 8), (64, 64, 4))},
    "f32_bk32": [("constexpr int kRingBK = 16;", "constexpr int kRingBK = 32;"),
                 ("constexpr int kRingStages = 4;",
                  "constexpr int kRingStages = 3;")],
    "f32_stages3": [("constexpr int kRingStages = 4;",
                     "constexpr int kRingStages = 3;")],
    "f32_stages6": [("constexpr int kRingStages = 4;",
                     "constexpr int kRingStages = 6;")],
    "f32_no_pad": [("constexpr int kRingPadA = 4;",
                    "constexpr int kRingPadA = 0;")],
    **{f"f32_split_k{n}": _f32_split_k(n) for n in (2, 4, 8)},
}


#: FlashAttention-3's ping-pong in the flash kernel's two-warpgroup block:
#: each warpgroup waits for its turn (named barrier 1 + its index) before it
#: issues its products and passes the turn on once they are issued;
#: warpgroup 0 goes first, and its last wait takes warpgroup 1's last pass
_TURNS = """
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\\n" :: "r"(1 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\\n" :: "r"(2 - cw) : "memory");
}

"""
_PINGPONG = [
    ("// One block per (h, b, q tile), the heaviest causal tiles first.\n",
     _TURNS + "// One block per (h, b, q tile), the heaviest causal tiles "
     "first.\n"),
    ("    if (n > 0) {\n      // the first tile",
     "    if (WG == 2 && cw == 1) turn_pass(cw);\n"
     "    if (n > 0) {\n      // the first tile"),
    ("      mbar_wait(&k_full[0], 0);\n",
     "      mbar_wait(&k_full[0], 0);\n      if (WG == 2) turn_wait(cw);\n"),
    ("      qk_product(0);\n",
     "      qk_product(0);\n      if (WG == 2) turn_pass(cw);\n"),
    ("        fence_acc<kSmBN / 2>(sc);\n        fence_acc<DH / 2>(acc);\n",
     "        if (WG == 2) turn_wait(cw);\n"
     "        fence_acc<kSmBN / 2>(sc);\n        fence_acc<DH / 2>(acc);\n"),
    ("        wgmma_commit();\n        if (t + 1 < n)",
     "        wgmma_commit();\n        if (WG == 2) turn_pass(cw);\n"
     "        if (t + 1 < n)"),
    ("      // P . V of the last tile\n",
     "      // P . V of the last tile\n      if (WG == 2) turn_wait(cw);\n"),
    ("      wgmma_commit();\n      wgmma_wait<0>();\n",
     "      wgmma_commit();\n      if (WG == 2) turn_pass(cw);\n"
     "      wgmma_wait<0>();\n"),
    ("    // Finish: the row sums are spread over the quad",
     "    if (WG == 2 && cw == 0) turn_wait(cw);\n"
     "    // Finish: the row sums are spread over the quad"),
]

#: source -> alternative -> edits, as MUTANTS
ALTERNATIVES = {"flash_attention": {
    "q_rows_128": [("rc = launch_sm90<64, 1>(", "rc = launch_sm90<64, 2>(")],
    "pingpong": _PINGPONG,
}, "blocked_matmul": {
    **{f"split_k{n}": _split_k(n) for n in (2, 4, 8)},
    "act_switch": [
        ("template <int BN, int ACT>\n__device__ __forceinline__ void "
         "sm90_store_tile(",
         "__device__ __forceinline__ float act_rt(float y, int act) {\n"
         "  switch (act) {\n"
         "    case kRelu: return fast_act<kRelu>(y);\n"
         "    case kRelu2: return fast_act<kRelu2>(y);\n"
         "    case kSilu: return fast_act<kSilu>(y);\n"
         "    case kGelu: return fast_act<kGelu>(y);\n"
         "    default: return y;\n  }\n}\n\n"
         "template <int BN, int ACT>\n__device__ __forceinline__ void "
         "sm90_store_tile("),
        ("__nv_bfloat16* __restrict__ C) {\n  const int lane",
         "__nv_bfloat16* __restrict__ C, int act) {\n  const int lane"),
        ("fast_act<ACT>(acc[4 * j + 2 * h] + bz.x)",
         "act_rt(acc[4 * j + 2 * h] + bz.x, act)"),
        ("fast_act<ACT>(acc[4 * j + 2 * h + 1] + bz.y)",
         "act_rt(acc[4 * j + 2 * h + 1] + bz.y, act)"),
        ("      sm90_epilogue<BN>(acc,", "      sm90_store_tile<BN, kNone>(acc,"),
    ],
    **_F32_ALTERNATIVES,
}}


def build_mutants(_build, copies: dict = MUTANTS) -> dict:
    """Compile every edited copy in ``copies`` at once: {(source, name):
    CDLL}."""
    out_dir = _build.BUILD_DIR.parent / "mutants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, mutants in copies.items():
        src = (_build.CSRC / f"{source}.cu").read_text()
        for name, edits in mutants.items():
            text = src
            for old, new in edits:
                smoke.check(src.count(old) == 1,
                            f"{name}: its text is not in {source}.cu once")
                text = text.replace(old, new)
            cu = out_dir / f"{source}_{name}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            procs[(source, name)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def f32_gemm(libs: dict, gen: torch.Generator, card: str) -> bool:
    """The f32 GEMM's mutants against chip_smoke.py's fp32 checks, the
    real kernel first: every fp32 ``PARITY_SHAPES`` entry that takes the f32
    kernel (relu, with bias) and every calibration size (no act, no bias),
    ``rel_err`` against TOL.  Then each alternative beside the real kernel
    (``kernel_ms``: real, alternative, real) at the sizes where it competes:
    a tile in place of 64x128 where the rule takes 64x128, a split of K
    where no tile fills the SMs (32x64, and 64x128 at 768^3 and 1024^3),
    the ring's shape at both tiles."""
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels.ref import ref_matmul
    from repro_torch.measure.microbench import SMOKE_MATMUL_SIZES
    from repro_torch.measure.timers import kernel_ms

    f32 = torch.float32
    dev = gen.device
    cases = []
    for M, K, N in smoke.PARITY_SHAPES:
        if bm.variant(M, N, K, f32, True) == "f32":
            a, b = (torch.randn(sh, generator=gen, device=dev)
                    for sh in ((M, K), (K, N)))
            bias = torch.randn((N,), generator=gen, device=dev)
            cases.append(((M, K, N), a, b, bias, "relu",
                          ref_matmul(a, b, bias=bias, act="relu")))
    sizes = SMOKE_MATMUL_SIZES + smoke.CAL_BIG
    squares = {}
    for s_ in sizes:
        a, b = (torch.randn((s_, s_), generator=gen, device=dev)
                for _ in range(2))
        squares[s_] = (a, b, ref_matmul(a, b))
        cases.append(((s_, s_, s_), a, b, None, None, squares[s_][2]))

    ok = True
    real_launcher = bm._launcher
    try:
        kernels = {"real": bm._launcher(),
                   **{n: bm.bind(lib) for (src, n), lib in libs.items()
                      if n in _F32_MUTANTS}}
        for name, fns in kernels.items():
            bm._launcher = lambda fns=fns: fns
            errs = []
            for _, a, b, bias, act, want in cases:
                before = bm.blocked_matmul.launches_by_variant["f32"]
                got = bm.blocked_matmul(a, b, bias=bias, act=act)
                smoke.check(bm.blocked_matmul.launches_by_variant["f32"]
                            == before + 1, "an fp32 check shape left f32")
                errs.append(smoke.rel_err(got, want))
            row = {"kernel": name, "source": "blocked_matmul f32",
                   "shapes": [list(c[0]) for c in cases],
                   "kernel_rel_err": errs, "kernel_tol": smoke.TOL[f32],
                   "card": card}
            row["caught"] = max(errs) >= smoke.TOL[f32]
            print(json.dumps(row), flush=True)
            ok &= row["caught"] is (name != "real")
    finally:
        bm._launcher = real_launcher

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    real = bm._launcher().f32
    big = [s_ for s_ in sizes if bm.f32_plan(s_, s_, s_, n_sms) == bm.F32_TILES[0]]
    small = [s_ for s_ in sizes if s_ not in big]
    for name in _F32_ALTERNATIVES:
        alt = bm.bind(libs[("blocked_matmul", name)]).f32
        at = (big if "tile" in name else small + big[:2] if "split" in name
              else [small[-1], big[0], big[-1]])
        for s_ in at:
            a, b, want = squares[s_]
            rule = bm.f32_plan(s_, s_, s_, n_sms)
            tile = bm.F32_TILES[0] if "tile" in name else rule
            err = smoke.rel_err(
                smoke.f32_option(alt, a, b, None, None, tile), want)
            ms = {k: kernel_ms(lambda i: smoke.f32_option(
                fn, a, b, None, None, t), iters=20)
                for k, fn, t in (("real_ms", real, rule), ("ms", alt, tile),
                                 ("real_ms_again", real, rule))}
            row = {"alternative": name, "shape": [s_] * 3,
                   "real_tile": [rule.bm, rule.bn], **ms,
                   "kernel_rel_err": err, "kernel_tol": smoke.TOL[f32],
                   "card": card}
            print(json.dumps(row), flush=True)
            ok &= err < smoke.TOL[f32]
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_mutants.py runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, mlp_params_from_numpy
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_flash_attention, ref_matmul
    from repro_torch.measure.timers import kernel_ms
    from repro_torch.models import mlp_dlrm, transformer

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # the real kernels, then every mutant's nvcc at once
    _build.build()
    libs = build_mutants(_build, {
        src: {**MUTANTS.get(src, {}), **ALTERNATIVES.get(src, {})}
        for src in MUTANTS})

    cfg = get_config("smollm-135m").replace(use_flash=True)
    bf16 = cfg.compute_dtype
    B, S = smoke.PREFILL[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((B, S, n, cfg.dh), generator=gen, device=dev)
               .to(bf16) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    want_attn = ref_flash_attention(q, k, v)
    params = lm_params_from_numpy(
        smoke.smollm_tree(cfg, np.random.default_rng(0)), device=dev)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    lm_plain = cfg.replace(use_flash=False)
    want_lm = transformer.forward(params, tokens, lm_plain)[0]

    ok = True
    real_launcher = fa._launcher
    try:
        kernels = {"real": fa._launcher(),
                   **{n: fa.bind(lib) for (src, n), lib in libs.items()
                      if src == "flash_attention" and n in MUTANTS[src]}}
        for name, fn in kernels.items():
            fa._launcher = lambda fn=fn: fn
            got = ops.flash_attention(q, k, v)
            logits = transformer.forward(params, tokens, cfg)[0]
            row = {
                "kernel": name, "source": "flash_attention",
                "attn_row_rel_err": smoke.row_rel_err(got, want_attn),
                "attn_tol": smoke.FLASH_TOL[bf16],
                "attn_whole_rel_err": smoke.rel_err(got, want_attn),
                "logits_row_rel_err": smoke.row_rel_err(logits, want_lm),
                "logits_tol": smoke.LM_TOL,
                "logits_whole_rel_err": smoke.rel_err(logits, want_lm),
                "argmax_agrees": (logits.argmax(-1) == want_lm.argmax(-1))
                .float().mean().item(),
                "shape": [B, S, cfg.n_heads, cfg.n_kv_heads, cfg.dh],
                "card": card}
            row["caught"] = [row["attn_row_rel_err"] >= row["attn_tol"],
                             row["logits_row_rel_err"] >= row["logits_tol"]]
            print(json.dumps(row), flush=True)
            if name == "real":
                ok &= row["caught"] == [False, False]
            elif name == "release_v_early":   # a race: caught by either
                ok &= any(row["caught"])
            else:
                ok &= row["caught"] == [True, True]
            del got, logits
    finally:
        fa._launcher = real_launcher

    # the flash alternatives, each beside the real kernel, in turns (real,
    # alternative, real): (B, S, dh) -> 9 query / 3 kv heads
    flash_at = {"q_rows_128": [(B_, S_, cfg.dh) for B_, S_ in smoke.PREFILL],
                "pingpong": [(2, 2048, 128)]}
    real_flash = fa._launcher()
    for name in ALTERNATIVES["flash_attention"]:
        alt = fa.bind(libs[("flash_attention", name)])
        for Bp, Sp, dh in flash_at[name]:
            qp, kp, vp = (torch.randn((Bp, Sp, n, dh), generator=gen,
                                      device=dev).to(bf16)
                          for n in (cfg.n_heads, cfg.n_kv_heads,
                                    cfg.n_kv_heads))
            err = smoke.row_rel_err(
                smoke.flash_option(alt, "sm90", qp, kp, vp),
                ref_flash_attention(qp, kp, vp))
            ms = {key: kernel_ms(lambda i: smoke.flash_option(
                fns, "sm90", qp, kp, vp), iters=20)
                for key, fns in (("real_ms", real_flash), ("ms", alt),
                                 ("real_ms_again", real_flash))}
            row = {"alternative": name, "source": "flash_attention",
                   "shape": [Bp, Sp, cfg.n_heads, cfg.n_kv_heads, dh],
                   **ms, "attn_row_rel_err": err,
                   "attn_tol": smoke.FLASH_TOL[bf16], "card": card}
            print(json.dumps(row), flush=True)
            ok &= err < smoke.FLASH_TOL[bf16]

    # the sm90 GEMM: its ten main-path shapes (M, K, N, act, bias), the
    # dlrm-mlp forward, the prefill forward and decode with use_kernel_matmul
    W = 4096
    d, f = cfg.d_model, cfg.d_ff
    shapes = [(256, W, W, "relu", True), (1024, W, W, "relu", True),
              (4096, W, W, "relu", True), (B * S, d, f, "silu", False),
              (B * S, d, f, None, False), (B * S, f, d, None, False),
              *((M, K, N, act, False) for M in smoke.DECODE_TIMED
                for K, N, act in ((d, f, "silu"), (f, d, None)))]
    operands = []
    for M, K, N, act, has_bias in shapes:
        a = torch.randn((M, K), generator=gen, device=dev).to(bf16)
        b = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).to(bf16)
        bias = (torch.randn((N,), generator=gen, device=dev).to(bf16)
                if has_bias else None)
        operands.append((a, b, bias, act, ref_matmul(a, b, bias=bias, act=act)))
    mlp_cfg = get_config("dlrm-mlp").replace(use_kernel_matmul=True)
    rng = np.random.default_rng(0)
    mlp_params = mlp_params_from_numpy(smoke.dlrm_tree(mlp_cfg, rng), device=dev)
    feats = {n: torch.from_numpy(rng.standard_normal((n, W), np.float32)).to(dev)
             for n in (256, 4096)}
    want_mlp = {n: mlp_dlrm.forward(mlp_params, x,
                                    mlp_cfg.replace(use_kernel_matmul=False))
                for n, x in feats.items()}
    lm_kmm = cfg.replace(use_kernel_matmul=True)

    def decode_logits() -> torch.Tensor:
        """DECODE_STEPS teacher-forced decode steps of the token batch
        through lm_kmm, the logits of each (B, steps, V)."""
        cache = transformer.init_cache(lm_kmm, B, smoke.DECODE_MAX,
                                       device=dev)
        with torch.no_grad():
            return torch.cat([transformer.decode_step(
                params, tokens[:, t:t + 1], cache, t, lm_kmm)[0]
                for t in range(DECODE_STEPS)], dim=1)

    real_launcher = bm._launcher
    try:
        kernels = {"real": bm._launcher(),
                   **{n: bm.bind(lib) for (src, n), lib in libs.items()
                      if src == "blocked_matmul" and n in MUTANTS[src]
                      and not n.startswith("f32_")}}
        for name, fns in kernels.items():
            bm._launcher = lambda fns=fns: fns
            errs = []
            for a, b, bias, act, want in operands:
                before = bm.blocked_matmul.launches_by_variant["sm90"]
                got = bm.blocked_matmul(a, b, bias=bias, act=act)
                smoke.check(bm.blocked_matmul.launches_by_variant["sm90"]
                            == before + 1, "a main-path shape left sm90")
                errs.append(smoke.rel_err(got, want))
            mlp_errs = [smoke.rel_err(mlp_dlrm.forward(mlp_params, x, mlp_cfg),
                                      want_mlp[n]) for n, x in feats.items()]
            logits = transformer.forward(params, tokens, lm_kmm)[0]
            dec_err = smoke.row_rel_err(decode_logits(),
                                        want_lm[:, :DECODE_STEPS])
            row = {
                "kernel": name, "source": "blocked_matmul",
                "shapes": [list(sh[:4]) for sh in shapes],
                "kernel_rel_err": errs, "kernel_tol": smoke.TOL[bf16],
                "mlp_logits_rel_err": mlp_errs, "mlp_tol": smoke.LOGIT_TOL,
                "lm_logits_row_rel_err": smoke.row_rel_err(logits, want_lm),
                "lm_tol": smoke.LM_TOL,
                "decode_logits_row_rel_err": dec_err,
                "decode_tol": smoke.DECODE_TOL[bf16],
                "decode_steps": DECODE_STEPS, "card": card}
            row["caught"] = [max(errs) >= smoke.TOL[bf16],
                             max(mlp_errs) >= smoke.LOGIT_TOL,
                             row["lm_logits_row_rel_err"] >= smoke.LM_TOL,
                             dec_err >= smoke.DECODE_TOL[bf16]]
            print(json.dumps(row), flush=True)
            ok &= (row["caught"] == [False] * 4 if name == "real"
                   else row["caught"][0])
            del got, logits
    finally:
        bm._launcher = real_launcher

    # the alternatives, each beside the real kernel with the same tiles:
    # (M, K, N, act, bias) -> [(BN, n_fastest), ...]
    timed_at = {
        "split_k": {(256, W, W, "relu", True):
                    [(64, False), (128, False), (256, False)]},
        "act_switch": {sh: [bm.tile_plan(sh[0], sh[2], sh[1],
                                         torch.cuda.get_device_properties(
                                             dev).multi_processor_count)]
                       for sh in shapes[2:5]},
    }
    real_sm90 = bm._launcher().sm90
    for name in ALTERNATIVES["blocked_matmul"]:
        if name.startswith("f32_"):
            continue
        alt_sm90 = bm.bind(libs[("blocked_matmul", name)]).sm90
        kind = "split_k" if name.startswith("split_k") else name
        for sh, plans in timed_at[kind].items():
            a, b, bias, act, want = operands[shapes.index(sh)]
            bs_ = [b] + [(torch.randn(b.shape, generator=gen, device=dev)
                          / b.shape[0] ** 0.5).to(bf16) for _ in range(7)]
            for plan in map(lambda p: bm.Plan(*p), plans):
                err = smoke.rel_err(smoke.sm90_option(alt_sm90, a, b, bias,
                                                      act, plan), want)
                ms = {k: kernel_ms(lambda i: smoke.sm90_option(
                    fn, a, bs_[i % 8], bias, act, plan), iters=40)
                    for k, fn in (("real_ms", real_sm90), ("ms", alt_sm90),
                                  ("real_ms_again", real_sm90))}
                row = {"alternative": name, "shape": list(sh[:4]),
                       "plan": list(plan), **ms, "kernel_rel_err": err,
                       "kernel_tol": smoke.TOL[bf16], "card": card}
                print(json.dumps(row), flush=True)
                ok &= err < smoke.TOL[bf16]

    ok &= f32_gemm(libs, gen, card)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
