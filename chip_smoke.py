#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds every CUDA kernel from the sources in the checkout, holds each one
against its plain PyTorch version on the card, and drives the port's main
paths, each with the launch counts set to 0 just before it and read just
after:

  moe_prefill qwen2-moe-a2.7b at full width and depth (24 layers, 60
              routed experts top-4 and 4 shared, dh 128; 14.3 B fp32 params
              drawn on the card from a seed, the card otherwise empty)
              prefilling (4, 2048): every layer's attention in the flash
              kernel at dh 128, the shared experts' products in the blocked
              matmul, the routed experts' dispatch, expert and combine
              products in cuBLAS as in the JAX package; the logits held to
              the plain path's with its routing replayed
              (``routes_replayed``), within twice the plain path's own
              distance from fp32;
  moe_decode  the same model serving B = 8 against a 2048-slot cache: 64
              teacher-forced steps beside the plain path, greedy generation
              through ``serve.engine.greedy_generate``, decode against the
              forward where no choice is dropped (fp32), and the step timed,
              profiled and counted at pos 2047;
  hybrid_prefill
              hymba-1.5b at full width and depth (32 layers of attention
              and Mamba heads in parallel, 1.35 B fp32 params drawn on the
              card) prefilling (8, 2048), the FFN products in the blocked
              matmul and the windowed attention the plain masked form, as
              in the JAX package; the logits held to the plain path's
              within max(LM_TOL, 2 x the plain path's own distance from
              fp32) (``recurrent_rule``);
  hybrid_decode
              the same model serving B = 8 against a 2048-slot cache (the
              local layers' rings of 1024 slots): 64 teacher-forced steps,
              greedy generation, the rings past their wrap at a depth cut to
              2 layers in fp32, and the step timed, profiled and counted at
              pos 2047 on a full, wrapped cache;
  xlstm_prefill, xlstm_decode
              xlstm-125m at full width and depth (mLSTM blocks, sLSTM at
              layers 3 and 11; no kernel of the port on its path, as in the
              JAX package): the prefill (8, 2048) timed and counted, and
              profiled at a depth cut to ``XLSTM_PROFILE_LAYERS``, the card
              against the CPU; decode at B = 8 teacher-
              forced in bf16 and fp32, greedy generation, the step timed;
  encdec_prefill
              whisper-tiny at full width and depth (4 + 4 layers, d 384, 6
              heads of 64; 36.6 M fp32 params drawn on the card) encoding
              (8, 1500) frames, every encoder layer's attention in the flash
              kernel non-causal, and running the decoder over (8, 448)
              tokens, its self-attention in the flash kernel causal and its
              cross-attention plain, as in the JAX package; every FFN product
              in the blocked matmul with its bias and GELU in the epilogue;
              each launch recorded (``launches_recorded``); the encoder's
              states and the logits held by ``recurrent_rule``, the fp32
              kernel path to the fp32 plain path within 1e-4;
  encdec_decode
              the same model serving B = 8 against a 448-slot cache
              (``init_encdec_cache``: the encoder once, the cross K/V): 64
              teacher-forced steps, greedy generation with the frames, the
              step at pos 447 timed and one at pos 450 (the learned position
              clamped to the table's last row, as the reference's
              ``dynamic_slice_in_dim`` does), decode against the forward in
              fp32;
  vlm_prefill internvl2-26b at full width and a depth cut to 24 of its 48
              layers (10.6 B fp32 params, 42.2 GB: the 48 would not fit
              beside the activations) prefilling 256 visual + 768 text
              tokens at B = 2, every layer's attention in the flash kernel
              at dh 128 and GQA 6, the FFN in the blocked matmul; the
              logits held by ``recurrent_rule``, the fp32 kernel path at 2
              layers within 1e-4;
  vlm_decode  the same model serving text from pos 0 (the reference never
              caches the visual prefix) at B = 8 against a 1024-slot cache:
              32 teacher-forced steps, greedy generation, the step at pos
              1023 timed;
  mlp_serve   the full 8 x 4096 DLRM MLP tower scoring batches of 256, 1024
              and 4096 requests through the fused GEMM + bias + ReLU kernel
              (its Hopper variant, sm90: TMA ring, wgmma, persistent grid);
  lm_prefill  the full smollm-135m (30 layers, width 576, random weights)
              prefilling token batches (8, 2048), (1, 2048) and (4, 1000)
              with every layer's attention in the flash-attention kernel
              (its Hopper variant, sm90: TMA K/V ring, wgmma, the softmax
              under the products), and (8, 2048) once more with the FFN
              products in the blocked matmul kernel too;
  lm_decode   the same smollm-135m serving the (8, 2048) batch one token a
              step against a KV cache of 2048 (``decode_step``), the FFN
              products of every step in the blocked matmul (sm90 at 8 and 64
              rows): 512 steps teacher-forced against the prefill's logits,
              greedy generation through ``serve.engine.greedy_generate``
              with every generated token held to the plain path's logits,
              and the step timed, profiled and counted at B = 8 and 64;
              then, as a path of its own (lm_decode_fp32), 64 of the steps
              again in fp32 (the f32 kernel);
  mlp_train   the full tower trained (bf16 compute, fp32 params, AdamW with
              warmup-cosine): the loss falls over 20 steps at B = 1024,
              bf16 grads agree with fp32 grads, three fp32 steps on the card
              agree with the CPU's, the counted FLOPs with the analytic
              count; the step timed and profiled at B = 256, 1024, 4096.
              It launches no kernel of the port (the blocked matmul is
              forward-only, as the JAX package's is);
  train_cli   the training launcher (``launch.train``) on smollm-135m at
              full width and depth, bf16 compute, (8, 512): 30 steps with
              checkpoints at 10, 20 and 30, the state restored from step 30
              bit for bit equal to the one the run ended in, then, step 30's
              checkpoint removed, the same command resuming at 20, its CE
              held to the first run's (``RESUME_TOL``) and its final state
              compared bit for bit; the step timed, profiled and counted,
              the data pipeline's batch and the checkpointer's save, async
              stall, crc32 and restore timed;
  train_replay
              the fault-plan replay (``resilience.harness.replay``) of the
              seed-6, 200-step plan through the resilient runner and real
              checkpoint files on the card, reduced dlrm-mlp in fp32: the
              reference's exact counters.  Neither training phase launches
              a kernel of the port (both kernels are forward-only);
  calibrate   the smoke calibration suite (fp32 GEMMs through the blocked
              matmul's f32 kernel: a cp.async K ring, 16-byte fragment
              reads, the tile ``f32_plan`` picks; saxpy streams, two train
              steps and a reduced smollm decode step, the validation points)
              and fp32 GEMMs at 2048 and 4096, fitted into
              achievable ceilings against h100_sxm_fp32 (a registry entry
              in a temporary directory); the train steps placed on the
              datasheet and the fitted plane;
  calibrate_cli
              the calibrate entry point (``measure/calibrate.main``) at its
              full sizes (GEMMs 64^3 to 2048^3 through the f32 kernel,
              four validation points),
              traced by the port's span tracer: its registry entry loads
              back, one measured cell per validation step, the calibrated
              plane's SVG and ASCII figures, a valid trace with a span per
              bench and the fit's spans;
  ridgeline   every measured point of the paths above (the tower's forwards,
              the prefill, the decode steps, the train steps counted and in
              the paper's
              6BW^2L accounting with the grads' all-reduce, the CLI's
              measurements) as a cell report on h100_sxm and on the CLI's
              fitted spec, its host median attached; the paper's quadrant
              construction must classify each point as the times do on the
              spec's bandwidth-only plane; the tables and the plane printed;
  plan        the analytic parallelism planner (``launch.plan``, numpy; no
              kernel): parameter counts on fake tensors, exactly the drawn
              params' numel of the seven models above; the one-card
              prediction of each measured train step on the datasheet plane
              beside its host median, smollm's working set beside its
              measured peak, the capacity cut against what the card trained
              and qwen3-moe's 122 GB; the planner CLI on calibrate_cli's
              fitted plane with --explain and --trace (the JSON, the terms
              summing to each step, the band, the spans); the host's
              candidates/s over a 24-point qwen2-7b grid; the CLI in a
              process of its own, which must open no CUDA context;
  mesh_serve  smollm-135m through ``launch.serve --mesh 1x1`` (its tokens
              those of no mesh), then, in a bound 1x1 NCCL mesh with the
              params placed through the logical specs, the (8, 2048)
              prefill with use_flash and use_kernel_matmul and greedy
              generation of 8 sequences with the FFN in the blocked matmul:
              logits bit for bit, tokens and both kernels' launches those of
              the same calls with no mesh (these launches join lm_prefill's
              and lm_decode's rows); ``--mesh 2x1`` exits 2;
  train_families
              the moe, hybrid and ssm families trained at full width, bf16
              compute, random weights from seeds, the state donated:
              hymba-1.5b at full depth (4, 2048) with remat "full", and
              qwen2-moe-a2.7b at 5 of its 24 layers (4, 512), the loss
              falling over 4 AdamW steps; xlstm-125m at full depth (8, 512)
              through the launcher (its state donated too) with checkpoints,
              a bitwise restore and a resume from step 2 whose final state
              is the uninterrupted run's bit for bit and whose CE is held
              to it (``RESUME_TOL``); each step timed, counted against
              6·N·tokens (``FAMILY_FLOPS``) and (but the xLSTM's, whose
              sLSTM launches would take the profiler a minute) profiled; at
              1-2 layers and the long sequences (hymba's window crossed and
              eight SSD chunks, two mLSTM chunks), one fp32 step on the card
              against the CPU (``CHECK_TOL``) and bf16 against fp32 grads
              per leaf (``GRAD_TOL``).  No kernel of the port launches;
  mesh_train  smollm-135m trained at (8, 512) through ``launch.train --mesh
              1x1`` with checkpoints, then ``resilience.degraded
              .degraded_restart`` on one surviving card: the plan dp1 x tp1,
              the state restored bit for bit; a corrupted latest step
              quarantined and the restart landing on the step before, the
              steps after it resumed within ``RESUME_TOL`` of the
              uninterrupted run; the restore timed;
  dryrun      ``launch.dryrun.lower_cell`` on ``DRYRUN_CELLS`` (fake
              DTensors over a fake process group: no card byte, no kernel):
              dlrm-mlp 1x1 held to the card's own B = 256 step (F equal, the
              fake peak within ``PEAK_TOL`` of the allocator's), dlrm-mlp
              16x16's wire bytes to the ring all-reduce of its fp32 params
              and the planner's dp-16 term within 1%, and a report with its
              bottleneck and memory per device for each cell (a train cell
              of the moe, hybrid and ssm families, a prefill cell of the
              enc-dec and VLM ones, and hymba-1.5b's decode at 1x1, which
              torch 2.11 refused before a one-device axis replicated, among
              them); qwen2-moe-a2.7b's train_4k F x N / F(1x1) at most
              ``MOE_REPEAT_MAX`` on 16x16 and on 2x16x16 (one group a
              device through the exchange), its decode_32k F x N /
              F(1x1) at most ``MOE_DECODE_REPEAT_MAX`` on 16x16 (each
              expert product once across the mesh), xlstm-125m's train_4k F x N /
              F(1x1) at most ``SSD_REPEAT_MAX`` on 16x16 (each device's
              own run of SSD chunks) and its all-gather a device at most
              ``MLSTM_ALL_GATHER_MAX`` (each device's own tokens through
              the mLSTM's products), smollm-135m's train_4k wire a device
              at most ``SP_WIRE_MAX`` on 16x16 (the FFN's and the head's
              products on each device's own tokens), whisper-tiny's prefill_32k F x N /
              F(1x1) at most ``ENCDEC_REPEAT_MAX`` on 16x16 (the encoder
              on each device's own frames), the decode_32k 16x16
              all-gather a device of qwen2-moe-a2.7b and qwen2-7b at most
              ``DECODE_ALL_GATHER_MAX`` (the cache's row written on its
              own shard, never the cache gathered, and each device's
              softmax on its own keys, never the scores gathered), and
              one xlstm-125m sLSTM block's
              all-gather linear in S, its fit at S = 4096 under
              ``SLSTM_ALL_GATHER_MAX``;
  examples    the five examples' counterparts (``examples/*_torch.py``:
              the serve demo, the paper's case study, the planner views, the
              quickstart and the Ridgeline of three programs), each on the
              card in a process of its own at the reference example's sizes:
              exit 0 and ``OK``, its seconds and its kernel launches by
              variant;
  analysis    ``python -m repro_torch.analysis`` on the port's tree: its
              exit code, files and findings (it must be clean).

Every blocked-matmul and flash-attention launch of the MoE, hybrid,
enc-dec and VLM paths and the three after them must take the sm90 variant
(the hybrid and xLSTM paths and every decode step no flash launch) (the
decode's fp32 check the
f32 variant, and no decode step any flash launch), every calibration GEMM
the f32 variant (the wrappers count launches by variant).  It times the
paths, places them on the Ridgeline plane of the H100 datasheet spec,
times the flash kernel's earlier mma design beside the sm90 kernel at
every prefill shape, the f32
GEMM's earlier design (f32_edge) beside it at every calibration size, the
sm90 GEMM's tile options at every main-path shape and the f32 GEMM's at
every calibration size, and the host cost of a launch.  Any failed check
exits nonzero (``chip_mutants.py`` shows that the parity and logits checks
fail kernels with planted faults: late kv tiles and the K/V ring of the
flash kernel, the ring and the last k-step of the sm90 GEMM, the ring, the
last ragged K tile and an edge mask of the f32 GEMM).  The last two lines
are a JSON summary of each kernel (its times are totals over its own
launches on the main paths) and the device line ``{"ok": true, "device":
{...}}``.
Every number printed names the card and its power limit, as ``nvidia-smi``
reports them.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCHES = (256, 1024, 4096)
#: (M, K, N).  bf16 takes the sm90 kernel wherever K and N are multiples of
#: 8, the wmma kernel at (300, 700, 520) and (1, 4100, 17).  The sm90 edges:
#: ragged M (1000, 3000, 5000) and M = 1; N = 576 (BN 192) and N = 8; K = 64
#: and K = 8 (one k-step, fewer than the ring's stages); 96 tiles (< 132
#: SMs) and 320 (not a multiple of 132).  fp32 takes the f32 kernel but at
#: (1, 4100, 17) (N % 4 != 0: f32_edge); its 64x128 tile at the first three,
#: (1000, 576, 1536), (1000, 1536, 576), (3000, 1024, 1000) and (5000, 512,
#: 2048), its 32x64 tile at
#: (300, 700, 520) (K 700: a ragged last K tile), (1, 4096, 4096), (300, 64,
#: 8) (N narrower than a tile) and (130, 8, 520) (K shorter than one stage).
#: The last four are the smollm-135m decode's FFN products at B = 8 and 64:
#: one M tile of 8 or 64 rows (sm90; f32's 32x64 tile)
PARITY_SHAPES = ((4096, 4096, 4096), (256, 4096, 4096), (1000, 4096, 3000),
                 (300, 700, 520), (1, 4100, 17), (1000, 576, 1536),
                 (1, 4096, 4096), (1000, 1536, 576), (300, 64, 8),
                 (130, 8, 520), (3000, 1024, 1000), (5000, 512, 2048),
                 (8, 576, 1536), (8, 1536, 576), (64, 576, 1536),
                 (64, 1536, 576))
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
#: smollm-135m decode: the first DECODE_B sequences of the prefill's token
#: batch against a cache of DECODE_MAX (SmolLM-135M's trained context);
#: DECODE_TF steps teacher-forced and held to the plain forward, the first
#: DECODE_F32 of them again in fp32; greedy generation from a GEN_PROMPT
#: prompt for GEN_NEW tokens; the step timed at DECODE_TIMED batches at the
#: cache's last position
DECODE_B, DECODE_MAX, DECODE_TF, DECODE_F32 = 8, 2048, 512, 64
GEN_PROMPT, GEN_NEW = 128, 128
DECODE_TIMED = (8, 64)
#: decode logits against the plain forward's rows, by ``row_rel_err``.
#: bf16, 30 layers: the paths round apart as in LM_TOL (the kernel rounds
#: each FFN product once after its epilogue, the plain path after each op;
#: cuBLAS sums the 8-row products in other orders than the 4096-row ones;
#: the decode softmax spans 2048 keys, masked ones adding exact zeros).
#: On an H100 the 512 steps read 2.456e-2, and 32 steps (chip_mutants.py)
#: 2.456e-2 with the real kernel and 0.80 with the sm90 GEMM's last k-step
#: skipped; its ring race (release_early) does not fire at M <= 64 and
#: reads as the real kernel (PERF.md).  6e-2 is 2.4x the sound reading.
#: fp32 (TF32 off): orders of summation only, as FLASH_TOL's 1e-4.
DECODE_TOL = {torch.bfloat16: 6e-2, torch.float32: 1e-4}
#: qwen2-moe-a2.7b, full width and depth (14.3 B fp32 params, drawn on the
#: card): the prefill's token batch (four dispatch groups of 2048 tokens,
#: C = 170); decode at B = MOE_B against a cache of MOE_MAX, MOE_TF steps
#: teacher-forced, greedy MOE_PROMPT + MOE_NEW tokens, and decode against
#: the forward with no choice dropped at MOE_NODROP (in fp32, DECODE_TOL)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PREFILL = (4, 2048)
MOE_B, MOE_MAX, MOE_TF = 8, 2048, 64
MOE_PROMPT, MOE_NEW = 32, 32
MOE_NODROP = (8, 128)
#: qwen2-moe's kernel-path logits against the plain path's (row_rel_err,
#: with the plain routing replayed on the kernel path) within MOE_MARGIN x
#: the plain bf16 path's own distance from the fp32 plain path on the same
#: tokens and routing, measured in the same run.  A fixed bound such as
#: LM_TOL does not hold here: over 24 layers of dh 128 the plain bf16 path
#: itself lies 0.101-0.118 from the fp32 plain path by row (its scores are
#: rounded to bf16 before the softmax, as the reference's are), the kernel
#: path 0.088-0.093, the two 0.095-0.118 apart (PERF.md).  A planted flash
#: fault moves the logits by 0.58-0.80 (chip_mutants.py at smollm-135m),
#: far past 2 x 0.118
MOE_MARGIN = 2.0
#: hymba-1.5b, full width and depth (1.35 B fp32 params, drawn on the card):
#: the prefill's token batch; decode at B = HYBRID_B against a cache of
#: HYBRID_MAX (the local layers' rings of 1024 wrap), HYBRID_TF steps
#: teacher-forced, greedy HYBRID_PROMPT + HYBRID_NEW tokens; the rings
#: checked at a depth cut to 2 layers (0 global, 1 local) for RING_STEPS
#: steps in fp32, past the window, within RING_TOL by row of the forward
HYMBA_ARCH = "hymba-1.5b"
HYBRID_PREFILL = (8, 2048)
HYBRID_B, HYBRID_MAX, HYBRID_TF = 8, 2048, 64
HYBRID_PROMPT, HYBRID_NEW = 32, 32
RING_STEPS = 1100
#: decode against the forward of the same fp32 weights by row: the chunked
#: and the sequential recurrence, the masked full-sequence attention and
#: the grouped one over the cache, differ in rounding only (fp32, TF32 off)
RING_TOL = 1e-3
#: xlstm-125m, full width and depth: the prefill's token batch, its samples
#: (the sLSTM's steps are eager launches: seconds a forward); decode at
#: B = XLSTM_B, XLSTM_TF steps teacher-forced in bf16 and in fp32, greedy
#: XLSTM_PROMPT + XLSTM_NEW tokens
XLSTM_ARCH = "xlstm-125m"
XLSTM_PREFILL = (8, 2048)
XLSTM_SAMPLES = 3
#: the xLSTM prefill's profile at a depth cut to this many layers, its
#: first three mLSTM blocks: the profiler took a minute to walk the full
#: depth's ~112k launches, most of them the two sLSTM layers' 2048 steps
#: each, whose recurrence is timed alone instead
XLSTM_PROFILE_LAYERS = 3
XLSTM_B, XLSTM_TF = 8, 64
XLSTM_PROMPT, XLSTM_NEW = 32, 32
#: xlstm-125m on the card against the same weights on the CPU, fp32 (TF32
#: off), by row: sums in other orders only
CARD_CPU_TOL = 1e-4
#: whisper-tiny, full width and depth (36.6 M fp32 params, drawn on the
#: card, every vector leaf moved off its init): the prefill encodes
#: (ENCDEC_B, 1500) frames and runs the decoder over (ENCDEC_B, 448) tokens
#: (its whole learned context); decode at B = ENCDEC_B against a cache of
#: 448, ENCDEC_TF steps teacher-forced, greedy ENCDEC_PROMPT + ENCDEC_NEW
#: tokens, the step at pos 447 timed and one at ENCDEC_CLAMP_POS (past the
#: position table: the clamp)
WHISPER_ARCH = "whisper-tiny"
ENCDEC_B, ENCDEC_TF = 8, 64
ENCDEC_PROMPT, ENCDEC_NEW = 32, 32
ENCDEC_CLAMP_POS = 450
#: internvl2-26b at full width and a depth cut to VLM_LAYERS (48 layers are
#: 19.9 B params, 79.7 GB in fp32: no room on one 80 GB card; 24 are 10.6 B,
#: 42.2 GB): the prefill (B, 256 visual + 768 text); the fp32 kernel path
#: checked at a depth cut to VLM_F32_LAYERS; decode at B = VLM_B against a
#: cache of VLM_MAX, VLM_TF steps teacher-forced, greedy VLM_PROMPT +
#: VLM_NEW tokens, the step at pos VLM_MAX - 1 timed
VLM_ARCH = "internvl2-26b"
VLM_LAYERS, VLM_F32_LAYERS = 24, 2
VLM_PREFILL = (2, 768)
VLM_B, VLM_MAX, VLM_TF = 8, 1024, 32
VLM_PROMPT, VLM_NEW = 32, 32
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
#: the training launcher at smollm-135m's full width and depth, bf16 compute:
#: (8, 512), not 2048, because the reference's train path has no flash and
#: the plain attention keeps B·H·S² fp32 scores and probabilities for the
#: backward (~0.2 GB a layer at 512, ~2.4 GB at 2048: 70-100 GB over 30)
TRAIN_CLI = ["--arch", "smollm-135m", "--batch", "8", "--seq", "512",
             "--ckpt-every", "10"]
#: resumed steps 20-29 against an uninterrupted run's, CE relative.  The
#: card's embedding backward and cuBLAS may sum in another order from run to
#: run (~1e-7 relative a step); ten AdamW steps carry that to ~1e-5 at most.
#: A resume that restored the wrong step, moment or counter moves CE by
#: 1e-2 or more (the warmup-cosine rate alone changes 5% a step there)
RESUME_TOL = 1e-3
#: the acceptance replay of tests/test_resilience.py: seed-6 plan of 200
#: steps, a checkpoint every 10, and the reference's exact counters
REPLAY_SEED, REPLAY_STEPS, REPLAY_EVERY = 6, 200, 10
REPLAY_COUNTERS = {"executed_steps": 233, "saves": 22, "restarts": 4,
                   "quarantined": 1}
REPLAY_GOODPUT = 0.7181328
#: train_families: (arch, layers (0: every one), (B, S), remat, AdamW rate)
#: at full width, bf16 compute, the state donated
#: (``TrainStepConfig(donate=True)``).  hymba at S = 2048 crosses its
#: 1024 window and runs eight SSD chunks of 256; remat "full" holds one
#: block's plain fp32 scores at a time (28.7 GB at B = 4; without remat the
#: fake count gives 89 GB at B = 2).  qwen2-moe at 5 of 24 layers: 3.48 B
#: fp32 params, a fake peak of 63.1 GB donated (95 GB at 4 layers without
#: donation: the functional update holds the old and the new state).  The
#: xLSTM trains through the CLI (``XLSTM_CLI``)
FAMILY_TRAIN = (("hymba-1.5b", 0, (4, 2048), "full", 3e-4),
                ("qwen2-moe-a2.7b", 5, (4, 512), "none", 1e-3))
FAMILY_STEPS = 4
#: host timings of each step: a p90 needs 10 samples, which only the MoE's
#: 0.34 s step can spare; hymba's and the xLSTM's (~2 s) report a median of 3
FAMILY_REPEATS = {"qwen2-moe-a2.7b": 10, "hymba-1.5b": 3, "xlstm-125m": 3}
#: counted F / 6·N·tokens (N the active params: the routed experts at k of
#: E): the band each step's count must fall in.  The fake-tensor count of
#: the same steps (launch.dryrun's counter on one device, CPU) reads
#: 1.4812 (hymba: remat's second forward is 4/3, the windowed attention's
#: scores and the SSD's chunks the rest), 1.1272 (xlstm: the mLSTM's
#: chunked scores and the sLSTM's recurrent products) and 1.3060 (qwen2-moe:
#: the dense one-hot dispatch and combine, and experts' capacity slots)
FAMILY_FLOPS = {"hymba-1.5b": (1.40, 1.60), "xlstm-125m": (1.05, 1.25),
                "qwen2-moe-a2.7b": (1.20, 1.45)}
#: the fp32 card-vs-CPU step and the bf16-vs-fp32 grads: each model at
#: full width and a depth cut to (layers, B, S) (hymba: a global and a local
#: layer, S = 2048 past the local layer's 1024 window and over eight SSD
#: chunks of 256; xlstm: an mLSTM and an sLSTM block, S = 512 over two
#: mLSTM chunks of 256; the MoE's one layer is 1.19 B params on the CPU),
#: one SGD step (its update is linear in the grads, so
#: the params differ as the grads do: AdamW's first step divides each grad
#: by its own size, which turns a last-place difference of a near-zero grad
#: into one of the whole rate; SGD's first momentum is the grads exactly)
FAMILY_CHECK = {"hymba-1.5b": (2, 1, 2048), "xlstm-125m": (2, 1, 512),
                "qwen2-moe-a2.7b": (1, 1, 128)}
#: card vs CPU in fp32: loss and grad norm relative, each grad leaf by norm
#: (another summation order: ~1e-6), params (SGD at 1e-2) of the largest
CHECK_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4, "params": 1e-5}
#: the xLSTM through the training launcher at full width and depth, (8, 512):
#: 4 steps with checkpoints at 2 and 4, then, step 4's removed, a resume
#: from 2 to 4 against that uninterrupted run
XLSTM_CLI = ["--arch", "xlstm-125m", "--batch", "8", "--seq", "512",
             "--ckpt-every", "2"]
#: the planner's throughput grid, timed on the host: qwen2-7b at every
#: power-of-two chip budget from 8 to 1024 by three global batches, pp up to
#: 8, every ZeRO stage and each all-reduce algorithm as its own candidate
PLAN_GRID_ARCH = "qwen2-7b"
PLAN_GRID_CHIPS = tuple(8 * 2 ** i for i in range(8))
PLAN_GRID_BATCHES = (256, 512, 1024)
#: the planner CLI on the card's fitted fp32 plane (calibrate_cli's registry)
PLAN_CLI = ["--arch", "dlrm-mlp", "--chips-grid", "1,2,4,8", "--hardware",
            "h100_sxm_fp32", "--calibrated", "--explain", "--json"]
#: the planner CLI in a process of its own (no CUDA context may open):
#: qwen3-moe-30b-a3b training on eight cards, ZeRO searched
PLAN_ALONE = ["--arch", "qwen3-moe-30b-a3b", "--chips", "8", "--batch", "8",
              "--seq", "512", "--zero", "auto", "--top", "3"]
#: the planner's spans (``launch.plan_grid``), every one in the CLI's trace
PLAN_SPANS = {"plan_grid", "plan_grid.enumerate", "plan_grid.feasibility",
              "plan_grid.price_collectives", "plan_grid.sweep_classify"}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


#: the smoke's start, for each phase's line
T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


@contextlib.contextmanager
def routes_recorded(log: list):
    """Append each ``moe.route`` call's expert indices to ``log`` while the
    block runs; the routing itself is unchanged."""
    from repro_torch.models import moe
    real = moe.route

    def recording(logits, cfg):
        gates, idx, aux = real(logits, cfg)
        log.append(idx)
        return gates, idx, aux

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = real


@contextlib.contextmanager
def routes_replayed(log: list):
    """Make the block's ``moe.route`` calls take the expert indices of
    ``log`` in turn, with gates from the caller's own probabilities,
    renormalised as ``route`` does (``moe.gates_and_aux``).  Two paths that
    round apart flip a near-tied top-k choice now and then, and one flipped
    expert moves a token's output by far more than the rounding did: with
    the choices replayed, the paths compare on the same routing.  Every
    entry of ``log`` must be taken."""
    from repro_torch.models import moe
    real, calls = moe.route, iter(log)

    def replaying(logits, cfg):
        idx = next(calls)
        probs = torch.softmax(logits.float(), dim=-1)
        gates, aux = moe.gates_and_aux(probs, idx, cfg)
        return gates, idx, aux

    moe.route = replaying
    try:
        yield
    finally:
        moe.route = real
    check(next(calls, None) is None, "a recorded routing was not replayed")


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


def f32_option(f32, a: torch.Tensor, b: torch.Tensor, bias, act, tile):
    """One launch of ``f32`` (``blocked_matmul.bind``'s entry point of the
    f32 kernel) with ``tile``, past the wrapper and its counters."""
    from repro_torch.kernels.blocked_matmul import _ACT_CODE
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = f32(a.data_ptr(), b.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             M, N, K, _ACT_CODE[act], tile.bm, tile.bn,
             torch.cuda.current_stream(a.device).cuda_stream)
    check(rc == 0, f"f32 {tile} failed at ({M},{K},{N}): CUDA error {rc}")
    return out


def edge_option(base, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the f32_edge kernel (the fp32 case of ``base``,
    ``blocked_matmul.bind``'s first entry point), past the wrapper."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = base(a.data_ptr(), b.data_ptr(), None, out.data_ptr(), M, N, K, 0, 0,
              torch.cuda.current_stream(a.device).cuda_stream)
    check(rc == 0, f"f32_edge failed at ({M},{K},{N}): CUDA error {rc}")
    return out


def flash_option(fns, kind: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """One launch (causal or not) of the ``kind`` kernel of ``fns`` (what
    ``flash_attention.bind`` returns) on model-layout q, k, v, past the
    wrapper and its counters."""
    from repro_torch.kernels import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty_like(qt)
    rc = fa.launch(fns, kind, qt, kt, vt, out, causal, 0, q.shape[1])
    check(rc == 0, f"flash {kind} failed at {tuple(q.shape)}: CUDA error {rc}")
    return out.transpose(1, 2)


def flash_row(say, path: str, fns, gen: torch.Generator, B: int, S: int,
              H: int, K: int, dh: int, launches: int,
              causal: bool = True) -> dict:
    """The flash kernel at one bf16 prefill shape per launch, causal or
    not (an encoder's bidirectional attention): the
    kernel, its plain version, the earlier mma design (called past the
    wrapper, in turns: the kernel, mma, the kernel again) and the library's
    one call (SDPA, a yardstick the port never calls), each checked against
    the plain version: one row of the summary line, ``launches`` the main
    path's launches at this shape.  q, k, v sit in L2 where they fit, as
    the forward, which has just written them, finds them."""
    import torch.nn.functional as F

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_flash_attention
    from repro_torch.measure.timers import kernel_ms
    bf16 = torch.bfloat16
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=gen.device)
               .to(bf16) for n in (H, K, K))
    def kernel(i):
        return ops.flash_attention(q, k, v, causal=causal)

    k_ms = kernel_ms(kernel, iters=20)
    mma_ms = kernel_ms(lambda i: flash_option(fns, "mma", q, k, v, causal),
                       iters=20)
    k_ms_again = kernel_ms(kernel, iters=20)
    p_ms = kernel_ms(lambda i: ref_flash_attention(q, k, v, causal=causal),
                     iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = kernel_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20)
    want = ref_flash_attention(q, k, v, causal=causal)
    got = kernel(0)
    err_abs, err = max_abs(got, want), row_rel_err(got, want)
    check(err < FLASH_TOL[bf16],
          f"flash kernel disagrees at {path}'s ({B},{S},{H},{K},{dh}): {err}")
    e_mma = row_rel_err(flash_option(fns, "mma", q, k, v, causal), want)
    check(e_mma < FLASH_TOL[bf16],
          f"flash mma disagrees at {path}'s ({B},{S},{H},{K},{dh}): {e_mma}")
    flops, nbytes = attn_work(B, S, H, K, dh, causal, 2)
    b_ms, b_by = bound_of(flops, nbytes, H100_SXM)
    say(f"  flash B={B} S={S} H={H} K={K} dh={dh} causal={causal} per "
        f"launch: kernel "
        f"(sm90) {k_ms:.4f} / {k_ms_again:.4f} ms "
        f"({flops / k_ms / 1e9:.1f} TFLOP/s), earlier mma design "
        f"{mma_ms:.4f} ms ({mma_ms / k_ms:.2f}x the kernel); plain "
        f"{p_ms:.4f} ms, library SDPA {lib_ms:.4f} ms "
        f"({k_ms / lib_ms:.2f}x); bound {b_ms:.4f} ms ({b_by}), kernel at "
        f"{100 * b_ms / k_ms:.1f}% of bound; {launches} {path} "
        f"launches; max_abs_err {err_abs:.3e}, row_rel_err {err:.3e} "
        f"(mma {e_mma:.3e}; tol {FLASH_TOL[bf16]:g})")
    return {"path": path, "shape": [B, S, H, K, dh], "causal": causal,
            "launches": launches, "kernel_ms": k_ms,
            "kernel_ms_again": k_ms_again, "mma_ms": mma_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err_abs, "flops": flops, "bytes": nbytes}


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


def profile_rows(fn) -> list:
    """The profiler's ``key_averages()`` rows of one ``fn()``: a kernel's row
    has the CUDA device type, and a CPU op's row counts its kernels' time
    as its own."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def profile_kernels(fn) -> list:
    """(name, launches, ms) of every kernel the profiler saw in one ``fn()``
    (the device's rows only)."""
    from torch.autograd import DeviceType
    return [(r.key, r.count, r.self_device_time_total / 1e3)
            for r in profile_rows(fn) if r.device_type == DeviceType.CUDA]


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


def leaves_equal(saved, restored) -> bool:
    """Bit for bit, leaf by leaf in the checkpoint's order: each tensor's
    device, dtype and bytes, each generator's state."""
    from repro_torch.checkpoint.checkpointer import _flatten
    a, b = _flatten(saved)[0], _flatten(restored)[0]
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                return False
        elif (x.device != y.device or x.dtype != y.dtype
              or not torch.equal(x, y)):
            return False
    return True


def train_cli(dev, say, tmp: str) -> dict:
    """The training launcher (``launch.train``) on smollm-135m at full width
    and depth: 30 steps with checkpoints at 10, 20 and 30, the state
    restored from step 30 held bit for bit to the one the run ended in;
    then, step 30's checkpoint removed, a second run of the same command
    resuming at 20 from the same directory, its CE held to the first run's
    (the uninterrupted yardstick); then the step, the data pipeline and the
    checkpointer timed.  Returns the step's numbers for the plane."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer, _crc32_of
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_stream, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    from repro_torch.models.common import count_params

    def run(ckpt_dir: str):
        t0 = time.perf_counter()
        out = launcher.train(launcher.parse_args(
            TRAIN_CLI + ["--steps", "30", "--ckpt-dir", ckpt_dir]))
        return out, time.perf_counter() - t0

    d = os.path.join(tmp, "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    straight, wall1 = run(d)
    peak = torch.cuda.max_memory_allocated()
    n_params = count_params(straight.state.params)
    ce1 = [h["ce"] for h in straight.history]
    say(f"run 1 ({' '.join(TRAIN_CLI)} --steps 30): {n_params} fp32 params, "
        f"AdamW state 2 x fp32, {wall1:.2f} s (init, 30 steps, saves at 10, "
        f"20 and 30, the final sync save, the report's counted step); CE "
        + " ".join(f"{x:.4f}" for x in ce1) + f"; peak {peak / 1e9:.3f} GB")
    check([h["step"] for h in straight.history] == list(range(30)),
          "run 1 did not run steps 0-29")
    check(all(np.isfinite(ce1)) and np.mean(ce1[-5:]) < np.mean(ce1[:5]),
          f"run 1's CE does not fall: {ce1}")
    ck = Checkpointer(d)
    check(ck.latest_step() == 30, f"newest committed step {ck.latest_step()}")
    t0 = time.perf_counter()
    restored, _ = ck.restore(straight.state, step=30)
    torch.cuda.synchronize()
    say(f"step 30 restored on the card in {time.perf_counter() - t0:.3f} s; "
        f"bit for bit equal to the state run 1 ended in: "
        f"{leaves_equal(straight.state, restored)}")
    check(leaves_equal(straight.state, restored),
          "the restored step-30 state differs from the one saved")
    del restored

    shutil.rmtree(os.path.join(d, "step_000000030"))
    second, wall2 = run(d)
    steps2 = [h["step"] for h in second.history]
    ce2 = [h["ce"] for h in second.history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ce2, ce1[20:]))
    same = leaves_equal(straight.state, second.state)
    say(f"run 2 (the same command, step 30's checkpoint removed): resumed at "
        f"{steps2[0]}, ran {steps2[0]}..{steps2[-1]} in {wall2:.2f} s; CE "
        f"steps 20-29 resumed vs run 1's: max rel {rel:.3e} (tol "
        f"{RESUME_TOL:g}); its final state run 1's bit for bit: {same}")
    check(steps2 == list(range(20, 30)), f"run 2 ran steps {steps2}")
    check(int(second.state.step) == 30, "run 2's state is not at step 30")
    check(rel < RESUME_TOL, f"resumed CE off the uninterrupted run: {rel}")
    del second
    shutil.rmtree(d)

    # the step, the pipeline and the checkpointer timed, at step 30's state
    cfg = get_config("smollm-135m")
    stream = make_stream(cfg, DataConfig(seed=0, global_batch=8, seq_len=512))
    t0 = time.perf_counter()
    for s in range(5):
        stream.batch(s)
    data_ms = (time.perf_counter() - t0) * 1e3 / 5
    state, step = straight.state, straight.train_step
    batch = to_device(stream.batch(0), dev)
    host = time_callable(step, state, batch, device=dev, repeats=10, warmup=2)
    p90 = float(np.percentile(host.samples, 90))
    card_ms = cuda_event_ms(lambda i: step(state, batch), iters=5)
    kern = profile_kernels(lambda: step(state, batch))
    launches = sum(n for _, n, _ in kern)
    k_ms = sum(ms for _, _, ms in kern)
    gemm_ms = sum(ms for n, _, ms in kern if is_gemm(n))
    a = straight.report
    say(f"step (8, 512): host median {host.median * 1e3:.3f} ms, p90 "
        f"{p90 * 1e3:.3f} ms (n={len(host.samples)}); card {card_ms:.3f} ms; "
        f"{launches} launches, {k_ms:.3f} ms of kernels, GEMMs {gemm_ms:.3f} "
        f"ms; data pipeline {data_ms:.3f} ms a batch (host)")
    say(f"step counted: F {a.work.flops:.6g}, B_M {a.work.mem_bytes:.6g}; "
        f"h100_sxm: {a.summary()}; bound {a.runtime * 1e3:.3f} ms = "
        f"{100 * a.runtime / host.median:.1f}% of the host median")
    for name, n, ms in sorted(kern, key=lambda x: -x[2])[:8]:
        say(f"    {ms:9.4f} ms {100 * ms / k_ms:5.1f}% x{n:<5d} {name[:100]}")

    bench = os.path.join(tmp, "bench")
    ckb = Checkpointer(bench, keep=2)
    t0 = time.perf_counter()
    ckb.save(100, state)
    sync_s = time.perf_counter() - t0
    shard = os.path.join(bench, "step_000000100", "shard_00000.npz")
    nbytes = os.path.getsize(shard)
    t0 = time.perf_counter()
    crc_s = (_crc32_of(shard), time.perf_counter() - t0)[1]
    t0 = time.perf_counter()
    ckb.save(101, state, async_=True)
    stall_s = time.perf_counter() - t0
    ckb.wait()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = ckb.restore(state, step=101)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(leaves_equal(state, back), "the benched restore differs")
    say(f"checkpoint: {nbytes} bytes a step ({nbytes / 1e9:.3f} GB); sync "
        f"save {sync_s:.3f} s; async save stalls the caller {stall_s:.3f} s "
        f"(the write behind it {write_s:.3f} s); crc32 {crc_s:.3f} s "
        f"({nbytes / crc_s / 1e9:.2f} GB/s); restore with verify "
        f"{restore_s:.3f} s")
    del back, straight
    shutil.rmtree(bench)
    return {"flops": a.work.flops, "mem_bytes": a.work.mem_bytes,
            "seconds": host.median, "params": float(n_params),
            "peak": float(peak)}


def train_replay(dev, say, tmp: str) -> None:
    """``resilience.harness.replay`` on the card, built as
    ``tests/test_resilience.py`` builds it (reduced dlrm-mlp in fp32, AdamW
    1e-3, the stream of seed 11 at batch 8, the seed-6 plan of 200 steps):
    the counters must be the reference's."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, make_stream, to_device
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.resilience.faults import FaultPlan
    from repro_torch.resilience.harness import replay
    from repro_torch.train import loop

    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    opt = AdamW(learning_rate=1e-3)
    step = loop.build_train_step(cfg, opt, loop.TrainStepConfig())
    stream = make_stream(cfg, DataConfig(seed=11, global_batch=8))
    state = loop.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                  cfg, opt, device=dev)
    plan = FaultPlan.generate(REPLAY_SEED, REPLAY_STEPS)
    t0 = time.perf_counter()
    res = replay(lambda s, b: step(s, to_device(b, dev)), state, stream, plan,
                 os.path.join(tmp, "replay"), ckpt_every=REPLAY_EVERY,
                 straggler_sleep_s=0.02, keep_history=True)
    wall = time.perf_counter() - t0
    got = {k: getattr(res, k) for k in REPLAY_COUNTERS}
    analytic = res.goodput_analytic(REPLAY_EVERY, plan.n_restart_faults)
    say(f"plan seed {REPLAY_SEED}, {REPLAY_STEPS} steps: "
        + ", ".join(f"{e.kind}@{e.step}" for e in plan.events))
    say(f"replay: {got}, stragglers flagged {res.stragglers_flagged}, goodput "
        f"measured {res.goodput_measured:.7f} (reference {REPLAY_GOODPUT}), "
        f"analytic {analytic:.7f}; final step {int(res.final_state.step)} on "
        f"{res.final_state.step.device}; {wall:.2f} s for "
        f"{res.executed_steps} steps and {res.saves} saves "
        f"({wall / res.executed_steps * 1e3:.2f} ms a step, host)")
    check(got == REPLAY_COUNTERS, f"replay counters {got}")
    check(abs(res.goodput_measured - REPLAY_GOODPUT) <= 1e-6,
          f"goodput {res.goodput_measured}")
    check(res.stragglers_flagged >= 1, "no straggler flagged")
    check(int(res.final_state.step) == REPLAY_STEPS
          and res.final_state.step.device.type == "cuda",
          "the replay did not end at step 200 on the card")
    check(set(h["step"] for h in res.history) == set(range(REPLAY_STEPS)),
          "the replay lost committed progress")


#: the blocked matmul's kernels, by the names the profiler shows
def family_cut(cfg, layers: int):
    """``cfg`` at ``layers`` layers, each kind of layer kept (hymba's global
    layer 0 and a local one; an mLSTM and an sLSTM block)."""
    kw = {"n_layers": layers}
    if cfg.family == "hybrid":
        kw["global_attn_layers"] = (0,)
    if cfg.family == "ssm":
        kw["slstm_layers"] = (layers - 1,)
    return cfg.replace(**kw)


def lm_batch(rng: np.random.Generator, vocab: int, B: int, S: int,
             dev) -> dict:
    """(B, S) tokens and their next tokens as labels, from numpy."""
    toks = torch.from_numpy(rng.integers(0, vocab, (B, S + 1))).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class CardOps(TorchDispatchMode):
    """Counts the aten ops that run on a CUDA tensor: each launches one
    kernel or more (the launches of a step the profiler is not asked to
    walk)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in tree_flatten(out)[0]):
            self.ops += 1
        return out


def family_checks(dev, say, arch: str, rng: np.random.Generator) -> None:
    """``arch`` at full width and the depth of ``FAMILY_CHECK``
    (``family_cut``): one fp32 SGD step on the card against the same step
    on the CPU (``CHECK_TOL``; the grads are the step's first momentum), and
    bf16 against fp32 grads per leaf on the card (``GRAD_TOL``).  An MoE's
    routing is recorded on the first pass and replayed on the second, so
    each pair compares on one routing (``routes_replayed``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizer import SGD
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    layers, B, S = FAMILY_CHECK[arch]
    cfg = family_cut(get_config(arch), layers)
    f32 = cfg.replace(compute_dtype=torch.float32)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    batch = lm_batch(rng, cfg.vocab_size, B, S, "cpu")
    opt = SGD(learning_rate=1e-2)
    sides, log = {}, []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda x: x.to(d), params)
        st = loop.TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=d), None)
        b = {k: v.to(d) for k, v in batch.items()}
        log[:] = [x.to(d) for x in log]
        route = (routes_recorded(log) if d.type == "cuda"
                 else routes_replayed(log) if log
                 else contextlib.nullcontext())
        with route:
            new, m = loop.build_train_step(f32, opt)(st, b)
        sides[d.type] = ([x.cpu() for x in tree_leaves(new.opt_state.momentum)],
                         new.params, m)
        del st, new
    (gg, gp, gm), (cg, cp, cm) = sides[dev.type], sides["cpu"]
    rel = {k: abs(gm[k].item() - cm[k].item()) / abs(cm[k].item())
           for k in ("loss", "grad_norm")}
    rel["grads"] = max((torch.linalg.vector_norm(a - b)
                        / torch.linalg.vector_norm(b)).item()
                       for a, b in zip(gg, cg)
                       if torch.linalg.vector_norm(b) > 0)
    rel["params"] = tree_rel_err(gp, cp)
    n = sum(x.numel() for x in tree_leaves(params))
    say(f"  {arch} at {layers} layers, {n} params, ({B}, {S}), fp32: one SGD "
        f"step on the card vs the CPU ({time.perf_counter() - t0:.1f} s): "
        + ", ".join(
            f"{k} {v:.3e} (tol {CHECK_TOL[k]:g})" for k, v in rel.items()))
    check(all(rel[k] < CHECK_TOL[k] for k in rel),
          f"{arch}: the card's fp32 step disagrees with the CPU's: {rel}")
    del sides, gp, cp

    p = tree_map(lambda x: x.to(dev), params)
    b = {k: v.to(dev) for k, v in batch.items()}
    log.clear()
    with routes_recorded(log):
        g16 = grads(cfg, p, b)
    with routes_replayed(log) if log else contextlib.nullcontext():
        g32 = grads(f32, p, b)
    errs, zero = [], 0
    for a, w in zip(g16, g32):
        nw = torch.linalg.vector_norm(w)
        if nw == 0:
            zero += 1
            check(torch.linalg.vector_norm(a.float()) == 0,
                  f"{arch}: a grad is 0 in fp32 and not in bf16")
            continue
        errs.append((torch.linalg.vector_norm(a.float() - w) / nw).item())
    say(f"  {arch}: grads bf16 vs fp32 compute per leaf by norm: max "
        f"{max(errs):.4f}, median {float(np.median(errs)):.4f} over "
        f"{len(errs)} leaves ({zero} zero in both; tol {GRAD_TOL:g}); the "
        f"checks took {time.perf_counter() - t0:.1f} s")
    check(max(errs) < GRAD_TOL, f"{arch}: bf16 grads off fp32: {max(errs)}")
    del g16, g32, p


def family_step_report(dev, say, arch: str, step, state, batch, tokens: int,
                       n_active: float, profile: bool,
                       counted: tuple = ()) -> None:
    """Host median (and p90 where ``FAMILY_REPEATS`` takes 10 samples), card
    time, launches (by the profiler's kernel names, or ``CardOps`` where the
    profiler would walk too many), counted
    F and B_M (``counted``, or ``counters.count``) against 6·N·tokens
    (``FAMILY_FLOPS``), the bound on h100_sxm.  The steps before warmed the
    step up; a donated step advances ``state`` with each call."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.measure import counters
    from repro_torch.measure.timers import cuda_event_ms, time_callable

    host = time_callable(step, state, batch, device=dev,
                         repeats=FAMILY_REPEATS[arch], warmup=0)
    p90 = (float(np.percentile(host.samples, 90))
           if len(host.samples) >= 10 else float("nan"))
    card_ms = cuda_event_ms(lambda i: step(state, batch), iters=1, warmup=0)
    if profile:
        kern = profile_kernels(lambda: step(state, batch))
        launches = sum(n for _, n, _ in kern)
        k_ms = sum(ms for _, _, ms in kern)
    else:
        with CardOps() as ops:
            step(state, batch)
            torch.cuda.synchronize()
        launches, kern, k_ms = ops.ops, [], float("nan")
    flops, nbytes = counted or counters.count(step, state, batch)
    ratio = flops / (6.0 * n_active * tokens)
    a = analyze(WorkUnit(f"train_step_{arch}", flops, nbytes, 0.0), H100_SXM)
    lo, hi = FAMILY_FLOPS[arch]
    say(f"  {arch} step: host median {host.median * 1e3:.2f} ms"
        + (f", p90 {p90 * 1e3:.2f} ms" if p90 == p90 else "")
        + f" (n={len(host.samples)}); card {card_ms:.2f} ms; "
        + (f"{launches} launches, {k_ms:.2f} ms of kernels" if profile else
           f"{launches} aten ops on the card (each one launch or more; not "
           f"profiled)")
        + f"; counted F {flops:.6g}, B_M {nbytes:.6g}; F / 6·N·tokens "
        f"{ratio:.4f} (N {n_active:.6g} active, band {lo}-{hi}); h100_sxm: "
        f"{a.summary()}; bound {a.runtime * 1e3:.2f} ms = "
        f"{100 * a.runtime / host.median:.1f}% of the host median")
    for name, n, ms in sorted(kern, key=lambda x: -x[2])[:8]:
        say(f"    {ms:9.3f} ms {100 * ms / k_ms:5.1f}% x{n:<6d} {name[:100]}")
    check(lo < ratio < hi, f"{arch}: counted F / 6NT {ratio} off its band")


def train_families(dev, say, tmp: str) -> None:
    """The moe, hybrid and ssm families trained on the card at full width
    (``FAMILY_TRAIN``; the xLSTM through the launcher, ``XLSTM_CLI``):
    bf16 compute, random weights from seeds, the loss falling over
    ``FAMILY_STEPS`` AdamW steps on one batch; each step timed, counted and
    (but the xLSTM's) profiled, its peak read; then ``family_checks`` at 2
    layers.  Neither kernel launches: training runs the plain products, as
    the JAX package's does (its kernels have no backward)."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.launch.specs import param_counts
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.train import loop

    rng = np.random.default_rng(25)
    for arch, layers, (B, S), remat, lr in FAMILY_TRAIN:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cfg = (family_cut(cfg, layers) if layers else cfg).replace(
            remat=remat)
        total, active = param_counts(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        opt = AdamW(learning_rate=lr)
        state = loop.init_train_state(
            torch.Generator(device=dev).manual_seed(11), cfg, opt,
            device=dev)
        step = loop.build_train_step(cfg, opt,
                                     loop.TrainStepConfig(donate=True))
        batch = lm_batch(rng, cfg.vocab_size, B, S, dev)
        losses, aux = [], []
        for _ in range(FAMILY_STEPS):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            aux.append(m["aux"].item())
        peak = torch.cuda.max_memory_allocated(dev)
        say(f"{arch}: {cfg.n_layers} of {get_config(arch).n_layers} layers, "
            f"{int(total)} fp32 params ({int(active)} active), remat "
            f"{remat}, ({B}, {S}), AdamW {lr:g}, donated: loss "
            + " ".join(f"{x:.4f}" for x in losses) + " (aux "
            + " ".join(f"{x:.4f}" for x in aux) + f"); peak "
            f"{peak / 1e9:.2f} GB")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{arch}: the loss does not fall: {losses}")
        family_step_report(dev, say, arch, step, state, batch, B * S,
                           float(active), profile=True)
        del state, step, batch, m
        torch.cuda.empty_cache()
        family_checks(dev, say, arch, rng)
        say(f"  {arch} took {time.perf_counter() - t0:.1f} s")

    # the xLSTM through the launcher: 4 steps with checkpoints at 2 and 4,
    # the step-4 state restored bit for bit; step 4's checkpoint removed, a
    # second run resumes at 2 and must end in the same state, bit for bit
    t0 = time.perf_counter()
    arch = "xlstm-125m"
    d = os.path.join(tmp, "xlstm")

    def run():
        return launcher.train(launcher.parse_args(
            XLSTM_CLI + ["--steps", "4", "--ckpt-dir", d]))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    straight = run()
    peak = torch.cuda.max_memory_allocated(dev)
    ck = Checkpointer(d)
    check(ck.latest_step() == 4, f"xlstm: newest step {ck.latest_step()}")
    restored, _ = ck.restore(straight.state, step=4)
    equal = leaves_equal(straight.state, restored)
    del restored
    shutil.rmtree(os.path.join(d, "step_000000004"))
    resumed = run()
    same = leaves_equal(straight.state, resumed.state)
    ce1, ce2 = ([h["ce"] for h in r.history] for r in (straight, resumed))
    rel = max(abs(a - b) / abs(b) for a, b in zip(ce2, ce1[2:]))
    say(f"{arch} (launch.train {' '.join(XLSTM_CLI)} --steps 4): CE "
        + " ".join(f"{x:.4f}" for x in ce1) + f"; step 4 restored bit for "
        f"bit: {equal}; resumed at {resumed.history[0]['step']} with step "
        f"4 removed, CE " + " ".join(f"{x:.4f}" for x in ce2)
        + f", max rel {rel:.3e} off the uninterrupted run (tol "
        f"{RESUME_TOL:g}); final state that run's bit for bit: {same}; "
        f"peak {peak / 1e9:.2f} GB")
    check(equal, "xlstm: the restored state differs from the one saved")
    check([h["step"] for h in resumed.history] == [2, 3],
          "xlstm: the second run did not resume at 2")
    check(all(np.isfinite(ce1)) and ce1[-1] < ce1[0],
          f"xlstm: the CE does not fall: {ce1}")
    check(rel < RESUME_TOL, f"xlstm: resumed CE off the uninterrupted: {rel}")
    check(same, "xlstm: the resumed run's final state differs from the "
          "uninterrupted run's")
    del resumed
    shutil.rmtree(d)
    batch = lm_batch(rng, get_config(arch).vocab_size, 8, 512, dev)
    work = straight.report.work
    family_step_report(dev, say, arch, straight.train_step, straight.state,
                       batch, 8 * 512, float(param_counts(
                           get_config(arch))[1]), profile=False,
                       counted=(work.flops, work.mem_bytes))
    del straight, batch
    torch.cuda.empty_cache()
    family_checks(dev, say, arch, rng)
    say(f"  {arch} took {time.perf_counter() - t0:.1f} s")


OUR_GEMMS = ("gemm_sm90_kernel", "gemm_bf16_kernel", "gemm_f32_kernel",
             "gemm_f32_ring_kernel")
#: the flash kernels, by the names the profiler shows
OUR_FLASH = ("flash_sm90_kernel", "flash_bf16_kernel", "flash_f32_kernel")


def op_split(fn) -> dict:
    """Card ms of one ``fn()`` by the profiler, split into the blocked
    matmul (device rows whose name holds one of ``OUR_GEMMS``), the flash
    kernel (one of ``OUR_FLASH``), cuBLAS products (the kernels
    ``aten::mm`` and ``aten::addmm`` launch themselves), batched products
    (``aten::bmm``: a decode's attention contractions, an MoE layer's
    dispatch, expert and combine products), the softmax (``aten::_softmax``)
    and the rest (elementwise ops, casts, the copies ``einsum`` makes, the
    gather); ``total`` and the launches with it."""
    from torch.autograd import DeviceType
    rows = profile_rows(fn)
    kern = [r for r in rows if r.device_type == DeviceType.CUDA]
    total = sum(r.self_device_time_total for r in kern) / 1e3

    def by_op(*names):
        return sum(r.self_device_time_total for r in rows
                   if r.device_type == DeviceType.CPU and r.key in names) / 1e3

    out = {"total": total, "launches": sum(r.count for r in kern),
           "kernel": sum(r.self_device_time_total for r in kern
                         if any(o in r.key for o in OUR_GEMMS)) / 1e3,
           "flash": sum(r.self_device_time_total for r in kern
                        if any(o in r.key for o in OUR_FLASH)) / 1e3,
           "cublas_products": by_op("aten::mm", "aten::addmm"),
           "bmm": by_op("aten::bmm"), "softmax": by_op("aten::_softmax")}
    out["rest"] = total - sum(out[n] for n in ("kernel", "flash",
                                                "cublas_products", "bmm",
                                                "softmax"))
    out["top"] = sorted(((r.key, r.count, r.self_device_time_total / 1e3)
                         for r in kern), key=lambda x: -x[2])[:12]
    return out


def ffn_row(say, path: str, a: torch.Tensor, ws: list, act, launches: int,
            hw, biases: list | None = None) -> dict:
    """The blocked matmul at one FFN shape per launch: ``a`` against each of
    ``ws`` in turn (at decode's sizes one layer's weight after another, so
    no launch finds its weight in L2 from the launch before, as in the
    step), with ``biases`` (one a weight, in the epilogue) where given,
    beside the plain version and ``torch.mm`` (``addmm`` with a bias; +
    the activation), checked against the plain version: one row of the
    summary line."""
    import torch.nn.functional as F

    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.ref import ref_matmul
    from repro_torch.measure.timers import kernel_ms
    n = len(ws)
    bs = biases or [None] * n
    (M, K), N = a.shape, ws[0].shape[1]
    acts = {None: lambda y: y, "silu": F.silu,
            "gelu": lambda y: F.gelu(y, approximate="tanh")}

    def library(i):
        w, b = ws[i % n], bs[i % n]
        return acts[act](torch.mm(a, w) if b is None else torch.addmm(b, a, w))

    k_ms = kernel_ms(lambda i: blocked_matmul(a, ws[i % n], bias=bs[i % n],
                                              act=act), iters=60)
    p_ms = kernel_ms(lambda i: ref_matmul(a, ws[i % n], bias=bs[i % n],
                                          act=act), iters=60)
    lib_ms = kernel_ms(library, iters=60)
    got = blocked_matmul(a, ws[0], bias=bs[0], act=act)
    want = ref_matmul(a, ws[0], bias=bs[0], act=act)
    err_abs, err = max_abs(got, want), rel_err(got, want)
    check(err < TOL[a.dtype],
          f"blocked matmul disagrees at {path}'s ({M},{K},{N}): {err}")
    elem = a.element_size()
    flops = 2.0 * M * K * N
    nbytes = float(elem) * (M * K + K * N + M * N
                            + (N if biases else 0))
    b_ms, b_by = bound_of(flops, nbytes, hw)
    dt = "f32" if a.dtype == torch.float32 else "bf16"
    lib = ("addmm" if biases else "mm") + (f"+{act}" if act else "")
    say(f"  blocked_matmul {dt} ({M},{K},{N}) act={act} bias="
        f"{biases is not None} per launch: kernel "
        f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{nbytes / k_ms / 1e6:.1f} GB/s, "
        f"{100 * b_ms / k_ms:.1f}% of the bound {b_ms:.5f} ms, {b_by}, "
        f"{hw.name}), plain {p_ms:.4f} ms, library {lib}"
        f" {lib_ms:.4f} ms ({k_ms / lib_ms:.2f}x); {launches} {path} "
        f"launches; max_abs_err {err_abs:.3e}, rel_err {err:.3e}")
    return {"path": path, "shape": [M, K, N], "act": act,
            "bias": biases is not None, "dtype": dt,
            "launches": launches, "kernel_ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err_abs, "flops": flops, "bytes": nbytes}


def hold_generation(say, gen_k: torch.Tensor, prompt: torch.Tensor,
                    new: int, plain_step, tf_abs: float, gen_s: float,
                    hist: dict) -> None:
    """(b) of a decode path: ``gen_k``, what ``greedy_generate`` made of
    ``prompt`` in ``new`` steps (``gen_s`` seconds, its step histogram
    ``hist``), held to the plain path teacher-forced on it:
    ``plain_step(t, tokens)`` is the plain step's logits (B, 1, V) at
    position t.  Each path's logits lie within ``tf_abs`` of the other's
    (the teacher-forced check), so at every generated step the kernel
    path's token has a plain logit within 2 x tf_abs of the plain maximum.
    Up to a sequence's first near-tie (plain top-2 gap within 2 x tf_abs)
    its token is the plain argmax, so up to there it is the plain path's
    own greedy generation (the rows of a batch never meet)."""
    B, P = prompt.shape
    check(gen_k.shape == (B, P + new) and torch.equal(gen_k[:, :P], prompt),
          f"greedy_generate gave {tuple(gen_k.shape)}")
    gaps, short, argmax = [], [], []
    for t in range(P + new - 1):
        lg = plain_step(t, gen_k[:, t:t + 1])
        if t + 1 >= P:
            row = lg[:, -1].float()
            top2 = row.topk(2, dim=-1)
            chosen = row.gather(1, gen_k[:, t + 1:t + 2].long())[:, 0]
            gaps.append(top2.values[:, 0] - top2.values[:, 1])
            short.append(top2.values[:, 0] - chosen)
            argmax.append(top2.indices[:, 0] == gen_k[:, t + 1])
    near = (torch.stack(gaps, dim=1) <= 2 * tf_abs).cpu()
    short = torch.stack(short, dim=1).cpu()
    same = torch.stack(argmax, dim=1).cpu()
    ties = [int(r.nonzero()[0]) if r.any() else None for r in near]
    upto = [new if j is None else j for j in ties]
    say(f"  (b) greedy_generate B={B}, prompt {P}, +{new} "
        f"tokens: {B * new / gen_s:.1f} tokens/s ({gen_s:.3f} s for "
        f"{P + new - 1} steps); serve.step_seconds p50 "
        f"{hist['p50'] * 1e3:.4f} ms, p90 {hist['p90'] * 1e3:.4f} ms "
        f"(n={hist['count']})")
    say(f"  (b) the plain path teacher-forced on the generated tokens: "
        f"all {short.numel()} generated steps held; the chosen token's "
        f"plain logit below the plain maximum by at most "
        f"{float(short.max()):.4f} (limit 2 x {tf_abs:.4f}); the chosen "
        f"token is the plain argmax at {int(same.sum())} steps; first "
        f"near-tie (top-2 gap <= 2 x {tf_abs:.4f}) per sequence: "
        + ", ".join("none" if j is None else f"step {j}" for j in ties)
        + f" ({int(near.sum())} of {near.numel()} steps near-ties); the "
        f"plain path's own generation up to there")
    check(hist["count"] == P + new - 1,
          f"serve.step_seconds counted {hist['count']} steps")
    for r in range(B):
        check(bool(same[r, :upto[r]].all()),
              f"sequence {r}: a greedy token differs from the plain argmax "
              f"before its first near-tie (step {ties[r]})")
    check(float(short.max()) <= 2 * tf_abs,
          f"a generated token's plain logit is {float(short.max())} below "
          f"the plain maximum (limit 2 x {tf_abs})")


@torch.no_grad()
def lm_decode(dev, say, params, cfg, tokens) -> tuple:
    """The smollm-135m serving path, full width and depth, bf16, the FFN
    products in the blocked matmul (``use_kernel_matmul``; ``use_flash``
    stays on and must launch nothing): (a) ``DECODE_TF`` teacher-forced
    steps of ``tokens``' first ``DECODE_B`` rows, each step's logits held to
    the plain forward's row; (b) ``serve.engine.greedy_generate`` from
    their first ``GEN_PROMPT`` tokens, every generated token held to the
    plain path's logits; (c) one step at each ``DECODE_TIMED`` batch at the
    cache's last position.  These are the main path: the counts are set to
    0 before (a) and read after (c).  Then (d) the first ``DECODE_F32``
    steps again in fp32 (the ``f32`` kernel), a path of its own, its counts
    set to 0 before it and read after; (e) the step at each batch timed,
    profiled and counted; (f) each FFN shape per launch.  Returns the
    blocked matmul's launches by variant on each path (``lm_decode``,
    ``lm_decode_fp32``), the summary rows and the decode steps for the
    Ridgeline placement."""
    from repro_torch.core.hardware import H100_SXM, H100_SXM_FP32
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.measure import counters
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    NL, V = cfg.n_layers, cfg.vocab_size
    dcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    B, toks = DECODE_B, tokens[:DECODE_B]
    per_step = 3 * NL
    say(f"smollm-135m decode: B={B}, cache {DECODE_MAX}, compute "
        f"{str(cfg.compute_dtype)[6:]}, use_kernel_matmul and use_flash on; "
        f"{DECODE_TF} teacher-forced steps, greedy {GEN_PROMPT} + {GEN_NEW}, "
        f"the step at B={DECODE_TIMED} at pos {DECODE_MAX - 1}")
    want = transformer.forward(params, toks[:, :DECODE_TF], plain)[0]
    rng = np.random.default_rng(3)
    step_toks = {b: toks[:, DECODE_MAX - 1:] if b == B else torch.from_numpy(
        rng.integers(0, V, (b, 1))).to(dev) for b in DECODE_TIMED}
    caches = {b: transformer.init_cache(dcfg, b, DECODE_MAX, device=dev)
              for b in DECODE_TIMED}

    # ---- the main path: (a), (b), (c) -----------------------------------------
    reset_counts()
    cache = transformer.init_cache(dcfg, B, DECODE_MAX, device=dev)
    steps_seen, tf_rel, tf_abs = set(), 0.0, 0.0
    for t in range(DECODE_TF):
        m0, f0 = blocked_matmul.launches, flash_attention_bhsd.launches
        lg, out = transformer.decode_step(params, toks[:, t:t + 1], cache, t,
                                          dcfg)
        steps_seen.add((blocked_matmul.launches - m0,
                        flash_attention_bhsd.launches - f0))
        check(out is cache and lg.shape == (B, 1, V)
              and torch.isfinite(lg).all().item(),
              f"decode step {t}: logits malformed or the cache replaced")
        tf_rel = max(tf_rel, row_rel_err(lg[:, 0], want[:, t]))
        tf_abs = max(tf_abs, max_abs(lg[:, 0], want[:, t]))
    del want, cache
    REGISTRY.reset()
    prompt = toks[:, :GEN_PROMPT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_k = engine.greedy_generate(params, dcfg, prompt, steps=GEN_NEW,
                                   max_len=DECODE_MAX)
    gen_s = time.perf_counter() - t0
    hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
    for b in DECODE_TIMED:
        transformer.decode_step(params, step_toks[b], caches[b],
                                DECODE_MAX - 1, dcfg)
    torch.cuda.synchronize()
    n_steps = DECODE_TF + GEN_PROMPT + GEN_NEW - 1 + len(DECODE_TIMED)
    launched = dict(blocked_matmul.launches_by_variant)
    say(f"(blocked_matmul, flash) launches per teacher-forced step "
        f"{sorted(steps_seen)}; main path ({n_steps} steps): blocked_matmul "
        f"by variant {launched}, flash {flash_attention_bhsd.launches}")
    check(steps_seen == {(per_step, 0)},
          f"expected {per_step} blocked-matmul launches and no flash launch "
          f"a step, got {steps_seen}")
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "sm90": per_step * n_steps}
          and flash_attention_bhsd.launches == 0,
          f"every decode launch must take the sm90 kernel and none the flash "
          f"kernel: {launched}, flash {flash_attention_bhsd.launches}")
    say(f"  (a) teacher-forced logits vs the plain forward over {DECODE_TF} "
        f"steps: row_rel_err {tf_rel:.3e} (tol "
        f"{DECODE_TOL[torch.bfloat16]:g}), max_abs_err {tf_abs:.4f}")
    check(tf_rel < DECODE_TOL[torch.bfloat16],
          f"decode logits disagree with the prefill's: {tf_rel}")

    cache = transformer.init_cache(plain, B, DECODE_MAX, device=dev)
    hold_generation(say, gen_k, prompt, GEN_NEW, lambda t, tok:
                    transformer.decode_step(params, tok, cache, t, plain)[0],
                    tf_abs, gen_s, hist)
    del cache

    # (d) fp32: the f32 kernel, a path of its own
    c32 = dcfg.replace(compute_dtype=torch.float32)
    want = transformer.forward(params, toks[:, :DECODE_F32],
                               plain.replace(compute_dtype=torch.float32))[0]
    cache = transformer.init_cache(c32, B, DECODE_MAX, device=dev)
    reset_counts()
    f32_rel = 0.0
    for t in range(DECODE_F32):
        lg, cache = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                            t, c32)
        f32_rel = max(f32_rel, row_rel_err(lg[:, 0], want[:, t]))
    torch.cuda.synchronize()
    del want, cache
    f32_launched = dict(blocked_matmul.launches_by_variant)
    say(f"  (d) fp32 (TF32 off), {DECODE_F32} steps: row_rel_err "
        f"{f32_rel:.3e} (tol {DECODE_TOL[torch.float32]:g}); launches by "
        f"variant (path lm_decode_fp32) {f32_launched}, flash "
        f"{flash_attention_bhsd.launches}")
    check(f32_rel < DECODE_TOL[torch.float32],
          f"fp32 decode logits disagree with the fp32 forward: {f32_rel}")
    check(f32_launched == {**dict.fromkeys(bm.VARIANTS, 0),
                           "f32": per_step * DECODE_F32}
          and flash_attention_bhsd.launches == 0,
          f"every fp32 decode launch must take the f32 kernel: {f32_launched}")

    # (e) the step timed at each batch, at the cache's last position (the
    # masked form reads the whole S_max at any position: every step's cost)
    n_params = count_params(params)
    placed = []
    for b in DECODE_TIMED:
        tok, cache = step_toks[b], caches[b]
        pos = DECODE_MAX - 1
        host = time_callable(transformer.decode_step, params, tok, cache,
                             pos, dcfg, device=dev, repeats=30, warmup=3)
        p90 = float(np.percentile(host.samples, 90))
        plain_host = time_callable(transformer.decode_step, params, tok,
                                   cache, pos, plain, device=dev, repeats=10,
                                   warmup=2)
        card = cuda_event_ms(lambda i: transformer.decode_step(
            params, tok, cache, pos, dcfg), iters=10)
        m0 = blocked_matmul.launches
        transformer.decode_step(params, tok, cache, pos, dcfg)
        n_launch = blocked_matmul.launches - m0
        split = op_split(lambda: transformer.decode_step(
            params, tok, cache, pos, dcfg))
        # F and B_M counted on the plain path: the counters see aten ops,
        # not the kernel's launches; the products are the same
        check(split["total"] > 0 and split["kernel"] > 0,
              f"the profiler saw no kernel time at B={b}: {split}")
        flops, nbytes = counters.count(transformer.decode_step, params, tok,
                                       cache, pos, plain)
        cache_bytes = 2.0 * cache["k"].numel() * cache["k"].element_size()
        least = 4.0 * n_params + cache_bytes + 2.0 * b * V
        a = analyze(WorkUnit(f"decode_b{b}", flops, nbytes, 0.0), H100_SXM)
        a_least = analyze(WorkUnit(f"decode_b{b}_least", flops, least, 0.0),
                          H100_SXM)
        placed.append({"batch": b, "flops": flops, "mem_bytes": nbytes,
                       "seconds": host.median, "params": float(n_params)})
        say(f"  (e) B={b} step at pos {pos}: host median "
            f"{host.median * 1e3:.4f} ms, p90 {p90 * 1e3:.4f} ms "
            f"(n={len(host.samples)}), {b / host.median:.1f} tokens/s; card "
            f"{card:.4f} ms; plain path host {plain_host.median * 1e3:.4f} ms;"
            f" {n_launch} blocked-matmul launches a step; counted F "
            f"{flops:.6g}, B_M {nbytes:.6g} (plain path, eager ops; the KV "
            f"cache {cache_bytes:.6g}); h100_sxm: {a.summary()}, bound "
            f"{a.runtime * 1e3:.4f} ms = {100 * a.runtime / host.median:.1f}% "
            f"of the host median; least bytes (fp32 params and the cache "
            f"read once, logits written) {least:.6g}: bound "
            f"{a_least.runtime * 1e3:.4f} ms")
        say_split(say, f"(e) B={b} one step's", split, card)
    del caches

    # (f) each FFN shape per launch, every layer's weights in turn
    rows = []
    for dtype, hw in ((torch.bfloat16, H100_SXM),
                      (torch.float32, H100_SXM_FP32)):
        ws = {n: [blk["ffn"][n].to(dtype) for blk in params["blocks"]]
              for n in ("w_gate", "w_up", "w_down")}
        batches = DECODE_TIMED if dtype == torch.bfloat16 else (B,)
        path = "lm_decode" if dtype == torch.bfloat16 else "lm_decode_fp32"
        for b in batches:
            if dtype == torch.float32:
                n = NL * DECODE_F32
            else:
                n = NL * (DECODE_TF + GEN_PROMPT + GEN_NEW - 1 if b == B
                          else 0) + NL
            x_in = torch.from_numpy(rng.standard_normal(
                (b, cfg.d_model), np.float32)).to(dev, dtype)
            x_mid = torch.from_numpy(rng.standard_normal(
                (b, cfg.d_ff), np.float32)).to(dev, dtype)
            for a_, w, act in ((x_in, ws["w_gate"], "silu"),
                               (x_in, ws["w_up"], None),
                               (x_mid, ws["w_down"], None)):
                rows.append(ffn_row(say, path, a_, w, act, n, hw))
        del ws
    paths = {"lm_decode": launched, "lm_decode_fp32": f32_launched}
    for path, made in paths.items():
        covered = sum(r["launches"] for r in rows if r["path"] == path)
        check(covered == sum(made.values()),
              f"the {path} rows cover {covered} launches, the path made "
              f"{made}")
    return paths, rows, placed


def reset_counts() -> None:
    """Every launch count of both wrappers to 0."""
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    for mod, fn in ((bm, bm.blocked_matmul), (fa, fa.flash_attention_bhsd)):
        fn.launches = 0
        fn.launches_by_variant = dict.fromkeys(mod.VARIANTS, 0)


def topk_agreement(log_a: list, log_b: list) -> float:
    """The share of (token, layer) pairs whose top-k expert sets agree
    between two recorded routings of the same tokens."""
    same = [(a.sort(-1).values == b.sort(-1).values).all(-1)
            for a, b in zip(log_a, log_b, strict=True)]
    return torch.cat(same).float().mean().item()


def weight_casts(params, skip=None) -> tuple:
    """(the weight casts of one forward or decode step as a function of a
    call index, their bytes): every matrix leaf but those of ``skip``
    (default: the embedding table, whose rows are gathered, then cast) read
    in fp32, written in bf16."""
    from repro_torch.tree import tree_leaves
    skip = (params["embed"],) if skip is None else skip
    mats = [w for w in tree_leaves(params)
            if w.dim() >= 2 and not any(w is t for t in skip)]

    def casts(_i):
        for w in mats:
            w.to(torch.bfloat16)

    return casts, 6.0 * sum(w.numel() for w in mats)


def say_split(say, label: str, split: dict, card_ms: float) -> None:
    """``op_split``'s reading of one forward or step, against its
    unprofiled card time, and its costliest kernels by name."""
    say(f"  {label} profile: {split['launches']} launches, "
        f"{split['total']:.4f} ms of kernels "
        f"({100 * split['total'] / card_ms:.1f}% of the card time "
        f"{card_ms:.4f} ms); blocked matmul {split['kernel']:.4f} ms, flash "
        f"{split['flash']:.4f} ms, cuBLAS mm (projections, head) "
        f"{split['cublas_products']:.4f} ms, cuBLAS bmm (decode's attention; "
        f"an MoE layer's dispatch, experts, combine) {split['bmm']:.4f} ms, "
        f"softmax {split['softmax']:.4f} ms, the rest (weight casts, "
        f"elementwise, einsum's copies, the gather) {split['rest']:.4f} ms; "
        f"by name, most first:")
    for name, n, ms in split["top"]:
        say(f"    {ms:9.4f} ms {100 * ms / split['total']:5.1f}% x{n:<4d} "
            f"{name[:110]}")


@torch.no_grad()
def moe_prefill(dev, say, params, cfg, tokens: torch.Tensor,
                gen: torch.Generator) -> dict:
    """The qwen2-moe-a2.7b prefill, full width and depth, bf16, with
    ``use_flash`` (dh 128) and ``use_kernel_matmul`` (the shared experts):
    (a) the main path, one forward of ``tokens`` with its routing recorded
    (the routing unchanged), its counts set to 0 before and read after;
    (b) the plain forward with its routing recorded, then the kernel forward
    with that routing replayed, each token's logits row held to the plain
    one within ``MOE_MARGIN`` x the plain path's distance from the fp32
    plain forward (a sequence at a time), and the share of (token, layer)
    top-k sets (a) chose as the plain forward did; (c) the forward timed (host, card),
    its peak memory, the profiler's split, the weight casts alone, F and B_M
    counted on the plain path, against the bound; (d) both kernels per
    launch at the forward's shapes.  Returns the launches by variant, the
    summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)
    from repro_torch.models import moe, transformer
    from repro_torch.models.common import count_params

    kcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    (B, S), V, NL = tokens.shape, cfg.vocab_size, cfg.n_layers
    H, K, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_model
    T = B * S
    Tg = min(cfg.moe_group_tokens, T)
    n_params = count_params(params)
    say(f"{cfg.name} prefill ({B}, {S}): {T // Tg} dispatch groups of {Tg} "
        f"tokens, capacity {moe._capacity(Tg, cfg)} a group and expert; "
        f"use_flash (dh {dh}) and use_kernel_matmul on")

    # (a) the main path
    reset_counts()
    k_log = []
    with routes_recorded(k_log):
        logits, aux = transformer.forward(params, tokens, kcfg)
    torch.cuda.synchronize()
    mm_made = dict(bm.blocked_matmul.launches_by_variant)
    fa_made = dict(fa.flash_attention_bhsd.launches_by_variant)
    say(f"(a) main path, one forward: blocked_matmul by variant {mm_made}, "
        f"flash by variant {fa_made}; aux {float(aux):.6f}")
    check(logits.shape == (B, S, V) and torch.isfinite(logits).all().item()
          and math.isfinite(float(aux)), "moe prefill logits malformed")
    check(mm_made == {**dict.fromkeys(bm.VARIANTS, 0), "sm90": 3 * NL},
          f"expected {3 * NL} sm90 blocked-matmul launches: {mm_made}")
    check(fa_made == {**dict.fromkeys(fa.VARIANTS, 0), "sm90": NL},
          f"expected {NL} sm90 flash launches: {fa_made}")
    del logits

    # (b) kernel path against plain path, on the plain path's routing; the
    # bound from the plain path's own distance from fp32, a sequence (one
    # dispatch group) at a time
    p_log = []
    with routes_recorded(p_log):
        want = transformer.forward(params, tokens, plain)[0]
    with routes_replayed(p_log):
        got = transformer.forward(params, tokens, kcfg)[0]
    f32 = plain.replace(compute_dtype=torch.float32)
    check(Tg == S, f"a sequence alone is not one dispatch group: {Tg} != {S}")
    errs, ref_errs, k32_errs, agree = [], [], [], []
    for b in range(B):
        with routes_replayed([r[b * S:(b + 1) * S] for r in p_log]):
            exact = transformer.forward(params, tokens[b:b + 1], f32)[0][0]
        errs.append(row_rel_err(got[b], want[b]))
        ref_errs.append(row_rel_err(want[b], exact))
        k32_errs.append(row_rel_err(got[b], exact))
        agree.append((got[b].argmax(-1) == want[b].argmax(-1)).float()
                     .mean().item())
        del exact
    del got, want
    same_sets = topk_agreement(k_log, p_log)
    tol = MOE_MARGIN * max(ref_errs)
    say(f"(b) logits, kernel path vs plain path with the plain routing "
        f"replayed, row_rel_err by sequence: "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {MOE_MARGIN:g} x "
        f"{max(ref_errs):.3e} = {tol:.3e}; {LM_TOL:g} held: "
        f"{max(errs) < LM_TOL}); the plain path vs the fp32 plain path "
        + ", ".join(f"{e:.3e}" for e in ref_errs) + "; the kernel path vs "
        "fp32 " + ", ".join(f"{e:.3e}" for e in k32_errs) + "; argmax "
        f"agrees on " + ", ".join(f"{100 * a:.2f}%" for a in agree)
        + f" of rows; unreplayed, (a) chose the plain path's top-"
        f"{cfg.moe_top_k} set at {100 * same_sets:.3f}% of {len(k_log)} x "
        f"{T} (layer, token) pairs")
    check(max(errs) < tol, f"moe prefill logits disagree: {max(errs)}")

    # (c) timed, profiled, counted
    torch.cuda.reset_peak_memory_stats(dev)
    transformer.forward(params, tokens, kcfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    host = time_callable(transformer.forward, params, tokens, kcfg,
                         device=dev, repeats=10, warmup=1)
    p90 = float(np.percentile(host.samples, 90))
    card = cuda_event_ms(lambda i: transformer.forward(params, tokens, kcfg),
                         iters=5, warmup=1)
    plain_card = cuda_event_ms(
        lambda i: transformer.forward(params, tokens, plain), iters=3,
        warmup=1)
    casts, cast_bytes = weight_casts(params)
    cast_ms = kernel_ms(casts, iters=3, warmup=1)
    split = op_split(lambda: transformer.forward(params, tokens, kcfg))
    check(split["kernel"] > 0 and split["flash"] > 0,
          f"the profiler saw neither kernel: {split}")
    flops, nbytes = counters.count(transformer.forward, params, tokens, plain)
    least = 4.0 * n_params + 2.0 * T * V + 8.0 * T
    a_least = analyze(WorkUnit(f"moe_prefill_b{B}_s{S}", flops, least, 0.0),
                      H100_SXM)
    a_counted = analyze(WorkUnit(f"moe_prefill_b{B}_s{S}_counted", flops,
                                 nbytes, 0.0), H100_SXM)
    say(f"(c) forward: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}), "
        f"{T / host.median:.0f} tokens/s; card {card:.4f} ms; plain path "
        f"card {plain_card:.4f} ms; peak memory allocated {peak / 1e9:.3f} GB"
        f"; counted F {flops:.6g}, B_M {nbytes:.6g} (plain path, eager ops)")
    say(f"(c) h100_sxm, least bytes (fp32 params once, logits written) "
        f"{least:.6g}: {a_least.summary()}, bound "
        f"{a_least.runtime * 1e3:.4f} ms = "
        f"{100 * a_least.runtime / host.median:.1f}% of the host median; "
        f"with the counted B_M: bound {a_counted.runtime * 1e3:.4f} ms "
        f"({a_counted.bottleneck.value}); the weight casts alone "
        f"{cast_ms:.4f} ms for {cast_bytes:.6g} bytes "
        f"({cast_bytes / cast_ms / 1e9:.3f} TB/s)")
    say_split(say, "(c) one forward's", split, card)

    # (d) per launch at the forward's shapes
    flash_rows = [flash_row(say, "moe_prefill", fa._launcher(), gen, B, S, H,
                            K, dh, NL)]
    shared = [blk["moe"]["shared"] for blk in params["blocks"]]
    ws = {n: [sh[n].to(torch.bfloat16) for sh in shared]
          for n in ("w_gate", "w_up", "w_down")}
    f = ws["w_down"][0].shape[0]
    x_in = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((T, f), generator=gen, device=dev).to(torch.bfloat16)
    mm_rows = [ffn_row(say, "moe_prefill", a_, w, act, NL, H100_SXM)
               for a_, w, act in ((x_in, ws["w_gate"], "silu"),
                                  (x_in, ws["w_up"], None),
                                  (x_mid, ws["w_down"], None))]
    del ws, x_in, x_mid
    point = {
        "arch": cfg.name, "shape": f"prefill_b{B}_s{S}", "mesh": "1",
        "kind": "prefill", "variant": "use_flash+use_kernel_matmul",
        "flops": flops, "mem_bytes": least, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(peak), "params": float(n_params), "tokens": float(T),
        "seconds": host.median, "main": True,
        "source": "chip_smoke moe_prefill host median",
        "notes": "F counted on the plain path; least bytes: params once, "
                 "logits written"}
    return {"blocked_matmul": mm_made, "flash": fa_made,
            "mm_rows": mm_rows, "flash_rows": flash_rows, "point": point}


@torch.no_grad()
def moe_decode(dev, say, params, cfg, rng: np.random.Generator,
               gen: torch.Generator) -> dict:
    """The qwen2-moe-a2.7b serving path, B = ``MOE_B`` against a cache of
    ``MOE_MAX``, bf16, the shared experts' products in the blocked matmul
    (``use_kernel_matmul``; ``use_flash`` stays on and must launch nothing).
    The main path, its counts set to 0 before (a) and read after (c):
    (a) ``MOE_TF`` teacher-forced steps of the kernel path, each after the
    plain path's step on the same tokens with its routing recorded and
    replayed, the logits held row by row within ``MOE_MARGIN`` x the plain
    step's distance from the fp32 plain step; (b)
    ``serve.engine.greedy_generate`` of ``MOE_PROMPT`` + ``MOE_NEW``
    tokens with its routing recorded, every generated token held to the
    plain path teacher-forced on the generated tokens with that routing;
    (c) one step at the cache's last position.  Then (d) decode against
    the forward where no choice is dropped (``capacity_factor = E / k``,
    ``MOE_NODROP``), in fp32 on the plain path, the forward's routing
    replayed per step; (e) the step at
    the cache's last position timed, profiled and counted; (f) the shared
    experts' products per launch.  Returns the blocked matmul's launches by
    variant, the summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)
    from repro_torch.models import moe, transformer
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    V, NL, k, d = cfg.vocab_size, cfg.n_layers, cfg.moe_top_k, cfg.d_model
    dcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    B, per_step = MOE_B, 3 * NL
    n_params = count_params(params)
    mm, flash = bm.blocked_matmul, fa.flash_attention_bhsd
    toks = torch.from_numpy(rng.integers(0, V, (B, MOE_TF))).to(dev)
    last = torch.from_numpy(rng.integers(0, V, (B, 1))).to(dev)
    say(f"{cfg.name} decode: B={B}, cache {MOE_MAX}, one dispatch group of "
        f"the step's {B} tokens (capacity {moe._capacity(B, cfg)}); "
        f"{MOE_TF} teacher-forced steps, greedy {MOE_PROMPT} + {MOE_NEW}, "
        f"the step at pos {MOE_MAX - 1}")

    # ---- the main path: (a), (b), (c) -----------------------------------------
    f32 = plain.replace(compute_dtype=torch.float32)
    reset_counts()
    ck = transformer.init_cache(dcfg, B, MOE_MAX, device=dev)
    cp = transformer.init_cache(plain, B, MOE_MAX, device=dev)
    c32 = transformer.init_cache(f32, B, MOE_TF, device=dev)
    steps_seen, tf_rel, tf_abs, ref_rel = set(), 0.0, 0.0, 0.0
    for t in range(MOE_TF):
        log = []
        with routes_recorded(log):
            want = transformer.decode_step(params, toks[:, t:t + 1], cp, t,
                                           plain)[0]
        with routes_replayed(log):
            exact = transformer.decode_step(params, toks[:, t:t + 1], c32, t,
                                            f32)[0]
        ref_rel = max(ref_rel, row_rel_err(want[:, 0], exact[:, 0]))
        m0, f0 = mm.launches, flash.launches
        with routes_replayed(log):
            lg, out = transformer.decode_step(params, toks[:, t:t + 1], ck, t,
                                              dcfg)
        steps_seen.add((mm.launches - m0, flash.launches - f0))
        check(out is ck and lg.shape == (B, 1, V)
              and torch.isfinite(lg).all().item(),
              f"moe decode step {t}: logits malformed or the cache replaced")
        tf_rel = max(tf_rel, row_rel_err(lg[:, 0], want[:, 0]))
        tf_abs = max(tf_abs, max_abs(lg[:, 0], want[:, 0]))
    del ck, cp, c32
    REGISTRY.reset()
    prompt, g_log = toks[:, :MOE_PROMPT], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routes_recorded(g_log):
        gen_k = engine.greedy_generate(params, dcfg, prompt, steps=MOE_NEW,
                                       max_len=MOE_MAX)
    gen_s = time.perf_counter() - t0
    hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
    cache = transformer.init_cache(dcfg, B, MOE_MAX, device=dev)
    transformer.decode_step(params, last, cache, MOE_MAX - 1, dcfg)
    torch.cuda.synchronize()
    n_steps = MOE_TF + MOE_PROMPT + MOE_NEW - 1 + 1
    launched = dict(mm.launches_by_variant)
    say(f"(blocked_matmul, flash) launches per teacher-forced step "
        f"{sorted(steps_seen)}; main path ({n_steps} steps): blocked_matmul "
        f"by variant {launched}, flash {flash.launches}")
    check(steps_seen == {(per_step, 0)},
          f"expected {per_step} blocked-matmul launches and no flash launch "
          f"a step, got {steps_seen}")
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "sm90": per_step * n_steps} and flash.launches == 0,
          f"every moe decode launch must take the sm90 kernel and none the "
          f"flash kernel: {launched}, flash {flash.launches}")
    tol = MOE_MARGIN * ref_rel
    say(f"  (a) teacher-forced logits, kernel path vs plain path with the "
        f"plain routing replayed, over {MOE_TF} steps: row_rel_err "
        f"{tf_rel:.3e} (tol {MOE_MARGIN:g} x {ref_rel:.3e} = {tol:.3e}, the "
        f"plain path's distance from the fp32 plain path; "
        f"{DECODE_TOL[torch.bfloat16]:g} held: "
        f"{tf_rel < DECODE_TOL[torch.bfloat16]}), max_abs_err {tf_abs:.4f}")
    check(tf_rel < tol,
          f"moe decode logits disagree with the plain path's: {tf_rel}")
    cp = transformer.init_cache(plain, B, MOE_MAX, device=dev)
    with routes_replayed(g_log):
        hold_generation(say, gen_k, prompt, MOE_NEW, lambda t, tok:
                        transformer.decode_step(params, tok, cp, t, plain)[0],
                        tf_abs, gen_s, hist)
    del cp

    # (d) decode against the forward where no choice is dropped, in fp32 on
    # the plain path: the semantics alone (the cache, positions, a dispatch
    # group of the step's B tokens), not the roundings
    nd = f32.replace(capacity_factor=cfg.n_experts / k)
    Bn, Sn = MOE_NODROP
    check(moe._capacity(Bn, nd) >= Bn and moe._capacity(Bn * Sn, nd)
          >= Bn * Sn, "the no-drop check's capacity drops choices")
    ntoks = torch.from_numpy(rng.integers(0, V, (Bn, Sn))).to(dev)
    f_log = []
    with routes_recorded(f_log):
        full = transformer.forward(params, ntoks, nd)[0]
    per_call = [f_log[i].view(Bn, Sn, k)[:, t]
                for t in range(Sn) for i in range(NL)]
    nc = transformer.init_cache(nd, Bn, Sn, device=dev)
    nd_rel = 0.0
    with routes_replayed(per_call):
        for t in range(Sn):
            lg = transformer.decode_step(params, ntoks[:, t:t + 1], nc, t,
                                         nd)[0]
            nd_rel = max(nd_rel, row_rel_err(lg[:, 0], full[:, t]))
    del full, nc
    say(f"  (d) capacity_factor {nd.capacity_factor:g} (no drops), fp32: "
        f"decode of ({Bn}, {Sn}) tokens against the forward's rows, the "
        f"forward's routing replayed: row_rel_err {nd_rel:.3e} (tol "
        f"{DECODE_TOL[torch.float32]:g})")
    check(nd_rel < DECODE_TOL[torch.float32],
          f"moe decode disagrees with the forward without drops: {nd_rel}")

    # (e) the step at the cache's last position, timed, profiled, counted
    pos = MOE_MAX - 1
    host = time_callable(transformer.decode_step, params, last, cache, pos,
                         dcfg, device=dev, repeats=10, warmup=2)
    p90 = float(np.percentile(host.samples, 90))
    plain_host = time_callable(transformer.decode_step, params, last, cache,
                               pos, plain, device=dev, repeats=5, warmup=1)
    card = cuda_event_ms(lambda i: transformer.decode_step(
        params, last, cache, pos, dcfg), iters=5, warmup=1)
    m0 = mm.launches
    transformer.decode_step(params, last, cache, pos, dcfg)
    n_launch = mm.launches - m0
    casts, cast_bytes = weight_casts(params)
    cast_ms = kernel_ms(casts, iters=3, warmup=1)
    split = op_split(lambda: transformer.decode_step(params, last, cache, pos,
                                                     dcfg))
    check(split["kernel"] > 0, f"the profiler saw no kernel time: {split}")
    flops, nbytes = counters.count(transformer.decode_step, params, last,
                                   cache, pos, plain)
    cache_bytes = 2.0 * cache["k"].numel() * cache["k"].element_size()
    least = 4.0 * n_params + cache_bytes + 2.0 * B * V
    a = analyze(WorkUnit(f"moe_decode_b{B}", flops, nbytes, 0.0), H100_SXM)
    a_least = analyze(WorkUnit(f"moe_decode_b{B}_least", flops, least, 0.0),
                      H100_SXM)
    say(f"  (e) B={B} step at pos {pos}: host median "
        f"{host.median * 1e3:.4f} ms, p90 {p90 * 1e3:.4f} ms "
        f"(n={len(host.samples)}), {B / host.median:.1f} tokens/s; card "
        f"{card:.4f} ms; plain path host {plain_host.median * 1e3:.4f} ms; "
        f"{n_launch} blocked-matmul launches a step; counted F {flops:.6g}, "
        f"B_M {nbytes:.6g} (plain path, eager ops; the KV cache "
        f"{cache_bytes:.6g}); h100_sxm: {a.summary()}, bound "
        f"{a.runtime * 1e3:.4f} ms = {100 * a.runtime / host.median:.1f}% of "
        f"the host median; least bytes (fp32 params and the cache read once, "
        f"logits written) {least:.6g}: bound {a_least.runtime * 1e3:.4f} ms; "
        f"the weight casts alone {cast_ms:.4f} ms for {cast_bytes:.6g} bytes")
    say_split(say, f"(e) B={B} one step's", split, card)
    check(n_launch == per_step, f"{n_launch} launches in the timed step")
    del cache

    # (f) the shared experts' products per launch, each layer's in turn
    shared = [blk["moe"]["shared"] for blk in params["blocks"]]
    ws = {n: [sh[n].to(torch.bfloat16) for sh in shared]
          for n in ("w_gate", "w_up", "w_down")}
    f = ws["w_down"][0].shape[0]
    x_in = torch.randn((B, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((B, f), generator=gen, device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "moe_decode", a_, w, act, NL * n_steps, H100_SXM)
            for a_, w, act in ((x_in, ws["w_gate"], "silu"),
                               (x_in, ws["w_up"], None),
                               (x_mid, ws["w_down"], None))]
    del ws
    point = {
        "arch": cfg.name, "shape": f"decode_b{B}_s{MOE_MAX}", "mesh": "1",
        "kind": "decode", "variant": "use_kernel_matmul", "flops": flops,
        "mem_bytes": nbytes, "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
        "params": float(n_params), "tokens": float(B),
        "seconds": host.median, "main": True,
        "source": "chip_smoke moe_decode host median",
        "notes": "one step at the cache's last position; F and B_M counted "
                 "on the plain path"}
    return {"blocked_matmul": launched, "mm_rows": rows, "point": point}


def moe_paths(dev, say, gen: torch.Generator) -> tuple:
    """qwen2-moe-a2.7b at full width and depth on the card: its weights
    drawn there from a seeded ``torch.Generator`` (fp32, 57 GB), then the
    ``moe_prefill`` and ``moe_decode`` phases; the weights are dropped and
    the allocator's cache emptied before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params

    phase("moe_prefill")
    cfg = get_config(MOE_ARCH)
    say(f"card before the MoE paths: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    t0 = time.perf_counter()
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    say(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.dh}, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff "
        f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared (one FFN of "
        f"{cfg.moe_d_ff * cfg.n_shared_experts}), vocab {cfg.vocab_size}; "
        f"{count_params(params)} fp32 params drawn on the card from seed 0 "
        f"in {time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           MOE_PREFILL)).to(dev)
    pre = moe_prefill(dev, say, params, cfg, tokens, gen)
    phase("moe_decode")
    dec = moe_decode(dev, say, params, cfg, rng, gen)
    del params, tokens
    torch.cuda.empty_cache()
    return pre, dec


def recurrent_rule(say, label: str, got: torch.Tensor, want: torch.Tensor,
                   exact: torch.Tensor) -> float:
    """Hold ``got`` (bf16) to ``want``, the plain bf16 path's rows, within
    max(``LM_TOL``, ``MOE_MARGIN`` x the plain path's own row distance from
    ``exact``, the fp32 plain path's), the rule ``moe_prefill`` set for deep
    random models; both distances are printed.  Returns the tolerance."""
    err, ref = row_rel_err(got, want), row_rel_err(want, exact)
    tol = max(LM_TOL, MOE_MARGIN * ref)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    say(f"{label}: row_rel_err {err:.3e} (tol max({LM_TOL:g}, "
        f"{MOE_MARGIN:g} x {ref:.3e}) = {tol:.3e}); the plain bf16 path vs "
        f"the fp32 plain path {ref:.3e}, this path vs fp32 "
        f"{row_rel_err(got, exact):.3e}; argmax agrees on {100 * agree:.2f}%"
        f" of rows")
    check(err < tol, f"{label} disagrees: {err} (tol {tol})")
    return tol


def branch_split(say, label: str, fn) -> float:
    """One call of a block's branch: its kernels' card time
    (``timers.kernel_ms``) and ``op_split``'s reading, one line.  A short
    profiler session can come back without its device records (an FFN
    branch of 7 launches did on an H100); the line then says so rather than
    print zeros.  Returns the card ms."""
    from repro_torch.measure.timers import kernel_ms
    ms_ = kernel_ms(lambda i: fn(), iters=3, warmup=1)
    s = op_split(fn)
    seen = (f"profiler: {s['launches']} launches, {s['total']:.4f} ms: "
            f"blocked matmul {s['kernel']:.4f}, cuBLAS mm "
            f"{s['cublas_products']:.4f}, bmm {s['bmm']:.4f}, softmax "
            f"{s['softmax']:.4f}, the rest {s['rest']:.4f}; most: "
            + ", ".join(f"{n[:48]} x{c} {t:.3f}" for n, c, t in s["top"][:4])
            if s["launches"] else "the profiler recorded no kernel")
    say(f"  {label}: card {ms_:.4f} ms; {seen}")
    return ms_


@torch.no_grad()
def hybrid_prefill(dev, say, params, cfg, tokens: torch.Tensor,
                   gen: torch.Generator) -> dict:
    """The hymba-1.5b prefill, full width and depth, bf16, the FFN products
    in the blocked matmul (``use_kernel_matmul``; ``use_flash`` on, which
    Hymba's windowed attention never takes): (a) the main path, one forward,
    its counts set to 0 before and read after: 3 sm90 launches a layer and
    no flash; (b) its logits against the plain path's by ``recurrent_rule``;
    (c) the forward timed (host, card), its peak memory, the profiler's
    split (and one layer's attention, Mamba and FFN branches alone), the
    weight casts alone, F and B_M counted on the plain path against the
    bound; (d) the kernel per launch at the FFN's shapes.  Returns the
    launches by variant, the summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)
    from repro_torch.models import ffn, hybrid, mamba, transformer
    from repro_torch.models.common import apply_norm, count_params

    kcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    (B, S), V, NL, d = tokens.shape, cfg.vocab_size, cfg.n_layers, cfg.d_model
    T = B * S
    n_params = count_params(params)
    say(f"{cfg.name} prefill ({B}, {S}): windows "
        f"{sorted(set(hybrid.layer_windows(cfg, S)))} (global layers "
        f"{cfg.global_attn_layers}), SSD chunks of {min(cfg.ssm_chunk, S)}; "
        f"use_kernel_matmul and use_flash on")

    # (a) the main path
    reset_counts()
    logits, aux = transformer.forward(params, tokens, kcfg)
    torch.cuda.synchronize()
    mm_made = dict(bm.blocked_matmul.launches_by_variant)
    fa_made = dict(fa.flash_attention_bhsd.launches_by_variant)
    say(f"(a) main path, one forward: blocked_matmul by variant {mm_made}, "
        f"flash by variant {fa_made}")
    check(logits.shape == (B, S, V) and torch.isfinite(logits).all().item()
          and float(aux) == 0.0, "hybrid prefill logits malformed")
    check(mm_made == {**dict.fromkeys(bm.VARIANTS, 0), "sm90": 3 * NL},
          f"expected {3 * NL} sm90 blocked-matmul launches: {mm_made}")
    check(sum(fa_made.values()) == 0, f"a flash launch in hymba: {fa_made}")

    # (b) against the plain path, held by the fp32 plain path's distance
    want = transformer.forward(params, tokens, plain)[0]
    exact = transformer.forward(params, tokens,
                                plain.replace(compute_dtype=torch.float32))[0]
    recurrent_rule(say, "(b) logits, kernel path vs plain path", logits,
                   want, exact)
    del logits, want, exact

    # (c) timed, profiled, counted
    torch.cuda.reset_peak_memory_stats(dev)
    transformer.forward(params, tokens, kcfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    host = time_callable(transformer.forward, params, tokens, kcfg,
                         device=dev, repeats=10, warmup=1)
    p90 = float(np.percentile(host.samples, 90))
    card = cuda_event_ms(lambda i: transformer.forward(params, tokens, kcfg),
                         iters=5, warmup=1)
    plain_card = cuda_event_ms(
        lambda i: transformer.forward(params, tokens, plain), iters=3,
        warmup=1)
    casts, cast_bytes = weight_casts(params)
    cast_ms = kernel_ms(casts, iters=1, warmup=1)   # ~420 launches a call
    split = op_split(lambda: transformer.forward(params, tokens, kcfg))
    check(split["kernel"] > 0 and split["flash"] == 0,
          f"the profiler saw no blocked matmul, or a flash kernel: {split}")
    flops, nbytes = counters.count(transformer.forward, params, tokens, plain)
    least = 4.0 * n_params + 2.0 * T * V + 8.0 * T
    a_least = analyze(WorkUnit(f"hymba_prefill_b{B}_s{S}", flops, least, 0.0),
                      H100_SXM)
    a_counted = analyze(WorkUnit(f"hymba_prefill_b{B}_s{S}_counted", flops,
                                 nbytes, 0.0), H100_SXM)
    say(f"(c) forward: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}), "
        f"{T / host.median:.0f} tokens/s; card {card:.4f} ms; plain path "
        f"card {plain_card:.4f} ms; peak memory allocated {peak / 1e9:.3f} GB"
        f"; counted F {flops:.6g}, B_M {nbytes:.6g} (plain path, eager ops)")
    say(f"(c) h100_sxm, least bytes (fp32 params once, logits written) "
        f"{least:.6g}: {a_least.summary()}, bound "
        f"{a_least.runtime * 1e3:.4f} ms = "
        f"{100 * a_least.runtime / host.median:.1f}% of the host median; "
        f"with the counted B_M: bound {a_counted.runtime * 1e3:.4f} ms "
        f"({a_counted.bottleneck.value}); the weight casts alone "
        f"{cast_ms:.4f} ms for {cast_bytes:.6g} bytes")
    say_split(say, "(c) one forward's", split, card)
    blk = params["blocks"][1]
    h = apply_norm(blk["pre_norm"], torch.randn(
        (B, S, d), generator=gen, device=dev).to(torch.bfloat16), kcfg)
    say("(c) one local layer's branches alone, on its normed input:")
    parts = [branch_split(say, label, fn) for label, fn in (
        ("attention (plain, full S^2 masked to the window)",
         lambda: hybrid._windowed_attention(blk["attn"], h, kcfg,
                                            cfg.sliding_window)),
        ("Mamba heads (projections, the SSD's products, exps)",
         lambda: mamba.apply_mamba(blk["mamba"], h, kcfg)),
        ("FFN (blocked matmul)", lambda: ffn.apply_ffn(blk["ffn"], h, kcfg)))]
    say(f"(c) x {NL} layers: attention {NL * parts[0]:.1f} ms, Mamba heads "
        f"{NL * parts[1]:.1f} ms, FFN {NL * parts[2]:.1f} ms of the card "
        f"time {card:.1f} ms")
    del h

    # (d) per launch at the FFN's shapes, each layer's weights in turn
    ws = {n: [b["ffn"][n].to(torch.bfloat16) for b in params["blocks"]]
          for n in ("w_gate", "w_up", "w_down")}
    x_in = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((T, cfg.d_ff), generator=gen,
                        device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "hybrid_prefill", a_, w, act, NL, H100_SXM)
            for a_, w, act in ((x_in, ws["w_gate"], "silu"),
                               (x_in, ws["w_up"], None),
                               (x_mid, ws["w_down"], None))]
    del ws, x_in, x_mid
    point = {
        "arch": cfg.name, "shape": f"prefill_b{B}_s{S}", "mesh": "1",
        "kind": "prefill", "variant": "use_kernel_matmul", "flops": flops,
        "mem_bytes": least, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(peak), "params": float(n_params), "tokens": float(T),
        "seconds": host.median, "main": True,
        "source": "chip_smoke hybrid_prefill host median",
        "notes": "F counted on the plain path; least bytes: params once, "
                 "logits written"}
    return {"blocked_matmul": mm_made, "mm_rows": rows, "point": point}


def fill_cache(cache: dict, gen: torch.Generator) -> None:
    """Seeded random content in every buffer of a Hymba or xLSTM cache, in
    place: k and v rows and the sLSTM's stabilizer m and normalizer n (its
    (B, D) states) N(0, 1), the other recurrent states N(0, 0.1^2)."""
    for row in cache.values():
        for name, t in row.items():
            scale = 1.0 if name in ("k", "v") or (
                t.dim() == 2 and name in ("m", "n")) else 0.1
            t.copy_(scale * torch.randn(t.shape, generator=gen,
                                        device=t.device))


def cache_nbytes(cache: dict) -> float:
    from repro_torch.tree import tree_leaves
    return float(sum(t.numel() * t.element_size()
                     for t in tree_leaves(cache)))


@torch.no_grad()
def hybrid_decode(dev, say, params, cfg, rng: np.random.Generator,
                  gen: torch.Generator) -> dict:
    """The hymba-1.5b serving path, B = ``HYBRID_B`` against a cache of
    ``HYBRID_MAX`` (the local layers' rings of 1024 slots), bf16, the FFN
    products in the blocked matmul (``use_kernel_matmul``; ``use_flash`` on
    and unused).  The main path, its counts set to 0 before (a) and read
    after (c): (a) ``HYBRID_TF`` teacher-forced steps from pos 0, held to the
    plain forward's rows by ``recurrent_rule``; (b)
    ``serve.engine.greedy_generate`` of ``HYBRID_PROMPT`` + ``HYBRID_NEW``
    tokens, every generated token held to the plain path teacher-forced on
    them (``hold_generation``); (c) one step at pos ``HYBRID_MAX - 1`` on a
    cache of seeded random content (every ring full and wrapped).  Then
    (d) the rings on the card: a depth cut to 2 layers (0 global, 1 local),
    ``RING_STEPS`` fp32 steps on the plain path against the fp32 forward's
    rows within ``RING_TOL``; (e) the step at (c) timed, profiled and
    counted; (f) the FFN products per launch.  Returns the launches by
    variant, the summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    V, NL, d = cfg.vocab_size, cfg.n_layers, cfg.d_model
    dcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    f32 = plain.replace(compute_dtype=torch.float32)
    B, per_step, pos = HYBRID_B, 3 * NL, HYBRID_MAX - 1
    n_params = count_params(params)
    mm, flash = bm.blocked_matmul, fa.flash_attention_bhsd
    toks = torch.from_numpy(rng.integers(0, V, (B, HYBRID_TF))).to(dev)
    last = torch.from_numpy(rng.integers(0, V, (B, 1))).to(dev)
    say(f"{cfg.name} decode: B={B}, cache {HYBRID_MAX} (global layers "
        f"{HYBRID_MAX} rows, local rings {min(cfg.sliding_window, HYBRID_MAX)}"
        f"); {HYBRID_TF} teacher-forced steps, greedy {HYBRID_PROMPT} + "
        f"{HYBRID_NEW}, the step at pos {pos} on a full, wrapped cache")
    want = transformer.forward(params, toks, plain)[0]
    exact = transformer.forward(params, toks, f32)[0]
    warm = transformer.init_cache(dcfg, B, HYBRID_MAX, device=dev)
    fill_cache(warm, gen)

    # ---- the main path: (a), (b), (c) -----------------------------------------
    reset_counts()
    cache = transformer.init_cache(dcfg, B, HYBRID_MAX, device=dev)
    steps_seen, rows_k = set(), []
    for t in range(HYBRID_TF):
        m0, f0 = mm.launches, flash.launches
        lg, out = transformer.decode_step(params, toks[:, t:t + 1], cache, t,
                                          dcfg)
        steps_seen.add((mm.launches - m0, flash.launches - f0))
        check(out is cache and lg.shape == (B, 1, V)
              and torch.isfinite(lg).all().item(),
              f"hybrid decode step {t}: logits malformed or the cache "
              f"replaced")
        rows_k.append(lg[:, 0])
    del cache
    REGISTRY.reset()
    prompt = toks[:, :HYBRID_PROMPT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_k = engine.greedy_generate(params, dcfg, prompt, steps=HYBRID_NEW,
                                   max_len=HYBRID_MAX)
    gen_s = time.perf_counter() - t0
    hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
    step_lg = transformer.decode_step(params, last, warm, pos, dcfg)[0]
    torch.cuda.synchronize()
    n_steps = HYBRID_TF + HYBRID_PROMPT + HYBRID_NEW - 1 + 1
    launched = dict(mm.launches_by_variant)
    say(f"(blocked_matmul, flash) launches per teacher-forced step "
        f"{sorted(steps_seen)}; main path ({n_steps} steps): blocked_matmul "
        f"by variant {launched}, flash {flash.launches}")
    check(steps_seen == {(per_step, 0)},
          f"expected {per_step} blocked-matmul launches and no flash launch "
          f"a step, got {steps_seen}")
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "sm90": per_step * n_steps} and flash.launches == 0,
          f"every hybrid decode launch must take the sm90 kernel and none "
          f"the flash kernel: {launched}, flash {flash.launches}")
    check(torch.isfinite(step_lg).all().item(),
          "the step on the wrapped cache gave non-finite logits")
    got = torch.stack(rows_k, dim=1)
    recurrent_rule(say, f"  (a) {HYBRID_TF} teacher-forced steps, kernel "
                   f"path vs the plain forward's rows", got, want, exact)
    tf_abs = max_abs(got, want)
    del got, want, exact, rows_k
    cp = transformer.init_cache(plain, B, HYBRID_MAX, device=dev)
    hold_generation(say, gen_k, prompt, HYBRID_NEW, lambda t, tok:
                    transformer.decode_step(params, tok, cp, t, plain)[0],
                    tf_abs, gen_s, hist)
    del cp

    # (d) the rings past their wrap, fp32 on the plain path, depth cut to 2
    ring_cfg = f32.replace(n_layers=2, global_attn_layers=(0,))
    ring_params = dict(params, blocks=params["blocks"][:2])
    rtoks = torch.from_numpy(rng.integers(0, V, (B, RING_STEPS))).to(dev)
    full = transformer.forward(ring_params, rtoks, ring_cfg)[0]
    rc = transformer.init_cache(ring_cfg, B, RING_STEPS, device=dev)
    W = rc["layer1"]["k"].shape[1]
    ring_rel, before, after = 0.0, 0.0, 0.0
    for t in range(RING_STEPS):
        lg = transformer.decode_step(ring_params, rtoks[:, t:t + 1], rc, t,
                                     ring_cfg)[0]
        e = row_rel_err(lg[:, 0], full[:, t])
        ring_rel = max(ring_rel, e)
        if t < W:
            before = max(before, e)
        else:
            after = max(after, e)
    del full, rc
    say(f"  (d) depth cut to 2 layers (layer 0 global with {RING_STEPS} "
        f"rows, layer 1 a ring of {W}), fp32 plain path: {RING_STEPS} "
        f"teacher-forced steps against the forward's rows: row_rel_err "
        f"{ring_rel:.3e} (tol {RING_TOL:g}); before the wrap {before:.3e}, "
        f"after it {after:.3e}")
    check(W == cfg.sliding_window < RING_STEPS,
          f"the ring of {W} does not wrap in {RING_STEPS} steps")
    check(ring_rel < RING_TOL,
          f"hybrid decode past the ring's wrap disagrees: {ring_rel}")

    # (e) the step at pos HYBRID_MAX - 1 on the wrapped cache
    host = time_callable(transformer.decode_step, params, last, warm, pos,
                         dcfg, device=dev, repeats=10, warmup=2)
    p90 = float(np.percentile(host.samples, 90))
    plain_host = time_callable(transformer.decode_step, params, last, warm,
                               pos, plain, device=dev, repeats=5, warmup=1)
    card = cuda_event_ms(lambda i: transformer.decode_step(
        params, last, warm, pos, dcfg), iters=5, warmup=1)
    m0 = mm.launches
    transformer.decode_step(params, last, warm, pos, dcfg)
    n_launch = mm.launches - m0
    casts, cast_bytes = weight_casts(params)
    cast_ms = kernel_ms(casts, iters=1, warmup=1)   # ~420 launches a call
    split = op_split(lambda: transformer.decode_step(params, last, warm, pos,
                                                     dcfg))
    check(split["kernel"] > 0, f"the profiler saw no kernel time: {split}")
    flops, nbytes = counters.count(transformer.decode_step, params, last,
                                   warm, pos, plain)
    c_bytes = cache_nbytes(warm)
    least = 4.0 * n_params + c_bytes + 2.0 * B * V
    a = analyze(WorkUnit(f"hymba_decode_b{B}", flops, nbytes, 0.0), H100_SXM)
    a_least = analyze(WorkUnit(f"hymba_decode_b{B}_least", flops, least, 0.0),
                      H100_SXM)
    say(f"  (e) B={B} step at pos {pos}: host median "
        f"{host.median * 1e3:.4f} ms, p90 {p90 * 1e3:.4f} ms "
        f"(n={len(host.samples)}), {B / host.median:.1f} tokens/s; card "
        f"{card:.4f} ms; plain path host {plain_host.median * 1e3:.4f} ms; "
        f"{n_launch} blocked-matmul launches a step; counted F {flops:.6g}, "
        f"B_M {nbytes:.6g} (plain path, eager ops; the cache {c_bytes:.6g}); "
        f"h100_sxm: {a.summary()}, bound {a.runtime * 1e3:.4f} ms = "
        f"{100 * a.runtime / host.median:.1f}% of the host median; least "
        f"bytes (fp32 params and the cache read once, logits written) "
        f"{least:.6g}: bound {a_least.runtime * 1e3:.4f} ms; the weight "
        f"casts alone {cast_ms:.4f} ms for {cast_bytes:.6g} bytes")
    say_split(say, f"(e) B={B} one step's", split, card)
    check(n_launch == per_step, f"{n_launch} launches in the timed step")
    del warm

    # (f) the FFN products per launch, each layer's in turn
    ws = {n: [b["ffn"][n].to(torch.bfloat16) for b in params["blocks"]]
          for n in ("w_gate", "w_up", "w_down")}
    x_in = torch.randn((B, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((B, cfg.d_ff), generator=gen,
                        device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "hybrid_decode", a_, w, act, NL * n_steps, H100_SXM)
            for a_, w, act in ((x_in, ws["w_gate"], "silu"),
                               (x_in, ws["w_up"], None),
                               (x_mid, ws["w_down"], None))]
    del ws
    point = {
        "arch": cfg.name, "shape": f"decode_b{B}_s{HYBRID_MAX}", "mesh": "1",
        "kind": "decode", "variant": "use_kernel_matmul", "flops": flops,
        "mem_bytes": nbytes, "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
        "params": float(n_params), "tokens": float(B),
        "seconds": host.median, "main": True,
        "source": "chip_smoke hybrid_decode host median",
        "notes": "one step at pos 2047 on a wrapped cache; F and B_M "
                 "counted on the plain path"}
    return {"blocked_matmul": launched, "mm_rows": rows, "point": point}


@torch.no_grad()
def xlstm_prefill(dev, say, params, cfg, tokens: torch.Tensor,
                  gen: torch.Generator) -> dict:
    """The xlstm-125m prefill, full width and depth, bf16 (no kernel of the
    port runs: its products are plain, as in the JAX package): (a) the main
    path, one forward, its counts set to 0 before and read after (none may
    launch); (b) its logits against the fp32 forward by row (printed), and
    the fp32 forward on the card against the same weights' on the CPU at
    (2, 64) within ``CARD_CPU_TOL``; (c) the forward timed
    (``XLSTM_SAMPLES``), its peak memory, the profiler's split and launch
    count at ``XLSTM_PROFILE_LAYERS`` mLSTM blocks, the sLSTM's recurrence
    alone, F and B_M counted, against the bound.  Returns the Ridgeline
    point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    from repro_torch.models import ssm, transformer
    from repro_torch.models.common import apply_norm, count_params
    from repro_torch.tree import tree_map

    (B, S), V = tokens.shape, cfg.vocab_size
    T = B * S
    f32 = cfg.replace(compute_dtype=torch.float32)
    n_params = count_params(params)
    say(f"{cfg.name} prefill ({B}, {S}): mLSTM chunks of "
        f"{min(cfg.ssm_chunk, S)}, sLSTM at layers {cfg.slstm_layers} "
        f"({S} steps each)")

    # (a) the main path
    reset_counts()
    t0 = time.perf_counter()
    logits, aux = transformer.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    made = (bm.blocked_matmul.launches, fa.flash_attention_bhsd.launches)
    say(f"(a) main path, one forward ({first_s:.3f} s): (blocked_matmul, "
        f"flash) launches {made}")
    check(logits.shape == (B, S, V) and torch.isfinite(logits).all().item()
          and float(aux) == 0.0, "xlstm prefill logits malformed")
    check(made == (0, 0), f"xlstm launched a kernel of the port: {made}")

    # (b) bf16 against fp32; the card against the CPU
    exact = transformer.forward(params, tokens, f32)[0]
    agree = (logits.argmax(-1) == exact.argmax(-1)).float().mean().item()
    say(f"(b) bf16 vs the fp32 forward: row_rel_err "
        f"{row_rel_err(logits, exact):.3e}, argmax agrees on "
        f"{100 * agree:.2f}% of rows")
    del logits, exact
    cpu_params = tree_map(lambda t: t.cpu(), params)
    short = tokens[:2, :64]
    on_card = transformer.forward(params, short, f32)[0]
    on_cpu = transformer.forward(cpu_params, short.cpu(), f32)[0]
    e_cpu = row_rel_err(on_card.cpu(), on_cpu)
    say(f"(b) fp32 (2, 64): the card vs the CPU on the same weights, "
        f"row_rel_err {e_cpu:.3e} (tol {CARD_CPU_TOL:g})")
    check(e_cpu < CARD_CPU_TOL, f"xlstm on the card disagrees with the "
          f"CPU: {e_cpu}")
    del cpu_params

    # (c) timed, profiled, counted
    torch.cuda.reset_peak_memory_stats(dev)
    transformer.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    host = time_callable(transformer.forward, params, tokens, cfg,
                         device=dev, repeats=XLSTM_SAMPLES, warmup=0)
    p90 = float(np.percentile(host.samples, 90))
    card = cuda_event_ms(lambda i: transformer.forward(params, tokens, cfg),
                         iters=1, warmup=0)
    # the profiler walks every launch (~112k a forward at full depth, a
    # minute of the host's): the split at a depth cut to
    # XLSTM_PROFILE_LAYERS mLSTM blocks; the sLSTM timed alone below
    k = XLSTM_PROFILE_LAYERS
    cut = cfg.replace(n_layers=k, slstm_layers=tuple(
        i for i in cfg.slstm_layers if i < k))
    cut_params = dict(params, blocks=params["blocks"][:k])
    cut_card = cuda_event_ms(
        lambda i: transformer.forward(cut_params, tokens, cut), iters=1,
        warmup=0)
    split = op_split(lambda: transformer.forward(cut_params, tokens, cut))
    blk = params["blocks"][cfg.slstm_layers[0]]
    h = apply_norm(blk["norm"], torch.randn((B, S, cfg.d_model), generator=gen,
                                            device=dev), cfg)
    s_ms = cuda_event_ms(lambda i: ssm.apply_slstm(blk["slstm"], h, cfg),
                         iters=1, warmup=0)
    flops, nbytes = counters.count(transformer.forward, params, tokens, cfg)
    least = 4.0 * n_params + 2.0 * T * V + 8.0 * T
    a_least = analyze(WorkUnit(f"xlstm_prefill_b{B}_s{S}", flops, least, 0.0),
                      H100_SXM)
    a_counted = analyze(WorkUnit(f"xlstm_prefill_b{B}_s{S}_counted", flops,
                                 nbytes, 0.0), H100_SXM)
    say(f"(c) forward: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}), "
        f"{T / host.median:.0f} tokens/s; card {card:.4f} ms; one sLSTM "
        f"layer alone {s_ms:.4f} ms (card, {S} steps); peak memory "
        f"allocated {peak / 1e9:.3f} GB; counted F {flops:.6g}, B_M "
        f"{nbytes:.6g}; {split['launches']} launches a forward at {k} of "
        f"{cfg.n_layers} layers ({len(cut.slstm_layers)} of "
        f"{len(cfg.slstm_layers)} sLSTM blocks)")
    say(f"(c) h100_sxm, least bytes (fp32 params once, logits written) "
        f"{least:.6g}: {a_least.summary()}, bound "
        f"{a_least.runtime * 1e3:.4f} ms = "
        f"{100 * a_least.runtime / host.median:.2f}% of the host median; "
        f"with the counted B_M: bound {a_counted.runtime * 1e3:.4f} ms "
        f"({a_counted.bottleneck.value})")
    say_split(say, f"(c) one forward's at {k} layers", split, cut_card)
    return {"point": {
        "arch": cfg.name, "shape": f"prefill_b{B}_s{S}", "mesh": "1",
        "kind": "prefill", "variant": "plain", "flops": flops,
        "mem_bytes": least, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(peak), "params": float(n_params), "tokens": float(T),
        "seconds": host.median, "main": True,
        "source": "chip_smoke xlstm_prefill host median",
        "notes": "F counted; least bytes: params once, logits written"}}


@torch.no_grad()
def xlstm_decode(dev, say, params, cfg, rng: np.random.Generator,
                 gen: torch.Generator) -> dict:
    """The xlstm-125m serving path, B = ``XLSTM_B``, bf16 (no kernel of the
    port runs).  The main path, its counts set to 0 before (a) and read
    after (c), which must find no launch: (a) ``XLSTM_TF`` teacher-forced
    steps from the zero state against the forward's rows, in bf16 by
    ``recurrent_rule`` and in fp32 within ``RING_TOL``; (b)
    ``serve.engine.greedy_generate`` of ``XLSTM_PROMPT`` + ``XLSTM_NEW``
    tokens, every generated token held (``hold_generation``); (c) one step
    on a state of seeded random content, timed (host, card), profiled and
    counted.  Returns the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    V, B = cfg.vocab_size, XLSTM_B
    f32 = cfg.replace(compute_dtype=torch.float32)
    n_params = count_params(params)
    toks = torch.from_numpy(rng.integers(0, V, (B, XLSTM_TF))).to(dev)
    last = torch.from_numpy(rng.integers(0, V, (B, 1))).to(dev)
    say(f"{cfg.name} decode: B={B}; {XLSTM_TF} teacher-forced steps in bf16 "
        f"and fp32, greedy {XLSTM_PROMPT} + {XLSTM_NEW}, the step timed on "
        f"a random state")
    reset_counts()

    # (a) teacher-forced, bf16 and fp32
    for c in (cfg, f32):
        want = transformer.forward(params, toks, c)[0]
        cache = transformer.init_cache(c, B, XLSTM_TF, device=dev)
        rows = []
        for t in range(XLSTM_TF):
            lg, out = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                              t, c)
            check(out is cache and torch.isfinite(lg).all().item(),
                  f"xlstm decode step {t}: malformed")
            rows.append(lg[:, 0])
        got = torch.stack(rows, dim=1)
        if c is cfg:
            exact = transformer.forward(params, toks, f32)[0]
            recurrent_rule(say, f"  (a) {XLSTM_TF} teacher-forced bf16 steps"
                           f" vs the bf16 forward's rows", got, want, exact)
            tf_abs = max_abs(got, want)
            del exact
        else:
            e = row_rel_err(got, want)
            say(f"  (a) {XLSTM_TF} teacher-forced fp32 steps vs the fp32 "
                f"forward's rows: row_rel_err {e:.3e} (tol {RING_TOL:g})")
            check(e < RING_TOL, f"xlstm fp32 decode disagrees: {e}")
        del want, cache, got

    # (b) greedy generation, held
    REGISTRY.reset()
    prompt = toks[:, :XLSTM_PROMPT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_k = engine.greedy_generate(params, cfg, prompt, steps=XLSTM_NEW,
                                   max_len=XLSTM_PROMPT + XLSTM_NEW)
    gen_s = time.perf_counter() - t0
    hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
    cp = transformer.init_cache(cfg, B, 1, device=dev)
    hold_generation(say, gen_k, prompt, XLSTM_NEW, lambda t, tok:
                    transformer.decode_step(params, tok, cp, t, cfg)[0],
                    tf_abs, gen_s, hist)

    # (c) one step on a state of seeded random content
    warm = transformer.init_cache(cfg, B, 1, device=dev)
    fill_cache(warm, gen)
    state0 = {k: dict(v) for k, v in warm.items()}

    def step():
        for k, v in state0.items():     # the same state at every call
            warm[k].update(v)
        return transformer.decode_step(params, last, warm, 0, cfg)[0]

    check(torch.isfinite(step()).all().item(),
          "the xlstm step on a random state gave non-finite logits")
    torch.cuda.synchronize()
    made = (bm.blocked_matmul.launches, fa.flash_attention_bhsd.launches)
    say(f"main path: (blocked_matmul, flash) launches {made}")
    check(made == (0, 0), f"xlstm decode launched a kernel of the port: "
          f"{made}")
    host = time_callable(step, device=dev, repeats=20, warmup=2)
    p90 = float(np.percentile(host.samples, 90))
    card = cuda_event_ms(lambda i: step(), iters=10, warmup=2)
    split = op_split(step)
    flops, nbytes = counters.count(step)
    s_bytes = cache_nbytes(warm)
    least = 4.0 * n_params + 2.0 * s_bytes + 2.0 * B * V
    a = analyze(WorkUnit(f"xlstm_decode_b{B}", flops, nbytes, 0.0), H100_SXM)
    a_least = analyze(WorkUnit(f"xlstm_decode_b{B}_least", flops, least, 0.0),
                      H100_SXM)
    say(f"  (c) B={B} step: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}), "
        f"{B / host.median:.1f} tokens/s; card {card:.4f} ms; counted F "
        f"{flops:.6g}, B_M {nbytes:.6g} (the state {s_bytes:.6g}); h100_sxm:"
        f" {a.summary()}, bound {a.runtime * 1e3:.4f} ms = "
        f"{100 * a.runtime / host.median:.1f}% of the host median; least "
        f"bytes (fp32 params once, the state read and written, logits) "
        f"{least:.6g}: bound {a_least.runtime * 1e3:.4f} ms")
    say_split(say, f"(c) B={B} one step's", split, card)
    return {"point": {
        "arch": cfg.name, "shape": f"decode_b{B}", "mesh": "1",
        "kind": "decode", "variant": "plain", "flops": flops,
        "mem_bytes": nbytes, "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
        "params": float(n_params), "tokens": float(B),
        "seconds": host.median, "main": True,
        "source": "chip_smoke xlstm_decode host median",
        "notes": "one step on a random state; F and B_M counted"}}


def recurrent_paths(dev, say, gen: torch.Generator) -> dict:
    """hymba-1.5b, then xlstm-125m, at full width and depth on the card,
    each model's weights drawn there from a seeded ``torch.Generator``:
    the ``hybrid_prefill``, ``hybrid_decode``, ``xlstm_prefill`` and
    ``xlstm_decode`` phases; each model's weights are dropped and the
    allocator's cache emptied after its phases."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params

    out = {}
    for arch in (HYMBA_ARCH, XLSTM_ARCH):
        phase("hybrid_prefill" if arch == HYMBA_ARCH else "xlstm_prefill")
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = transformer.init_lm(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, "
                 f"ssm_state {cfg.ssm_state}, d_ff {cfg.d_ff}, window "
                 f"{cfg.sliding_window} but layers {cfg.global_attn_layers}"
                 if arch == HYMBA_ARCH else
                 f"{cfg.n_heads} heads, sLSTM at {cfg.slstm_layers}")
        say(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {shape}, "
            f"vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}; "
            f"{count_params(params)} fp32 params drawn on the card from seed "
            f"0 in {time.perf_counter() - t0:.2f}s; "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
        rng = np.random.default_rng(7)
        if arch == HYMBA_ARCH:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, HYBRID_PREFILL)).to(dev)
            out["hybrid_prefill"] = hybrid_prefill(dev, say, params, cfg,
                                                   tokens, gen)
            say(f"hybrid_prefill took {time.perf_counter() - t_phase:.1f} s")
            phase("hybrid_decode")
            t_phase = time.perf_counter()
            out["hybrid_decode"] = hybrid_decode(dev, say, params, cfg, rng,
                                                 gen)
            say(f"hybrid_decode took {time.perf_counter() - t_phase:.1f} s")
        else:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, XLSTM_PREFILL)).to(dev)
            out["xlstm_prefill"] = xlstm_prefill(dev, say, params, cfg,
                                                 tokens, gen)
            say(f"xlstm_prefill took {time.perf_counter() - t_phase:.1f} s")
            phase("xlstm_decode")
            t_phase = time.perf_counter()
            out["xlstm_decode"] = xlstm_decode(dev, say, params, cfg, rng,
                                               gen)
            say(f"xlstm_decode took {time.perf_counter() - t_phase:.1f} s")
        del params, tokens
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def launches_recorded(log: list):
    """Append one tuple a kernel launch while the block runs: ``("mm", M,
    K, N, act, bias given, variant)`` for the blocked matmul, ``("flash",
    B, H, K, S, dh, causal, variant)`` for the flash kernel.  The launches
    and the wrappers' counters are as before."""
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    real_mm, real_fa = bm._launch, fa.launch

    def mm(a, b, bias, act, kind):
        log.append(("mm", a.shape[0], a.shape[1], b.shape[1], act,
                    bias is not None, kind))
        return real_mm(a, b, bias, act, kind)

    def flash(fns, kind, q, k, v, out, causal, window, seq_len):
        log.append(("flash", q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    q.shape[3], bool(causal), kind))
        return real_fa(fns, kind, q, k, v, out, causal, window, seq_len)

    bm._launch, fa.launch = mm, flash
    try:
        yield log
    finally:
        bm._launch, fa.launch = real_mm, real_fa


def launch_tally(log: list) -> dict:
    """How many of each launch ``launches_recorded`` saw."""
    tally: dict = {}
    for key in log:
        tally[key] = tally.get(key, 0) + 1
    return tally


def jitter_vectors(params, gen: torch.Generator) -> None:
    """Move every vector leaf (norm scales and biases, drawn as ones and
    zeros) off its init by N(0, 0.1^2), in place, so a kernel that drops a
    bias shows in the logits."""
    from repro_torch.tree import tree_leaves
    for t in tree_leaves(params):
        if t.dim() == 1:
            t.add_(0.1 * torch.randn(t.shape, generator=gen, device=t.device))


def prefill_report(say, label: str, fn, dev, plain_fn, count_fn,
                   least: float, repeats: int) -> tuple:
    """(c) of a prefill: ``fn()`` timed (host median and p90, card), its
    peak memory, ``plain_fn()``'s card time, the profiler's split, F and
    B_M counted by ``count_fn()`` on the plain path, and the bound with
    ``least`` bytes and with the counted ones on h100_sxm.  Returns (the
    host timing, F, the peak)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.measure.timers import cuda_event_ms, time_callable
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    host = time_callable(fn, device=dev, repeats=repeats, warmup=1)
    p90 = float(np.percentile(host.samples, 90))
    card = cuda_event_ms(lambda i: fn(), iters=max(2, repeats // 2),
                         warmup=1)
    plain_card = cuda_event_ms(lambda i: plain_fn(), iters=2, warmup=1)
    split = op_split(fn)
    check(split["kernel"] > 0 and split["flash"] > 0,
          f"{label}: the profiler saw neither kernel: {split}")
    flops, nbytes = count_fn()
    a_least = analyze(WorkUnit(label, flops, least, 0.0), H100_SXM)
    a_counted = analyze(WorkUnit(label + "_counted", flops, nbytes, 0.0),
                        H100_SXM)
    say(f"(c) {label}: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}); card {card:.4f} ms; "
        f"plain path card {plain_card:.4f} ms; peak memory allocated "
        f"{peak / 1e9:.3f} GB; counted F {flops:.6g}, B_M {nbytes:.6g} "
        f"(plain path, eager ops)")
    say(f"(c) {label} on h100_sxm, least bytes {least:.6g}: "
        f"{a_least.summary()}, bound {a_least.runtime * 1e3:.4f} ms = "
        f"{100 * a_least.runtime / host.median:.1f}% of the host median; "
        f"with the counted B_M: bound {a_counted.runtime * 1e3:.4f} ms "
        f"({a_counted.bottleneck.value})")
    say_split(say, f"(c) {label}", split, card)
    return host, flops, peak


def step_report(say, label: str, step, plain_step, count_fn, dev,
                least: float, per_step: int, casts) -> tuple:
    """(e) of a decode path: ``step()`` timed (host median and p90, card),
    ``plain_step()``'s host time, its blocked-matmul launches (must be
    ``per_step``), the weight casts alone (``casts`` of ``weight_casts``),
    the profiler's split, F and B_M counted on the plain path against the
    bound, and with ``least`` bytes.  Returns (the host timing, F, B_M)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.measure.timers import (cuda_event_ms, kernel_ms,
                                            time_callable)
    host = time_callable(step, device=dev, repeats=10, warmup=2)
    p90 = float(np.percentile(host.samples, 90))
    plain_host = time_callable(plain_step, device=dev, repeats=5, warmup=1)
    card = cuda_event_ms(lambda i: step(), iters=5, warmup=1)
    m0 = bm.blocked_matmul.launches
    step()
    n_launch = bm.blocked_matmul.launches - m0
    cast_fn, cast_bytes = casts
    cast_ms = kernel_ms(cast_fn, iters=1, warmup=1)
    split = op_split(step)
    check(split["kernel"] > 0, f"{label}: the profiler saw no kernel time")
    flops, nbytes = count_fn()
    a = analyze(WorkUnit(label, flops, nbytes, 0.0), H100_SXM)
    a_least = analyze(WorkUnit(label + "_least", flops, least, 0.0),
                      H100_SXM)
    say(f"  (e) {label}: host median {host.median * 1e3:.4f} ms, p90 "
        f"{p90 * 1e3:.4f} ms (n={len(host.samples)}); card {card:.4f} ms; "
        f"plain path host {plain_host.median * 1e3:.4f} ms; {n_launch} "
        f"blocked-matmul launches a step; counted F {flops:.6g}, B_M "
        f"{nbytes:.6g} (plain path, eager ops); h100_sxm: {a.summary()}, "
        f"bound {a.runtime * 1e3:.4f} ms = "
        f"{100 * a.runtime / host.median:.1f}% of the host median; least "
        f"bytes (fp32 params and the cache read once, logits written) "
        f"{least:.6g}: bound {a_least.runtime * 1e3:.4f} ms; the weight "
        f"casts alone {cast_ms:.4f} ms for {cast_bytes:.6g} bytes")
    say_split(say, f"(e) {label}", split, card)
    check(n_launch == per_step, f"{label}: {n_launch} launches in the step")
    return host, flops, nbytes


def bf16_copies(blocks: list, path: tuple) -> list:
    """Leaf ``path`` of each block in bf16 (the per-launch rows' weights)."""
    out = []
    for blk in blocks:
        t = blk
        for key in path:
            t = t[key]
        out.append(t.to(torch.bfloat16))
    return out


@torch.no_grad()
def encdec_prefill(dev, say, params, cfg, frames: torch.Tensor,
                   tokens: torch.Tensor, gen: torch.Generator) -> dict:
    """The whisper-tiny prefill, full width and depth, bf16, with
    ``use_flash`` and ``use_kernel_matmul``: (a) the main path, ``encode``
    of ``frames`` and ``forward`` of ``tokens`` over them, its counts set
    to 0 before and read after and each launch recorded: the encoder's
    attention in the flash kernel non-causal at S = 1500, the decoder's
    self-attention causal, every FFN product in the blocked matmul with
    its bias (and the GELU) in the epilogue; (b) the encoder's states and
    the logits held to the plain path's by ``recurrent_rule``, and the fp32
    kernel path (the f32 kernels) to the fp32 plain path within
    ``DECODE_TOL``; (c) ``encode`` alone and the forward timed, profiled and
    counted against the bound; (d) both kernels per launch at the path's
    shapes.  Returns the launches by variant, the summary rows (and the
    encoder's rows apart) and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.models import encdec
    from repro_torch.models.common import count_params

    kcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    f32 = plain.replace(compute_dtype=torch.float32)
    (B, S), T = tokens.shape, frames.shape[1]
    V, NL, NE, d, f = (cfg.vocab_size, cfg.n_layers, cfg.encoder_layers,
                       cfg.d_model, cfg.d_ff)
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    n_params = count_params(params)
    say(f"{cfg.name} prefill: frames ({B}, {T}, {d}) through {NE} encoder "
        f"layers, tokens ({B}, {S}) through {NL} decoder layers; use_flash "
        f"and use_kernel_matmul on")

    # (a) the main path
    reset_counts()
    enc_log, fwd_log = [], []
    with launches_recorded(enc_log):
        enc = encdec.encode(params, frames, kcfg)
    with launches_recorded(fwd_log):
        logits, aux = encdec.forward(params, tokens, frames, kcfg)
    torch.cuda.synchronize()
    mm_made = dict(bm.blocked_matmul.launches_by_variant)
    fa_made = dict(fa.flash_attention_bhsd.launches_by_variant)
    enc_want = {("flash", B, H, K, T, dh, False, "sm90"): NE,
                ("mm", B * T, d, f, "gelu", True, "sm90"): NE,
                ("mm", B * T, f, d, None, True, "sm90"): NE}
    dec_want = {("flash", B, H, K, S, dh, True, "sm90"): NL,
                ("mm", B * S, d, f, "gelu", True, "sm90"): NL,
                ("mm", B * S, f, d, None, True, "sm90"): NL}
    say(f"(a) main path: encode launched {launch_tally(enc_log)}; the "
        f"forward {launch_tally(fwd_log)}; blocked_matmul by variant "
        f"{mm_made}, flash by variant {fa_made}")
    check(launch_tally(enc_log) == enc_want,
          f"encode must launch the flash kernel non-causal and the FFN "
          f"kernel with its bias: {launch_tally(enc_log)}")
    check(launch_tally(fwd_log) == {**enc_want, **dec_want},
          f"the forward's launches: {launch_tally(fwd_log)}")
    check(mm_made == {**dict.fromkeys(bm.VARIANTS, 0),
                      "sm90": 4 * NE + 2 * NL}
          and fa_made == {**dict.fromkeys(fa.VARIANTS, 0),
                          "sm90": 2 * NE + NL},
          f"every encdec prefill launch must take sm90: {mm_made}, "
          f"{fa_made}")
    check(enc.shape == (B, T, d) and torch.isfinite(enc).all().item()
          and logits.shape == (B, S, V)
          and torch.isfinite(logits).all().item() and float(aux) == 0.0,
          "encdec prefill output malformed")

    # (b) against the plain path, held by the fp32 plain path's distance;
    # the fp32 kernel path against the fp32 plain path
    recurrent_rule(say, "(b) encoder states, kernel path vs plain path", enc,
                   encdec.encode(params, frames, plain),
                   encdec.encode(params, frames, f32))
    want = encdec.forward(params, tokens, frames, plain)[0]
    exact = encdec.forward(params, tokens, frames, f32)[0]
    recurrent_rule(say, "(b) logits, kernel path vs plain path", logits,
                   want, exact)
    del enc, logits, want
    k32 = encdec.forward(params, tokens, frames,
                         f32.replace(use_flash=True,
                                     use_kernel_matmul=True))[0]
    e32 = row_rel_err(k32, exact)
    say(f"(b) fp32 logits, the kernel path (the f32 kernels) vs the plain "
        f"path: row_rel_err {e32:.3e} (tol {DECODE_TOL[torch.float32]:g})")
    check(e32 < DECODE_TOL[torch.float32],
          f"the fp32 encdec kernel path disagrees: {e32}")
    del k32, exact

    # (c) encode alone, then the forward: timed, profiled, counted
    enc_params = 4.0 * count_params([params["enc_blocks"],
                                     params["enc_norm"]])
    enc_host, _, _ = prefill_report(
        say, f"whisper_encode_b{B}_t{T}",
        lambda: encdec.encode(params, frames, kcfg), dev,
        lambda: encdec.encode(params, frames, plain),
        lambda: counters.count(encdec.encode, params, frames, plain),
        enc_params + 4.0 * B * T * d + 2.0 * B * T * d, 10)
    least = 4.0 * n_params + 4.0 * B * T * d + 2.0 * B * S * V + 8.0 * B * S
    host, flops, peak = prefill_report(
        say, f"whisper_prefill_b{B}_s{S}",
        lambda: encdec.forward(params, tokens, frames, kcfg), dev,
        lambda: encdec.forward(params, tokens, frames, plain),
        lambda: counters.count(encdec.forward, params, tokens, frames, plain),
        least, 10)
    say(f"(c) encode is {100 * enc_host.median / host.median:.1f}% of the "
        f"forward's host median; {B * S / host.median:.0f} decoder "
        f"tokens/s")

    # (d) per launch at the path's shapes, each layer's weights in turn
    fns = fa._launcher()
    enc_flash = flash_row(say, "encdec_prefill", fns, gen, B, T, H, K, dh,
                          2 * NE, causal=False)
    dec_flash = flash_row(say, "encdec_prefill", fns, gen, B, S, H, K, dh, NL)
    rows = []
    for blocks, M, n in ((params["enc_blocks"], B * T, 2 * NE),
                         (params["dec_blocks"], B * S, NL)):
        x_in = torch.randn((M, d), generator=gen, device=dev).to(torch.bfloat16)
        x_mid = torch.randn((M, f), generator=gen,
                            device=dev).to(torch.bfloat16)
        rows += [ffn_row(say, "encdec_prefill", x_in,
                         bf16_copies(blocks, ("ffn", "w_up")), "gelu", n,
                         H100_SXM, bf16_copies(blocks, ("ffn", "b_up"))),
                 ffn_row(say, "encdec_prefill", x_mid,
                         bf16_copies(blocks, ("ffn", "w_down")), None, n,
                         H100_SXM, bf16_copies(blocks, ("ffn", "b_down")))]
    point = {
        "arch": cfg.name, "shape": f"prefill_b{B}_s{S}_t{T}", "mesh": "1",
        "kind": "prefill", "variant": "use_flash+use_kernel_matmul",
        "flops": flops, "mem_bytes": least, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(peak), "params": float(n_params),
        "tokens": float(B * S), "seconds": host.median, "main": True,
        "source": "chip_smoke encdec_prefill host median",
        "notes": "encode + decoder forward; F counted on the plain path; "
                 "least bytes: params once, frames read, logits written"}
    return {"blocked_matmul": mm_made, "flash": fa_made, "mm_rows": rows,
            "flash_rows": [enc_flash, dec_flash],
            "encoder_rows": [enc_flash] + rows[:2], "point": point}


@torch.no_grad()
def encdec_decode(dev, say, params, cfg, frames: torch.Tensor,
                  rng: np.random.Generator, gen: torch.Generator,
                  encoder_rows: list) -> dict:
    """The whisper-tiny serving path, B = ``ENCDEC_B`` against a cache of
    448 (the learned positions' context), bf16, ``use_flash`` and
    ``use_kernel_matmul``.  The main path, its counts set to 0 before (a)
    and read after (c), each launch recorded: (a) ``init_encdec_cache``
    (the encoder once, its flash launches non-causal) and ``ENCDEC_TF``
    teacher-forced steps from pos 0, held to the plain forward's rows by
    ``recurrent_rule``; (b) ``serve.engine.greedy_generate`` with the
    frames, ``ENCDEC_PROMPT`` + ``ENCDEC_NEW`` tokens (its own cache: the
    encoder once more), every generated token held to the plain path
    teacher-forced on them; (c) the step at pos 447 and one at
    ``ENCDEC_CLAMP_POS`` (past the 448 position rows: the last one read),
    that one held to the plain path's same step.  Then (d) decode against
    the forward in fp32 on the plain path; (e) the step at pos 447 timed,
    profiled and counted; (f) the decode FFN products per launch.  Returns
    the launches by variant, the summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.models import attention, encdec
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    V, NL, NE, d, f = (cfg.vocab_size, cfg.n_layers, cfg.encoder_layers,
                       cfg.d_model, cfg.d_ff)
    H, K, dh, L = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.max_seq_len
    dcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    f32 = plain.replace(compute_dtype=torch.float32)
    B, T, per_step, pos = ENCDEC_B, frames.shape[1], 2 * NL, L - 1
    n_params = count_params(params)
    mm, flash = bm.blocked_matmul, fa.flash_attention_bhsd
    toks = torch.from_numpy(rng.integers(0, V, (B, ENCDEC_TF))).to(dev)
    last = torch.from_numpy(rng.integers(0, V, (B, 1))).to(dev)
    say(f"{cfg.name} decode: B={B}, frames ({B}, {T}), cache {L}; "
        f"{ENCDEC_TF} teacher-forced steps, greedy {ENCDEC_PROMPT} + "
        f"{ENCDEC_NEW}, the step at pos {pos} and at {ENCDEC_CLAMP_POS}")
    want = encdec.forward(params, toks, frames, plain)[0]
    exact = encdec.forward(params, toks, frames, f32)[0]

    def clamp_cache(c, dtype_cfg):
        """A zeroed self cache of ``ENCDEC_CLAMP_POS + 1`` rows beside
        ``c``'s cross K/V."""
        return {"self": attention.init_kv_cache(dtype_cfg, B,
                                                ENCDEC_CLAMP_POS + 1,
                                                device=dev),
                "cross_k": c["cross_k"], "cross_v": c["cross_v"]}

    # ---- the main path: (a), (b), (c) -----------------------------------------
    reset_counts()
    log = []
    with launches_recorded(log):
        cache = encdec.init_encdec_cache(params, frames, B, L, dcfg)
        steps_seen, rows_k = set(), []
        for t in range(ENCDEC_TF):
            m0, f0 = mm.launches, flash.launches
            lg, out = encdec.decode_step(params, toks[:, t:t + 1], cache, t,
                                         dcfg)
            steps_seen.add((mm.launches - m0, flash.launches - f0))
            check(out is cache and lg.shape == (B, 1, V)
                  and torch.isfinite(lg).all().item(),
                  f"encdec decode step {t}: logits malformed or the cache "
                  f"replaced")
            rows_k.append(lg[:, 0])
        REGISTRY.reset()
        prompt = toks[:, :ENCDEC_PROMPT]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_k = engine.greedy_generate(params, dcfg, prompt,
                                       steps=ENCDEC_NEW, max_len=L,
                                       frames=frames)
        gen_s = time.perf_counter() - t0
        hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
        step_lg = encdec.decode_step(params, last, cache, pos, dcfg)[0]
        kc = clamp_cache(cache, dcfg)
        clamp_lg = encdec.decode_step(params, last, kc, ENCDEC_CLAMP_POS,
                                      dcfg)[0]
    torch.cuda.synchronize()
    n_steps = ENCDEC_TF + ENCDEC_PROMPT + ENCDEC_NEW - 1 + 2
    launched = dict(mm.launches_by_variant)
    flashed = dict(flash.launches_by_variant)
    tally = launch_tally(log)
    say(f"(blocked_matmul, flash) launches per teacher-forced step "
        f"{sorted(steps_seen)}; main path ({n_steps} steps, 2 caches): "
        f"{tally}")
    check(steps_seen == {(per_step, 0)},
          f"expected {per_step} blocked-matmul launches and no flash launch "
          f"a step, got {steps_seen}")
    check(tally == {("flash", B, H, K, T, dh, False, "sm90"): 2 * NE,
                    ("mm", B * T, d, f, "gelu", True, "sm90"): 2 * NE,
                    ("mm", B * T, f, d, None, True, "sm90"): 2 * NE,
                    ("mm", B, d, f, "gelu", True, "sm90"): NL * n_steps,
                    ("mm", B, f, d, None, True, "sm90"): NL * n_steps},
          f"the encdec decode path's launches: {tally}")
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "sm90": 4 * NE + per_step * n_steps}
          and flashed == {**dict.fromkeys(fa.VARIANTS, 0), "sm90": 2 * NE},
          f"the counters disagree with the launches: {launched}, {flashed}")
    check(torch.isfinite(step_lg).all().item()
          and torch.isfinite(clamp_lg).all().item(),
          "the steps at pos 447 and past the position table gave non-finite "
          "logits")
    got = torch.stack(rows_k, dim=1)
    recurrent_rule(say, f"  (a) {ENCDEC_TF} teacher-forced steps, kernel "
                   f"path vs the plain forward's rows", got, want, exact)
    tf_abs = max_abs(got, want)
    del got, rows_k, want
    cp = encdec.init_encdec_cache(params, frames, B, L, plain)
    hold_generation(say, gen_k, prompt, ENCDEC_NEW, lambda t, tok:
                    encdec.decode_step(params, tok, cp, t, plain)[0],
                    tf_abs, gen_s, hist)
    c32 = encdec.init_encdec_cache(params, frames, B, 1, f32)
    recurrent_rule(
        say, f"  (c) the step at pos {ENCDEC_CLAMP_POS} (the learned row "
        f"clamped to {L - 1}), kernel path vs plain path", clamp_lg,
        encdec.decode_step(params, last, clamp_cache(cp, plain),
                           ENCDEC_CLAMP_POS, plain)[0],
        encdec.decode_step(params, last, clamp_cache(c32, f32),
                           ENCDEC_CLAMP_POS, f32)[0])
    del cp, kc

    # (d) decode against the forward in fp32 on the plain path
    c32 = encdec.init_encdec_cache(params, frames, B, ENCDEC_TF, f32)
    d_rel = max(row_rel_err(encdec.decode_step(
        params, toks[:, t:t + 1], c32, t, f32)[0][:, 0], exact[:, t])
        for t in range(ENCDEC_TF))
    say(f"  (d) fp32 plain path: {ENCDEC_TF} teacher-forced steps against "
        f"the forward's rows: row_rel_err {d_rel:.3e} (tol "
        f"{DECODE_TOL[torch.float32]:g})")
    check(d_rel < DECODE_TOL[torch.float32],
          f"encdec decode disagrees with the forward in fp32: {d_rel}")
    del c32, exact

    # (e) the step at pos 447
    c_bytes = float(sum(t.numel() * t.element_size() for t in (
        cache["self"]["k"], cache["self"]["v"], cache["cross_k"],
        cache["cross_v"])))
    least = 4.0 * n_params + c_bytes + 2.0 * B * V
    host, flops, nbytes = step_report(
        say, f"whisper_decode_b{B}",
        lambda: encdec.decode_step(params, last, cache, pos, dcfg),
        lambda: encdec.decode_step(params, last, cache, pos, plain),
        lambda: counters.count(encdec.decode_step, params, last, cache, pos,
                               plain), dev, least, per_step,
        weight_casts(params, skip=(params["dec_pos"],)))
    say(f"  (e) {B / host.median:.1f} tokens/s at B={B}; the cache "
        f"{c_bytes:.6g} bytes (self and cross K/V)")

    # (f) the decode FFN products per launch, each layer's in turn; the
    # encoder's launches in the two caches at the prefill's rows
    blocks = params["dec_blocks"]
    x_in = torch.randn((B, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((B, f), generator=gen, device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "encdec_decode", x_in,
                    bf16_copies(blocks, ("ffn", "w_up")), "gelu",
                    NL * n_steps, H100_SXM,
                    bf16_copies(blocks, ("ffn", "b_up"))),
            ffn_row(say, "encdec_decode", x_mid,
                    bf16_copies(blocks, ("ffn", "w_down")), None,
                    NL * n_steps, H100_SXM,
                    bf16_copies(blocks, ("ffn", "b_down")))]
    enc_again = [dict(r, path="encdec_decode (init_encdec_cache)",
                      launches=2 * NE) for r in encoder_rows]
    del cache
    point = {
        "arch": cfg.name, "shape": f"decode_b{B}_s{L}", "mesh": "1",
        "kind": "decode", "variant": "use_kernel_matmul", "flops": flops,
        "mem_bytes": nbytes, "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
        "params": float(n_params), "tokens": float(B),
        "seconds": host.median, "main": True,
        "source": "chip_smoke encdec_decode host median",
        "notes": "one step at pos 447 against 1500 frames' cross K/V; F and "
                 "B_M counted on the plain path"}
    return {"blocked_matmul": launched, "flash": flashed,
            "mm_rows": rows + enc_again[1:], "flash_rows": enc_again[:1],
            "point": point}


@torch.no_grad()
def vlm_prefill(dev, say, params, cfg, tokens: torch.Tensor,
                patches: torch.Tensor, gen: torch.Generator) -> dict:
    """The internvl2-26b prefill, full width at ``VLM_LAYERS`` layers, bf16,
    with ``use_flash`` (dh 128, GQA 6) and ``use_kernel_matmul``: (a) the
    main path, one forward of the visual prefix and ``tokens``, its counts
    set to 0 before and read after and each launch recorded; (b) its
    logits held to the plain path's by ``recurrent_rule``, and at a depth
    cut to ``VLM_F32_LAYERS`` the fp32 kernel path (the f32 kernels) to the
    fp32 plain path within ``DECODE_TOL``; (c) the forward timed, profiled
    and counted against the bound, the weight casts alone; (d) both
    kernels per launch at the forward's shapes.  Returns the launches by
    variant, the summary rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.measure.timers import kernel_ms
    from repro_torch.models import vlm
    from repro_torch.models.common import count_params

    kcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    f32 = plain.replace(compute_dtype=torch.float32)
    (B, S), Nv, Dv = tokens.shape, patches.shape[1], patches.shape[2]
    T, M = Nv + S, B * (Nv + S)
    V, NL, d, f = cfg.vocab_size, cfg.n_layers, cfg.d_model, cfg.d_ff
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    n_params = count_params(params)
    say(f"{cfg.name} prefill ({B}, {Nv} visual + {S} text = {T}): {NL} "
        f"layers, GQA {H}/{K} (group {H // K}) at dh {dh}; use_flash and "
        f"use_kernel_matmul on")

    # (a) the main path
    reset_counts()
    log = []
    with launches_recorded(log):
        logits, aux = vlm.forward(params, tokens, patches, kcfg)
    torch.cuda.synchronize()
    mm_made = dict(bm.blocked_matmul.launches_by_variant)
    fa_made = dict(fa.flash_attention_bhsd.launches_by_variant)
    say(f"(a) main path, one forward: {launch_tally(log)}")
    check(launch_tally(log) == {
        ("flash", B, H, K, T, dh, True, "sm90"): NL,
        ("mm", M, d, f, "silu", False, "sm90"): NL,
        ("mm", M, d, f, None, False, "sm90"): NL,
        ("mm", M, f, d, None, False, "sm90"): NL},
          f"the vlm prefill's launches: {launch_tally(log)}")
    check(mm_made == {**dict.fromkeys(bm.VARIANTS, 0), "sm90": 3 * NL}
          and fa_made == {**dict.fromkeys(fa.VARIANTS, 0), "sm90": NL},
          f"the counters disagree with the launches: {mm_made}, {fa_made}")
    check(logits.shape == (B, T, V) and torch.isfinite(logits).all().item()
          and float(aux) == 0.0, "vlm prefill logits malformed")

    # (b) against the plain path; fp32 at a depth cut
    want = vlm.forward(params, tokens, patches, plain)[0]
    exact = vlm.forward(params, tokens, patches, f32)[0]
    recurrent_rule(say, "(b) logits over the joined sequence, kernel path "
                   "vs plain path", logits, want, exact)
    del logits, want, exact
    cut = dict(params, lm=dict(params["lm"], blocks=params["lm"]["blocks"]
                               [:VLM_F32_LAYERS]))
    c32 = f32.replace(n_layers=VLM_F32_LAYERS)
    k32 = vlm.forward(cut, tokens, patches,
                      c32.replace(use_flash=True, use_kernel_matmul=True))[0]
    e32 = row_rel_err(k32, vlm.forward(cut, tokens, patches, c32)[0])
    say(f"(b) fp32 at a depth cut to {VLM_F32_LAYERS} layers (full width): "
        f"the kernel path (the f32 kernels) vs the plain path, row_rel_err "
        f"{e32:.3e} (tol {DECODE_TOL[torch.float32]:g})")
    check(e32 < DECODE_TOL[torch.float32],
          f"the fp32 vlm kernel path disagrees: {e32}")
    del k32

    # (c) timed, profiled, counted
    least = 4.0 * n_params + 4.0 * B * Nv * Dv + 2.0 * B * T * V + 8.0 * B * S
    host, flops, peak = prefill_report(
        say, f"internvl2_prefill_b{B}_s{T}",
        lambda: vlm.forward(params, tokens, patches, kcfg), dev,
        lambda: vlm.forward(params, tokens, patches, plain),
        lambda: counters.count(vlm.forward, params, tokens, patches, plain),
        least, 5)
    casts, cast_bytes = weight_casts(params["lm"])
    cast_ms = kernel_ms(casts, iters=1, warmup=1)
    say(f"(c) {B * T / host.median:.0f} tokens/s; the weight casts alone "
        f"{cast_ms:.4f} ms for {cast_bytes:.6g} bytes "
        f"({cast_bytes / cast_ms / 1e9:.3f} TB/s)")

    # (d) per launch at the forward's shapes, three layers' weights in turn
    flash_rows = [flash_row(say, "vlm_prefill", fa._launcher(), gen, B, T, H,
                            K, dh, NL)]
    blocks = params["lm"]["blocks"][:3]
    x_in = torch.randn((M, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((M, f), generator=gen, device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "vlm_prefill", a_, bf16_copies(blocks, ("ffn", w)),
                    act, NL, H100_SXM)
            for a_, w, act in ((x_in, "w_gate", "silu"), (x_in, "w_up", None),
                               (x_mid, "w_down", None))]
    point = {
        "arch": cfg.name, "shape": f"prefill_b{B}_s{T}_l{NL}", "mesh": "1",
        "kind": "prefill", "variant": "use_flash+use_kernel_matmul",
        "flops": flops, "mem_bytes": least, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(peak), "params": float(n_params),
        "tokens": float(B * T), "seconds": host.median, "main": True,
        "source": "chip_smoke vlm_prefill host median",
        "notes": f"depth cut to {NL} layers; F counted on the plain path; "
                 f"least bytes: params once, patches read, logits written"}
    return {"blocked_matmul": mm_made, "flash": fa_made, "mm_rows": rows,
            "flash_rows": flash_rows, "point": point}


@torch.no_grad()
def vlm_decode(dev, say, params, cfg, rng: np.random.Generator,
               gen: torch.Generator) -> dict:
    """The internvl2-26b serving path at ``VLM_LAYERS`` layers, B =
    ``VLM_B`` against a cache of ``VLM_MAX``, bf16, the FFN products in the
    blocked matmul (``use_flash`` on and unused: decode never takes it).
    Decode is text only from pos 0, as in the reference (the visual prefix
    is never in the cache).  The main path, its counts set to 0 before (a)
    and read after (c): (a) ``VLM_TF`` teacher-forced steps, held to the
    plain LM forward's rows by ``recurrent_rule``; (b) greedy generation of
    ``VLM_PROMPT`` + ``VLM_NEW`` tokens, held to the plain path teacher-
    forced on them; (c) one step at pos ``VLM_MAX - 1`` on a cache of seeded
    random content.  Then (d) that step timed, profiled and counted; (e) the
    FFN products per launch.  Returns the launches by variant, the summary
    rows and the Ridgeline point."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.measure import counters
    from repro_torch.models import transformer, vlm
    from repro_torch.models.common import count_params
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.serve import engine

    V, NL, d, f = cfg.vocab_size, cfg.n_layers, cfg.d_model, cfg.d_ff
    dcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    plain = cfg.replace(use_flash=False, use_kernel_matmul=False)
    f32 = plain.replace(compute_dtype=torch.float32)
    B, per_step, pos = VLM_B, 3 * NL, VLM_MAX - 1
    n_params = count_params(params)
    mm, flash = bm.blocked_matmul, fa.flash_attention_bhsd
    toks = torch.from_numpy(rng.integers(0, V, (B, VLM_TF))).to(dev)
    last = torch.from_numpy(rng.integers(0, V, (B, 1))).to(dev)
    say(f"{cfg.name} decode ({NL} layers): B={B}, cache {VLM_MAX}; {VLM_TF} "
        f"teacher-forced steps, greedy {VLM_PROMPT} + {VLM_NEW}, the step at "
        f"pos {pos}")
    want = transformer.forward(params["lm"], toks, plain)[0]
    exact = transformer.forward(params["lm"], toks, f32)[0]
    warm = vlm.init_cache(dcfg, B, VLM_MAX, device=dev)
    for t in warm.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))

    # ---- the main path: (a), (b), (c) -----------------------------------------
    reset_counts()
    cache = vlm.init_cache(dcfg, B, VLM_MAX, device=dev)
    steps_seen, rows_k = set(), []
    for t in range(VLM_TF):
        m0, f0 = mm.launches, flash.launches
        lg, out = vlm.decode_step(params, toks[:, t:t + 1], cache, t, dcfg)
        steps_seen.add((mm.launches - m0, flash.launches - f0))
        check(out is cache and lg.shape == (B, 1, V)
              and torch.isfinite(lg).all().item(),
              f"vlm decode step {t}: logits malformed or the cache replaced")
        rows_k.append(lg[:, 0])
    del cache
    REGISTRY.reset()
    prompt = toks[:, :VLM_PROMPT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_k = engine.greedy_generate(params, dcfg, prompt, steps=VLM_NEW,
                                   max_len=VLM_MAX)
    gen_s = time.perf_counter() - t0
    hist = REGISTRY.snapshot()["histograms"]["serve.step_seconds"]
    step_lg = vlm.decode_step(params, last, warm, pos, dcfg)[0]
    torch.cuda.synchronize()
    n_steps = VLM_TF + VLM_PROMPT + VLM_NEW - 1 + 1
    launched = dict(mm.launches_by_variant)
    say(f"(blocked_matmul, flash) launches per teacher-forced step "
        f"{sorted(steps_seen)}; main path ({n_steps} steps): blocked_matmul "
        f"by variant {launched}, flash {flash.launches}")
    check(steps_seen == {(per_step, 0)},
          f"expected {per_step} blocked-matmul launches and no flash launch "
          f"a step, got {steps_seen}")
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "sm90": per_step * n_steps} and flash.launches == 0,
          f"every vlm decode launch must take the sm90 kernel and none the "
          f"flash kernel: {launched}, flash {flash.launches}")
    check(torch.isfinite(step_lg).all().item(),
          "the step on the full cache gave non-finite logits")
    got = torch.stack(rows_k, dim=1)
    recurrent_rule(say, f"  (a) {VLM_TF} teacher-forced steps, kernel path "
                   f"vs the plain LM forward's rows", got, want, exact)
    tf_abs = max_abs(got, want)
    del got, want, exact, rows_k
    cp = vlm.init_cache(plain, B, VLM_MAX, device=dev)
    hold_generation(say, gen_k, prompt, VLM_NEW, lambda t, tok:
                    vlm.decode_step(params, tok, cp, t, plain)[0],
                    tf_abs, gen_s, hist)
    del cp

    # (d) the step at pos VLM_MAX - 1 on the full cache
    c_bytes = 2.0 * warm["k"].numel() * warm["k"].element_size()
    least = 4.0 * count_params(params["lm"]) + c_bytes + 2.0 * B * V
    host, flops, nbytes = step_report(
        say, f"internvl2_decode_b{B}",
        lambda: vlm.decode_step(params, last, warm, pos, dcfg),
        lambda: vlm.decode_step(params, last, warm, pos, plain),
        lambda: counters.count(vlm.decode_step, params, last, warm, pos,
                               plain), dev, least, per_step,
        weight_casts(params["lm"]))
    say(f"  (d) {B / host.median:.1f} tokens/s at B={B}; the KV cache "
        f"{c_bytes:.6g} bytes")
    del warm

    # (e) the FFN products per launch, three layers' weights in turn
    blocks = params["lm"]["blocks"][:3]
    x_in = torch.randn((B, d), generator=gen, device=dev).to(torch.bfloat16)
    x_mid = torch.randn((B, f), generator=gen, device=dev).to(torch.bfloat16)
    rows = [ffn_row(say, "vlm_decode", a_, bf16_copies(blocks, ("ffn", w)),
                    act, NL * n_steps, H100_SXM)
            for a_, w, act in ((x_in, "w_gate", "silu"), (x_in, "w_up", None),
                               (x_mid, "w_down", None))]
    point = {
        "arch": cfg.name, "shape": f"decode_b{B}_s{VLM_MAX}_l{NL}",
        "mesh": "1", "kind": "decode", "variant": "use_kernel_matmul",
        "flops": flops, "mem_bytes": nbytes, "wire_bytes": 0.0,
        "by_kind": {}, "peak": 0.0, "params": float(n_params),
        "tokens": float(B), "seconds": host.median, "main": True,
        "source": "chip_smoke vlm_decode host median",
        "notes": f"depth cut to {NL} layers; one step at pos {pos}; F and "
                 f"B_M counted on the plain path"}
    return {"blocked_matmul": launched, "mm_rows": rows, "point": point}


def encdec_vlm_paths(dev, say, gen: torch.Generator) -> dict:
    """whisper-tiny at full width and depth, then internvl2-26b at full
    width and ``VLM_LAYERS`` layers, on the card, each model's weights drawn
    there from a seeded ``torch.Generator`` with their vector leaves moved
    off their init: the ``encdec_prefill``, ``encdec_decode``,
    ``vlm_prefill`` and ``vlm_decode`` phases; each model's weights are
    dropped and the allocator's cache emptied after its phases."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, vlm
    from repro_torch.models.common import count_params

    out = {}
    phase("encdec_prefill")
    t_phase = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    params = encdec.init_encdec(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    jitter_vectors(params, gen)
    say(f"{cfg.name}: {cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.dh}, d_ff {cfg.d_ff} ({cfg.ffn_activation}, biased), vocab "
        f"{cfg.vocab_size} tied, {cfg.encoder_seq} frames, "
        f"{cfg.max_seq_len} positions; {count_params(params)} fp32 params "
        f"drawn on the card from seed 0")
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.standard_normal(
        (ENCDEC_B, cfg.encoder_seq, cfg.d_model), np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ENCDEC_B, cfg.max_seq_len))).to(dev)
    out["encdec_prefill"] = encdec_prefill(dev, say, params, cfg, frames,
                                           tokens, gen)
    say(f"encdec_prefill took {time.perf_counter() - t_phase:.1f} s")
    phase("encdec_decode")
    t_phase = time.perf_counter()
    out["encdec_decode"] = encdec_decode(
        dev, say, params, cfg, frames, rng, gen,
        out["encdec_prefill"]["encoder_rows"])
    say(f"encdec_decode took {time.perf_counter() - t_phase:.1f} s")
    del params, frames, tokens
    torch.cuda.empty_cache()

    phase("vlm_prefill")
    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params = vlm.init_vlm(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    jitter_vectors(params, gen)
    torch.cuda.synchronize()
    say(f"{cfg.name}: {cfg.n_layers} of its 48 layers (the depth cut: 48 "
        f"are 79.7 GB in fp32), d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} untied, {cfg.visual_tokens} visual tokens of "
        f"width {cfg.visual_width}; {count_params(params)} fp32 params drawn "
        f"on the card from seed 0 in {time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    rng = np.random.default_rng(13)
    B, S = VLM_PREFILL
    patches = torch.randn((B, cfg.visual_tokens, cfg.visual_width),
                          generator=gen, device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    out["vlm_prefill"] = vlm_prefill(dev, say, params, cfg, tokens, patches,
                                     gen)
    say(f"vlm_prefill took {time.perf_counter() - t_phase:.1f} s")
    phase("vlm_decode")
    t_phase = time.perf_counter()
    out["vlm_decode"] = vlm_decode(dev, say, params, cfg, rng, gen)
    say(f"vlm_decode took {time.perf_counter() - t_phase:.1f} s")
    del params, patches, tokens
    torch.cuda.empty_cache()
    return out


def f32_row(dev, say, s: int, launches: int, path: str) -> dict:
    """The f32 kernel at ``s``^3 per launch (``f32_plan``'s tile) beside its
    earlier design f32_edge (called past the wrapper), the plain version and
    the library's one call, each checked against the plain version: one row
    of the summary line, ``launches`` the main path's launches at ``s``."""
    from repro_torch.core.hardware import H100_SXM_FP32
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.ref import ref_matmul
    from repro_torch.measure.timers import kernel_ms

    fns = bm._launcher()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(s)
    a_ = torch.randn((s, s), generator=gen, device=dev)
    b_ = torch.randn((s, s), generator=gen, device=dev)
    k_ms = kernel_ms(lambda i: blocked_matmul(a_, b_), iters=20)
    e_ms = kernel_ms(lambda i: edge_option(fns.base, a_, b_), iters=20)
    p_ms = kernel_ms(lambda i: ref_matmul(a_, b_), iters=20)
    lib_ms = kernel_ms(lambda i: torch.mm(a_, b_), iters=20)
    got, want = blocked_matmul(a_, b_), ref_matmul(a_, b_)
    err_abs, err = max_abs(got, want), rel_err(got, want)
    check(err < TOL[torch.float32],
          f"f32 blocked matmul disagrees at {s}^3: {err}")
    e_err = rel_err(edge_option(fns.base, a_, b_), want)
    check(e_err < TOL[torch.float32],
          f"f32_edge blocked matmul disagrees at {s}^3: {e_err}")
    tile = bm.f32_plan(s, s, s, n_sms)
    flops, nbytes = 2.0 * s ** 3, 3.0 * 4 * s * s
    b_ms, b_by = bound_of(flops, nbytes, H100_SXM_FP32)
    say(f"  blocked_matmul f32 {s}^3 per launch: kernel ({tile.bm}x"
        f"{tile.bn}) {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), "
        f"earlier design f32_edge {e_ms:.4f} ms ({e_ms / k_ms:.2f}x the "
        f"kernel), plain {p_ms:.4f} ms, library torch.mm fp32 (TF32 off) "
        f"{lib_ms:.4f} ms ({k_ms / lib_ms:.2f}x); bound {b_ms:.4f} ms "
        f"({b_by}, h100_sxm_fp32), kernel at {100 * b_ms / k_ms:.1f}% of "
        f"bound (f32_edge {100 * b_ms / e_ms:.1f}%); {launches} {path} "
        f"launches; rel_err {err:.3e} (f32_edge {e_err:.3e})")
    return {"path": path, "shape": [s, s, s], "dtype": "f32", "act": None,
            "tile": [tile.bm, tile.bn], "launches": launches,
            "kernel_ms": k_ms, "earlier_ms": e_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err_abs, "flops": flops, "bytes": nbytes}


def calibrate(dev, say, card: str, placed: list, cfg) -> tuple:
    """The calibration path: ``default_suite(smoke=True)`` and the fp32
    GEMMs at ``CAL_BIG``, all through the blocked matmul's f32 kernel,
    fitted against ``h100_sxm_fp32`` into a registry entry in a temporary
    directory; then the train steps of ``placed`` on both planes.  Returns
    the blocked matmul's launches by variant in the suite (read before the
    per-launch timing below) and the f32 kernel's summary rows, each size's
    launches counted from the suite's calls, with the earlier design's
    time beside the kernel's, and the calibration."""
    W, L = cfg.mlp_widths[0], len(cfg.mlp_widths)

    from repro_torch.core.hardware import (H100_SXM, H100_SXM_FP32,
                                           get_hardware)
    from repro_torch.core.ridgeline import WorkUnit, analyze
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.measure import calibrate as cal
    from repro_torch.models.mlp_dlrm import analytic_work_unit
    from repro_torch.measure import microbench

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

    # per launch at each size: the kernel (f32_plan's tile), its earlier
    # design f32_edge (the first fp32 kernel, called past the wrapper), the
    # plain version and the library's one call
    rows = [f32_row(dev, say, s, calls[s], "calibrate")
            for s in microbench.SMOKE_MATMUL_SIZES + CAL_BIG]
    return launched, rows, calib


def calibrate_cli(dev, say, tmp: str, phase_calib) -> tuple:
    """The calibrate entry point at its full sizes on the card, traced:
    ``repro_torch.measure.calibrate.main(["--out", <tmp>/calibration_torch,
    "--figures", <tmp>/figures_torch])``, then its entry, cells, figures and
    trace checked.  Every calibration GEMM must take one f32 launch; the
    launches are counted from the trace's ``bench.matmul_*`` spans (a probe,
    2 warmups and the timed repeats each).  Returns the launches by
    variant, the f32 kernel's rows at the CLI's sizes, the fitted spec and
    the entry's measurements."""
    import xml.etree.ElementTree as ET

    from repro_torch.core.hardware import H100_SXM_FP32, get_hardware
    from repro_torch.core.report import load_reports
    from repro_torch.kernels import blocked_matmul as bm
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.measure import calibrate as cal
    from repro_torch.measure.microbench import Measurement
    from repro_torch.obs import trace

    reg = os.path.join(tmp, "calibration_torch")
    figs = os.path.join(tmp, "figures_torch")
    tpath = os.path.join(tmp, "calibrate_trace.json")
    tracer = trace.enable(tpath)
    t0 = time.perf_counter()
    try:
        rc = cal.main(["--out", reg, "--figures", figs])
    finally:
        wall = time.perf_counter() - t0
        trace.disable()
    tracer.write()
    check(rc == 0, f"the calibrate CLI returned {rc}")
    launched = dict(blocked_matmul.launches_by_variant)

    # the entry loads back, and refitting its measurements gives its spec
    entry = cal.load_calibration_dict(H100_SXM_FP32.name + "_cal", reg)
    fit = [Measurement.from_dict(d) for d in entry["measurements"]]
    val = [Measurement.from_dict(d) for d in entry["validation_measurements"]]
    calib = cal.fit_ceilings(fit, H100_SXM_FP32, validation=val)
    spec = get_hardware(H100_SXM_FP32.name, calibrated=True,
                        registry_dir=reg)
    check(spec == calib.spec(), "the CLI's entry does not load back")

    # the trace: valid, a bench span for every measurement, the fit's spans
    summary = trace.validate_chrome_trace(tpath)
    with open(tpath) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    want = {"calibrate.suite", "calibrate.fit", "calibrate.fit.compute",
            "calibrate.fit.memory", "calibrate.fit.efficiency"}
    want |= {f"bench.{m.work.name}" for m in fit + val}
    check(want <= names, f"trace lacks spans {sorted(want - names)}")
    check(not summary["counters"].get("bench.retries"),
          f"the CLI retried a bench: {summary['counters']}")
    dur = {n: sum(e["dur"] for e in spans if e["name"] == n) / 1e3
           for n in ("calibrate.suite", "calibrate.fit")}

    # one f32 launch per GEMM call: probe + 2 warmups + repeats, per pass
    calls = {}
    for e in spans:
        if e["name"].startswith("bench.matmul_"):
            s = int(e["name"].split("_")[1].split("x")[0])
            a = e["args"]
            calls[s] = calls.get(s, 0) + 3 + a.get("repeats_clamped",
                                                   a["repeats"])
    check(launched == {**dict.fromkeys(bm.VARIANTS, 0),
                       "f32": sum(calls.values())}
          and flash_attention_bhsd.launches == 0,
          f"the CLI's GEMMs must each launch the f32 kernel once: {launched}"
          f" for {calls}")

    # one measured cell per validation step, its error the calibration's
    cells = {c.shape: c for c in load_reports(os.path.join(reg, "cells"))}
    check(sorted(cells) == sorted(m.work.name for m in val),
          f"cells {sorted(cells)} for steps {[m.work.name for m in val]}")
    for m in val:
        check(cells[m.work.name].measured_rel_error == calib.rel_error(m),
              f"cell {m.work.name}: rel error differs from the calibration's")

    # the figures: the SVG parses; a marker and a legend line for every
    # measurement the plane can place (finite x = B_M / B_N: on one card no
    # bench has wire bytes, so every point sits at x = inf, off the plane)
    base = os.path.join(figs, f"calibration_{calib.name}")
    with open(base + ".svg") as f:
        svg = f.read()
    root = ET.fromstring(svg)
    ns = "{http://www.w3.org/2000/svg}"
    marks = [c for c in root.iter(ns + "circle")
             if c.get("class") == "measured"]
    with open(base + ".txt") as f:
        txt = f.read()
    legend = [ln for ln in txt.splitlines() if ln.startswith("  [")]
    placeable = [m for m in fit + val if m.work.net_bytes > 0]
    check(len(marks) == len(legend) == len(placeable),
          f"{len(marks)} markers, {len(legend)} legend lines for "
          f"{len(placeable)} points on the plane")
    check(len(root.findall(ns + "rect")) == 1 + 64 * 48
          and len(root.findall(ns + "line")) == 2,
          "the SVG lacks the plane's regions or ridges")
    check(txt.endswith(calib.summary() + "\n"),
          "the ASCII figure lacks the calibration summary")

    say(f"calibrate CLI (full sizes, traced): rc {rc}, wall {wall:.2f} s; "
        f"spans: calibrate.suite {dur['calibrate.suite']:.1f} ms, "
        f"calibrate.fit {dur['calibrate.fit']:.3f} ms; "
        f"{summary['n_spans']} spans, depth {summary['max_depth']}")
    say(f"  fit: PEAK {calib.peak_flops / 1e12:.2f} TFLOP/s, HBM "
        f"{calib.hbm_bw / 1e12:.3f} TB/s (the calibrate phase's, with 4096^3: "
        f"PEAK {phase_calib.peak_flops / 1e12:.2f}, HBM "
        f"{phase_calib.hbm_bw / 1e12:.3f}); validation "
        + ", ".join(f"{n} {100 * e:+.1f}%"
                    for n, e in calib.errors("validation").items()))
    say(f"  wrote {sorted(os.listdir(reg))} + cells {sorted(cells)}; figures "
        f"{sorted(os.listdir(figs))}: {len(placeable)} of "
        f"{len(fit) + len(val)} measurements on the plane, the rest at "
        f"x = inf (no wire bytes on one card)")
    say(f"  f32 launches by GEMM size: {dict(sorted(calls.items()))}")
    rows = [f32_row(dev, say, s, n, "calibrate_cli")
            for s, n in sorted(calls.items())]
    return launched, rows, calib, fit + val


def ridgeline(say, tmp: str, points: list, fitted) -> None:
    """Every measured point of the earlier phases as a ``CellReport`` on
    ``h100_sxm`` and on the CLI's fitted spec, its host median attached.
    At each point the paper's quadrant construction must classify as the
    argmax of the times does on the spec's bandwidth-only plane (α = 0,
    eff = 1: the theorem's premise; the datasheet spec is its own plane).
    With the fitted α and eff(F) the times are the physical definition: the
    points where they disagree with the plane are printed, not failed."""
    import dataclasses
    import xml.etree.ElementTree as ET

    from repro_torch.core.hardware import H100_SXM, EfficiencyModel
    from repro_torch.core.report import (StepCosts, make_cell_report,
                                         roofline_table)
    from repro_torch.core.ridgeline import (WorkUnit, ascii_plot,
                                            classify_by_quadrant,
                                            classify_by_times, svg_plot)
    from repro_torch.measure.overlay import attach_measurement, measured_table

    for spec in (H100_SXM, fitted):
        plane = dataclasses.replace(
            spec, alpha_compute=0.0, alpha_memory=0.0, alpha_network=0.0,
            link_alphas={}, compute_eff=EfficiencyModel())
        reports, off = [], []
        for p in points:
            costs = StepCosts(flops=p["flops"], mem_bytes=p["mem_bytes"],
                              wire_bytes=p["wire_bytes"],
                              wire_bytes_by_kind=p["by_kind"],
                              peak_memory_per_device=p["peak"], num_devices=1)
            rep = make_cell_report(
                arch=p["arch"], shape=p["shape"], mesh=p["mesh"],
                step_kind=p["kind"], costs=costs, hw=spec,
                model_flops=p["flops"], params_total=p["params"],
                params_active=p["params"], tokens_per_step=p["tokens"],
                variant=p["variant"], notes=p["notes"])
            attach_measurement(rep, p["seconds"], source=p["source"])
            check(math.isfinite(rep.measured_rel_error) and rep.runtime > 0,
                  f"{p['shape']} on {spec.name}: runtime {rep.runtime}")
            w = WorkUnit(p["shape"], p["flops"], p["mem_bytes"],
                         p["wire_bytes"])
            q, t = classify_by_quadrant(w, plane), classify_by_times(w, plane)
            check(q == t, f"{p['shape']} on {spec.name}'s plane: quadrant "
                          f"{q.value}, times {t.value}")
            if rep.bottleneck != q.value:
                off.append(f"{p['shape']} ({p['variant']}): plane {q.value}, "
                           f"times {rep.bottleneck}")
            reports.append(rep)
        say(f"{len(reports)} points on {spec.name}: classify_by_quadrant == "
            f"classify_by_times on its plane at every point; the alpha-aware "
            f"times disagree with the plane at {len(off)}"
            + (": " + "; ".join(off) if off else ""))
        print(roofline_table(reports))
        print(measured_table(reports))
        main_paths = [r for r, p in zip(reports, points) if p["main"]]
        analyses = [r.analysis(spec) for r in main_paths]
        notes = {a.work.name: f"meas {r.measured_runtime * 1e3:.3f}ms "
                              f"({r.measured_rel_error:+.0%})"
                 for a, r in zip(analyses, main_paths)}
        print(ascii_plot(analyses, spec, point_notes=notes))
        on_plane = [a for a in analyses if 0 < a.x < math.inf]
        svg = svg_plot(analyses, spec, width=880, height=560,
                       point_notes=notes)
        path = os.path.join(tmp, f"ridgeline_{spec.name}.svg")
        with open(path, "w") as f:
            f.write(svg)
        marks = [c for c in ET.fromstring(svg).iter(
            "{http://www.w3.org/2000/svg}circle")]
        check(len(marks) == len(on_plane),
              f"{len(marks)} markers for {len(on_plane)} points on the plane")
        say(f"wrote {os.path.basename(path)}: {len(on_plane)} of "
            f"{len(analyses)} main-path points on the plane (the forwards "
            f"have no wire bytes: x = inf)")


def rss_bytes() -> int:
    """This process's resident set now (not its high-water mark)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def plan_phase(dev, say, reg: str, tmp: str, drawn: dict, steps: dict) -> None:
    """The analytic planner (``launch.specs``, ``launch.memory``,
    ``launch.plan_grid``, ``launch.plan``, ``obs.explain``) held to what the
    card did in the phases above.  (a) Parameter counts on fake tensors for
    every assigned config and dlrm-mlp at full width, each model the smoke
    drew on the card (``drawn``: label -> (config, the drawn params'
    numel)) counted exactly, with no device memory and the process's RSS
    read before and after.  (b) One card on the datasheet plane: each
    measured train step (``steps``) beside the planner's prediction and its
    three terms, smollm's working set beside ``train_cli``'s peak; what the
    card trained must fit, qwen3-moe's 122 GB of fp32 params must not.
    (c) The CLI on ``calibrate_cli``'s fitted plane (``reg``), traced: its
    JSON, its explain terms summing to each step, the band from the fitted
    ``model_rel_error``, a valid trace with every planner span; the best
    plans on both planes.  (d) ``plan_grid``'s throughput on this host.
    (e) The CLI in a process of its own opens no CUDA context.  The planner
    launches no kernel."""
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.core.hardware import H100_SXM, H100_SXM_FP32, \
        get_hardware
    from repro_torch.distributed.collectives import ALGORITHMS
    from repro_torch.launch import memory, specs
    from repro_torch.launch import plan as planner
    from repro_torch.obs import trace

    # (a) counts on fake tensors
    alloc0, rss0 = torch.cuda.memory_allocated(dev), rss_bytes()
    t0 = time.perf_counter()
    counts = {arch: (specs.param_counts(get_config(arch)),
                     specs.expert_param_counts(get_config(arch)))
              for arch in ASSIGNED + ("dlrm-mlp",)}
    counted = {label: specs.param_counts(cfg)[0]
               for label, (cfg, _) in drawn.items()}
    secs = time.perf_counter() - t0
    alloc1, rss1 = torch.cuda.memory_allocated(dev), rss_bytes()
    say(f"param_counts on fake tensors, {len(counts)} configs at full width "
        f"+ {len(drawn)} drawn: {secs:.2f} s on the host; RSS "
        f"{rss0 / 1e9:.3f} -> {rss1 / 1e9:.3f} GB; card allocated "
        f"{alloc0} -> {alloc1} bytes")
    for arch, ((total, active), (e_total, _)) in counts.items():
        say(f"  {arch}: {total:.0f} params ({4 * total / 1e9:.2f} GB in "
            f"fp32), {active:.0f} active a token"
            + (f", {e_total:.0f} in routed experts" if e_total else ""))
    check(alloc1 == alloc0, "counting allocated device memory")
    check(rss1 - rss0 < 2 ** 30, f"counting grew the RSS by "
          f"{(rss1 - rss0) / 1e9:.3f} GB")
    for label, (cfg, n) in drawn.items():
        say(f"  {label}: counted {counted[label]:.0f}, drawn on the card "
            f"{n:.0f}")
        check(counted[label] == n, f"{label}: counted {counted[label]}, "
              f"drawn {n}")

    # (b) one card, datasheet plane: prediction against measurement
    cap = H100_SXM.hbm_capacity_bytes
    one = [("dlrm-mlp", B, 1, s) for B, s in sorted(steps["dlrm-mlp"].items())]
    one.append(("smollm-135m", 8, 512, steps["smollm-135m"]["seconds"]))
    for arch, B, S, measured in one:
        (p,) = planner.plan(get_config(arch), H100_SXM, 1, batch=B, seq=S)
        say(f"  h100_sxm, one card, {arch} train B={B}"
            + (f" S={S}" if S > 1 else "") + f": predicted "
            f"{p.runtime * 1e3:.4f} ms, {p.bottleneck}-bound (t_comp "
            f"{p.t_compute * 1e3:.4f}, t_mem {p.t_memory * 1e3:.4f}, t_net "
            f"{p.t_network * 1e3:.4f} ms); measured host median "
            f"{measured * 1e3:.4f} ms = {measured / p.runtime:.2f}x the "
            f"prediction; working set {p.hbm_bytes / 1e9:.3f} GB, fits "
            f"{p.fits}")
        check(p.fits and p.hbm_bytes <= cap,
              f"{arch} B={B}: the card trained it, the planner prunes it")
    ws = memory.training_working_set(get_config("smollm-135m"), batch=8,
                                     seq=512)
    peak = steps["smollm-135m"]["peak"]
    say(f"  smollm-135m (8, 512) working set: params "
        f"{float(ws.params) / 1e9:.3f} + grads {float(ws.grads) / 1e9:.3f} + "
        f"AdamW {float(ws.opt) / 1e9:.3f} + activations "
        f"{float(ws.activations) / 1e9:.3f} = {float(ws.total) / 1e9:.3f} GB;"
        f" train_cli's measured peak {peak / 1e9:.3f} GB = "
        f"{peak / float(ws.total):.2f}x the model")
    check(float(ws.params + ws.grads + ws.opt) <= float(ws.total) <= peak,
          "the working set exceeds what the card held")
    q3 = get_config("qwen3-moe-30b-a3b")
    try:
        planner.plan(q3, H100_SXM, 1, batch=8, seq=512)
        why = "ranked"
    except ValueError as e:
        why = str(e)
    check("no candidate fits" in why,
          f"qwen3-moe training on one card was not pruned: {why}")
    (w,) = planner.plan(q3, H100_SXM, 1, batch=8, seq=512,
                        check_capacity=False)
    check(not w.fits and float(w.hbm_bytes) > cap, "qwen3-moe marked fit")
    say(f"  qwen3-moe-30b-a3b train (8, 512) on one card: pruned ({why}); "
        f"with the check off {w.hbm_bytes / 1e9:.1f} GB, fit {w.fits} "
        f"(params alone {4 * counts['qwen3-moe-30b-a3b'][0][0] / 1e9:.1f} "
        f"GB)")

    # (c) the CLI on the fitted plane, traced
    fitted = get_hardware(H100_SXM_FP32.name, calibrated=True,
                          registry_dir=reg)
    tpath = os.path.join(tmp, "plan_trace.json")
    old = os.environ.get("REPRO_TORCH_CALIBRATION_DIR")
    os.environ["REPRO_TORCH_CALIBRATION_DIR"] = reg
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = planner.main(PLAN_CLI + ["--trace", tpath])
    finally:
        wall = time.perf_counter() - t0
        trace.disable()
        if old is None:
            del os.environ["REPRO_TORCH_CALIBRATION_DIR"]
        else:
            os.environ["REPRO_TORCH_CALIBRATION_DIR"] = old
    check(rc == 0, f"the planner CLI returned {rc}")
    doc = json.loads(out.getvalue())
    e = fitted.model_rel_error
    check(doc["hardware"]["name"] == fitted.name
          and doc["hardware"]["source"] == "calibrated" and e > 0,
          f"the CLI did not plan on the fitted spec: {doc['hardware']}")
    for pt in doc["points"]:
        b = pt["best"]
        check(b["runtime_lo"] == max(b["runtime"] * (1.0 - e), 0.0)
              and b["runtime_hi"] == b["runtime"] * (1.0 + e),
              f"chips {pt['chips']}: the band is not the fitted error's")
    n_rec = 0
    for pt in doc["explain"]["points"]:
        for rec in pt["candidates"]:
            total = sum(rec["breakdown"].values())
            check(abs(total - rec["runtime"]) <= 1e-9 * rec["runtime"],
                  f"{rec['mesh']}: explain terms sum to {total}, the step "
                  f"is {rec['runtime']}")
            n_rec += 1
    summary = trace.validate_chrome_trace(tpath)
    with open(tpath) as f:
        names = {ev["name"] for ev in json.load(f)["traceEvents"]}
    check(PLAN_SPANS <= names, f"trace lacks {sorted(PLAN_SPANS - names)}")
    say(f"planner CLI ({' '.join(PLAN_CLI)}) on {fitted.name} (model_rel_"
        f"error {e:.4f}): rc {rc}, {wall:.3f} s; {doc['n_candidates']} "
        f"candidates, {n_rec} explained, every breakdown summing to its "
        f"step; trace valid ({summary['n_spans']} spans, depth "
        f"{summary['max_depth']})")
    dlrm = get_config("dlrm-mlp")
    chips = [pt["chips"] for pt in doc["points"]]
    for hw in (H100_SXM, H100_SXM_FP32, fitted):
        g = planner.plan_grid(dlrm, hw, chips, [512])
        say(f"  best plans, dlrm-mlp B=512, {hw.name}: " + "; ".join(
            f"{c} chips {b.mesh} {b.algo_label} {b.runtime * 1e3:.4f} ms "
            + (f"[{b.runtime_lo * 1e3:.4f}, {b.runtime_hi * 1e3:.4f}] "
               if b.runtime_hi > b.runtime else "") + b.bottleneck
            for c, b in ((c, g.best(c)) for c in chips)))
        if hw is fitted:
            check([g.best(c).runtime for c in chips]
                  == [pt["best"]["runtime"] for pt in doc["points"]],
                  "the CLI's best plans are not plan_grid's")
    for B, s in sorted(steps["dlrm-mlp"].items()):
        (p,) = planner.plan(dlrm, fitted, 1, batch=B)
        say(f"  {fitted.name}, one card, dlrm-mlp train B={B}: predicted "
            f"{p.runtime * 1e3:.4f} ms [{p.runtime_lo * 1e3:.4f}, "
            f"{p.runtime_hi * 1e3:.4f}] {p.bottleneck}-bound; measured "
            f"{s * 1e3:.4f} ms = {s / p.runtime:.2f}x")

    # (d) throughput of one large grid on this host
    cfg = get_config(PLAN_GRID_ARCH)
    kw = dict(seq=4096, algorithms=ALGORITHMS, max_pp=8,
              zero_stages=(0, 1, 2, 3))
    t0 = time.perf_counter()
    g = planner.plan_grid(cfg, H100_SXM, PLAN_GRID_CHIPS, PLAN_GRID_BATCHES,
                          **kw)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        planner.plan_grid(cfg, H100_SXM, PLAN_GRID_CHIPS, PLAN_GRID_BATCHES,
                          **kw)
        warm.append(time.perf_counter() - t0)
    n = g.n_candidates
    say(f"plan_grid throughput (host CPU, not the card): {PLAN_GRID_ARCH}, "
        f"chips {PLAN_GRID_CHIPS} x batch {PLAN_GRID_BATCHES}, max_pp 8, "
        f"ZeRO 0-3, {len(ALGORITHMS)} algorithms: {n} candidates of "
        f"{g.n_enumerated} enumerated ({int(g.n_pruned.sum())} cut by "
        f"capacity); first pass {cold:.4f} s = {n / cold:.0f} candidates/s, "
        f"warm (best of 3) {min(warm):.4f} s = {n / min(warm):.0f} "
        f"candidates/s")

    # (e) the planner in a process of its own opens no CUDA context
    code = ("import sys, torch; from repro_torch.launch import plan; "
            "rc = plan.main(sys.argv[1:]); "
            "sys.exit(rc or (3 if torch.cuda.is_initialized() else 0))")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code] + PLAN_ALONE,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(ROOT, "src")})
    check(r.returncode == 0, f"the planner alone exited {r.returncode} (3: "
          f"it opened a CUDA context): {r.stderr[-2000:]}")
    best = [ln for ln in r.stdout.splitlines() if ln.startswith("best:")]
    say(f"planner alone ({' '.join(PLAN_ALONE)}): rc 0, no CUDA context, "
        f"{time.perf_counter() - t0:.2f} s with the interpreter's start; "
        + "; ".join(best + [ln for ln in r.stdout.splitlines()
                            if ln.startswith("capacity:")]))


#: mesh_serve: the serve CLI's and greedy generation's batch, prompt and
#: new tokens (the prefill runs at PREFILL[0], as lm_prefill's does)
MESH_B, MESH_PROMPT, MESH_NEW = 8, 16, 16
#: mesh_train: the train CLI on the card's 1x1 mesh, checkpoints at 2 and 4
MESH_TRAIN = ["--arch", "smollm-135m", "--batch", "8", "--seq", "512",
              "--ckpt-every", "2", "--steps", "4", "--mesh", "1x1"]
#: dryrun: the cells lowered on the card's host (the paper's case study on
#: one card and on a pod, its serving forward on a pod, a dense train cell
#: on a pod, a decode cell, a two-pod train cell; a train cell of the moe,
#: hybrid and ssm families and a prefill cell of the enc-dec and VLM ones
#: on a pod; the MoE's train cell on one device too, for its F x N /
#: F(1x1), and on two pods; the xLSTM's train cell on one device too; the
#: MoE's decode cell, whose cache shards its heads and its sequence, and on
#: one device too, for its F x N / F(1x1); the enc-dec's prefill cell on one
#: device too) and the phase's budget in seconds
DRYRUN_CELLS = (("dlrm-mlp", "train_4k", "1x1"),
                ("qwen2-moe-a2.7b", "train_4k", "1x1"),
                ("xlstm-125m", "train_4k", "1x1"),
                ("dlrm-mlp", "train_4k", "16x16"),
                ("dlrm-mlp", "decode_32k", "16x16"),
                ("smollm-135m", "train_4k", "16x16"),
                ("qwen2-7b", "decode_32k", "16x16"),
                ("qwen2-7b", "train_4k", "2x16x16"),
                ("qwen2-moe-a2.7b", "train_4k", "16x16"),
                ("hymba-1.5b", "train_4k", "16x16"),
                ("xlstm-125m", "train_4k", "16x16"),
                ("whisper-tiny", "prefill_32k", "16x16"),
                ("internvl2-26b", "prefill_32k", "16x16"),
                ("hymba-1.5b", "decode_32k", "1x1"),
                ("qwen2-moe-a2.7b", "train_4k", "2x16x16"),
                ("qwen2-moe-a2.7b", "decode_32k", "16x16"),
                ("qwen2-moe-a2.7b", "decode_32k", "1x1"),
                ("whisper-tiny", "prefill_32k", "1x1"))
DRYRUN_BUDGET_S = 120.0
#: dryrun: the most the MoE's train_4k cell may count on 16x16 and on
#: 2x16x16 against one device, F x N / F(1x1) (2.53 when every model-axis
#: device routed its data shard's groups whole)
MOE_REPEAT_MAX = 1.20
#: dryrun: the most the MoE's decode_32k cell may count on 16x16 against
#: one device, F x N / F(1x1): 3.6006 while every data-axis device computed
#: every expert product of the step's one group (``MOE_DECODE_BEFORE``),
#: 1.0078 while every model-axis device routed the group's tokens, 1.0000
#: since each routes against its block of the router's columns and the
#: experts (``moe._repeat_axes``), plus 0.02 of margin for another torch's
#: lowering of the same step (the reference's ``MOE_DECODE_REFERENCE``)
MOE_DECODE_REPEAT_MAX = 1.02
MOE_DECODE_BEFORE, MOE_DECODE_REFERENCE = 3.6006, 1.4864
#: dryrun: the most xlstm-125m's train_4k cell may all-gather on 16x16, bytes
#: a device: 48.94 GB while ``sharding.sp_matmul`` moved the mLSTM's
#: sequence-sharded u onto its channels for each of its four row-parallel
#: products (``MLSTM_BEFORE``), 12.98 GB since each device multiplies its
#: own tokens by the gathered weight (``sharding.tokens_matmul``), 0.66 GB
#: since the up, gate and down products do too; the reference's
#: ``MLSTM_REFERENCE``
MLSTM_ALL_GATHER_MAX = 14e9
MLSTM_BEFORE, MLSTM_REFERENCE = 48.94e9, 3.00e9
#: dryrun: the most smollm-135m's train_4k cell may send on 16x16, bytes a
#: device: 31.03 GB while ``sharding.sp_matmul`` moved the activations of
#: the FFN's and the tied head's products under the sequence-parallel rules
#: (``SP_BEFORE``), 13.70 GB since each device multiplies its own tokens by
#: the gathered weight (``sharding.tokens_matmul``), plus 5%; the
#: reference's ``SP_REFERENCE``
SP_WIRE_MAX = 14.38e9
SP_BEFORE, SP_REFERENCE = 31.03e9, 37.04e9
#: dryrun: the most xlstm-125m's train_4k cell may count on 16x16 against
#: one device, F x N / F(1x1): 1.4024 while every model-axis device ran the
#: SSD recurrence's chunks of the whole sequence (the reference: 1.0369)
SSD_REPEAT_MAX = 1.10
#: dryrun: the most whisper-tiny's prefill_32k cell may count on 16x16
#: against one device, F x N / F(1x1): 1.0417 while its 1,500 frames,
#: which do not divide the model axis, ran the whole encoder on every
#: model-axis device (``ENCDEC_BEFORE``; the reference's
#: ``ENCDEC_REFERENCE``)
ENCDEC_REPEAT_MAX = 1.01
ENCDEC_BEFORE, ENCDEC_REFERENCE = 1.0417, 1.0297
#: dryrun: the most each decode_32k cell on 16x16 in ``DECODE_CELLS`` may
#: all-gather a device, bytes: the row writes and the token's query.
#: qwen2-moe-a2.7b read 97.02 GB on torch 2.11 when the cache's row was
#: written by a select over the whole sequence, which gathered it, and
#: 0.38 GB while DTensor's softmax gathered the fp32 scores
#: (``score_gather``)
DECODE_ALL_GATHER_MAX = 2e7
DECODE_CELLS = ("qwen2-moe-a2.7b", "qwen2-7b")
#: dryrun: one sLSTM block of xlstm-125m (n_layers 1) at the train_4k
#: batch on 16x16, lowered at these sequence lengths; its all-gather is
#: linear in S (at most SLSTM_GROWTH_MAX per doubling), and its linear fit
#: read at S = 4096 must stay under SLSTM_ALL_GATHER_MAX bytes a device
#: (1% of the 827 GB once logged for the gathers of every time step)
SLSTM_FIT_S = (32, 64)
SLSTM_GROWTH_MAX = 2.2
SLSTM_ALL_GATHER_MAX = 8.3e9
#: dryrun: the fake peak per device against the card's allocator peak of
#: the same step, relative
PEAK_TOL = 0.15


def launch_counts() -> dict:
    """Both wrappers' launch counts by variant."""
    from repro_torch.kernels.blocked_matmul import blocked_matmul
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    return {"blocked_matmul": dict(blocked_matmul.launches_by_variant),
            "flash_attention_bhsd": dict(
                flash_attention_bhsd.launches_by_variant)}


def first_sequence(text: str) -> list:
    """The token list of the serve CLI's ``first sequence:`` line."""
    line = [ln for ln in text.splitlines()
            if ln.startswith("first sequence: ")][0]
    return json.loads(line.removeprefix("first sequence: "))


def mesh_serve(dev, say, params, cfg, tokens: torch.Tensor) -> dict:
    """smollm-135m served under a 1x1 mesh on the card.  (a) The serve CLI
    (``launch.serve``, the plain path) with ``--mesh 1x1``: its tokens
    those of ``greedy_generate`` on the same seed with no mesh.  (b) The
    main path, counts set to 0 before it and read after: in a bound 1x1
    NCCL mesh, the params placed through ``specs_to_shardings`` (local
    tensors on one device), the prefill ``forward`` of ``tokens`` with
    ``use_flash`` and ``use_kernel_matmul`` and ``greedy_generate`` of its
    first ``MESH_B`` rows with the FFN products in the blocked matmul.
    (c) The same calls with no mesh: logits bit for bit, tokens and both
    kernels' launches equal.  (d) ``--mesh 2x1`` exits 2 naming several
    cards.  Returns the main path's launches and its greedy steps."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (gqa_safe_rules, place_tree,
                                                  specs_to_shardings,
                                                  use_sharding)
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import open_mesh
    from repro_torch.models import transformer
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.train.loop import model_param_specs
    from repro_torch.tree import tree_leaves

    args = ["--arch", "smollm-135m", "--batch", str(MESH_B), "--prompt-len",
            str(MESH_PROMPT), "--new-tokens", str(MESH_NEW), "--seed", "3"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.main(args + ["--mesh", "1x1"])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"serve --mesh 1x1 exited {rc}")
    check(not dist.is_initialized(), "the serve CLI left its world up")
    plain = get_config("smollm-135m")
    p = transformer.init_lm(plain, torch.Generator(device=dev).manual_seed(3),
                            device=dev)
    prompt = torch.randint(0, plain.vocab_size, (MESH_B, MESH_PROMPT),
                           generator=torch.Generator().manual_seed(4)).to(dev)
    want = greedy_generate(p, plain, prompt, steps=MESH_NEW,
                           max_len=MESH_PROMPT + MESH_NEW)[0].tolist()
    del p
    got = first_sequence(out.getvalue())
    say(f"(a) launch.serve --mesh 1x1 ({' '.join(args)}): {cli_s:.2f} s; "
        f"first sequence equals greedy_generate with no mesh: {got == want}")
    check(got == want, "the serve CLI's tokens under --mesh 1x1 differ")

    kcfg = cfg.replace(use_flash=True, use_kernel_matmul=True)
    g_prompt = tokens[:MESH_B, :MESH_PROMPT]
    steps = MESH_PROMPT + MESH_NEW - 1

    def drive(tree):
        logits = transformer.forward(tree, tokens, kcfg)[0]
        gen = greedy_generate(tree, kcfg, g_prompt, steps=MESH_NEW,
                              max_len=MESH_PROMPT + MESH_NEW)
        torch.cuda.synchronize()
        return logits, gen

    t0 = time.perf_counter()
    with open_mesh((1, 1), ("data", "model")) as mesh, \
            use_sharding(mesh, gqa_safe_rules(cfg.n_kv_heads, mesh)):
        placed = place_tree(params, specs_to_shardings(
            model_param_specs(cfg), mesh))
        local = all(a is b for a, b in zip(tree_leaves(params),
                                           tree_leaves(placed)))
        reset_counts()
        logits_m, gen_m = drive(placed)
        main = launch_counts()
    mesh_s = time.perf_counter() - t0
    check(local, "a 1x1 mesh placed a param as anything but itself")
    check(not dist.is_initialized(), "the 1x1 mesh's world outlived it")
    reset_counts()
    logits_0, gen_0 = drive(params)
    unbound = launch_counts()
    same = torch.equal(logits_m, logits_0)
    say(f"(b) in a bound 1x1 NCCL mesh ({mesh_s:.2f} s): prefill "
        f"{tuple(tokens.shape)} use_flash + use_kernel_matmul, then "
        f"{steps} greedy steps of B={MESH_B}: launches {main}; params "
        f"placed as the local tensors they were: {local}")
    say(f"(c) the same with no mesh: launches {unbound}; logits bit for bit "
        f"equal: {same}; tokens equal: {torch.equal(gen_m, gen_0)}")
    check(same, "prefill logits under the 1x1 mesh differ from no mesh")
    check(torch.equal(gen_m, gen_0), "greedy tokens under the mesh differ")
    check(main == unbound, f"launches differ: mesh {main}, none {unbound}")
    nl = cfg.n_layers
    check(sum(main["flash_attention_bhsd"].values()) == nl
          and sum(main["blocked_matmul"].values()) == 3 * nl * (1 + steps),
          f"expected {nl} flash and {3 * nl * (1 + steps)} blocked matmul "
          f"launches, got {main}")
    del logits_m, logits_0

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = serve_cli.main(args + ["--mesh", "2x1"])
    say(f"(d) launch.serve --mesh 2x1 on one card: exit {rc}: "
        f"{err.getvalue().strip()}")
    check(rc == 2 and "several cards" in err.getvalue(),
          "--mesh 2x1 on one card must exit 2 naming several cards")
    return {"launches": main, "steps": steps}


def mesh_train(dev, say, tmp: str) -> dict:
    """smollm-135m trained under ``--mesh 1x1`` on the card (the train CLI,
    (8, 512), checkpoints at 2 and 4), then a degraded restart on one
    surviving card: the plan dp1 x tp1, the state restored onto the card's
    mesh bit for bit the saved one; a corrupted latest step quarantined and
    the restart landing on the step before; the steps after it resumed
    from the restored state, their CE held to the uninterrupted run's
    (``RESUME_TOL``).  Neither launches a kernel (training is plain)."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_stream, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.resilience.degraded import degraded_restart
    from repro_torch.resilience.harness import _corrupt_latest

    d = os.path.join(tmp, "mesh_train")
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(MESH_TRAIN + ["--ckpt-dir", d]))
    wall = time.perf_counter() - t0
    check(run is not None and [h["step"] for h in run.history]
          == [0, 1, 2, 3], "the train CLI under --mesh 1x1 did not run 0-3")
    check(not dist.is_initialized(), "the train CLI left its world up")
    say(f"launch.train {' '.join(MESH_TRAIN)}: {wall:.2f} s; CE "
        + " ".join(f"{h['ce']:.4f}" for h in run.history))
    cfg = get_config("smollm-135m")
    specs = train_state_specs(cfg, zero1=False)
    ck = Checkpointer(d)

    def restart():
        t0 = time.perf_counter()
        out = degraded_restart(ck, run.state, specs, cfg, "h100_sxm",
                               surviving_chips=1, global_batch=8, seq=512)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dist.destroy_process_group()
        return out, secs

    out, secs = restart()
    equal = leaves_equal(run.state, out.state)
    t0 = time.perf_counter()
    back, _ = ck.restore(run.state, step=4)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del back
    say(f"degraded_restart(h100_sxm, surviving_chips=1): plan "
        f"{out.plan.mesh} ({out.plan.bottleneck}-bound, "
        f"{out.plan.runtime * 1e3:.3f} ms, {out.plan.hbm_used_gb:.2f} GB), "
        f"mesh {tuple(out.mesh.shape)}, landed on step {out.step}, "
        f"{secs:.3f} s (re-plan, mesh, restore with verify; "
        f"Checkpointer.restore alone {plain_s:.3f} s); bit for bit the saved "
        f"state: {equal}")
    check((out.plan.dp, out.plan.tp) == (1, 1), f"plan {out.plan.mesh}")
    check(out.step == 4 and equal, "the restart did not restore step 4 as "
          "it was saved")
    del out

    check(_corrupt_latest(ck), "nothing to corrupt")
    out, secs2 = restart()
    quarantined = [n for n in os.listdir(d) if ".quarantined_" in n]
    say(f"step 4 corrupted: the restart landed on step {out.step} in "
        f"{secs2:.3f} s; quarantined {quarantined}")
    check(out.step == 2 and len(quarantined) == 1,
          "the corrupt step was not quarantined or the restart did not fall "
          "back to step 2")
    stream = make_stream(cfg, DataConfig(seed=0, global_batch=8, seq_len=512))
    state, ces = out.state, []
    for s in (2, 3):
        state, m = run.train_step(state, to_device(stream.batch(s), dev))
        ces.append(m["ce"].item())
    want = [h["ce"] for h in run.history[2:]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ces, want))
    say(f"steps 2-3 resumed from the restart: CE {ces} against the "
        f"uninterrupted run's {want}: max rel {rel:.3e} (tol {RESUME_TOL:g})")
    check(rel < RESUME_TOL, f"resumed CE off the uninterrupted run: {rel}")
    del out, state, run
    return {"restore_s": secs, "fallback_s": secs2, "plain_s": plain_s}


#: the examples' counterparts (``examples/<name>_torch.py``), each run on
#: the card in a process of its own at the reference example's sizes
EXAMPLES = ("serve_demo", "dlrm_case_study", "plan_demo", "quickstart",
            "ridgeline_analysis")
EXAMPLES_TIMEOUT_S = 300.0
#: runs one example as ``__main__`` and prints, last, both wrappers' launch
#: counts by variant in that process
EXAMPLE_RUNNER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.kernels.flash_attention import flash_attention_bhsd
print(json.dumps({"blocked_matmul": blocked_matmul.launches_by_variant,
                  "flash_attention_bhsd":
                      flash_attention_bhsd.launches_by_variant}))
"""


def examples_phase(say, tmp: str) -> dict:
    """Each of ``EXAMPLES`` on the card in a process of its own
    (``EXAMPLE_RUNNER``), the five side by side (each is mostly its own
    start-up: a process takes ~7 s to reach the card), their output in
    files under ``tmp``: exit 0 and ``OK``, the seconds each took, and the
    kernel launches it made, by variant.  Returns the launches by
    example."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs, done = {}, {}
    with contextlib.ExitStack() as files:
        for name in EXAMPLES:
            out, err = (files.enter_context(open(os.path.join(
                tmp, name + ext), "w+")) for ext in (".out", ".err"))
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER,
                 os.path.join(ROOT, "examples", f"{name}_torch.py")],
                cwd=ROOT, env=env, stdout=out, stderr=err, text=True),
                out, err)
        try:
            while len(done) < len(procs) and \
                    time.perf_counter() - t0 < EXAMPLES_TIMEOUT_S:
                for name, (p, _, _) in procs.items():
                    if name not in done and p.poll() is not None:
                        done[name] = time.perf_counter() - t0
                time.sleep(0.1)
        finally:
            for p, _, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        made = {}
        for name, (p, out, err) in procs.items():
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            for line in lines[:-1]:
                print(f"    | {line}")
            ok = p.returncode == 0 and len(lines) >= 2 and "OK" in lines[-2]
            check(ok, f"examples/{name}_torch.py: rc {p.returncode}, no OK"
                  + ("" if ok else ": " + err.read()[-3000:]))
            made[name] = json.loads(lines[-1])
            say(f"  examples/{name}_torch.py: rc {p.returncode}, "
                f"{lines[-2].strip()!r}, {done[name]:.1f} s (five side by "
                f"side); launches {made[name]}")
    return made


def analysis_start() -> subprocess.Popen:
    """``python -m repro_torch.analysis --json`` on the port's tree, started
    (it runs beside the examples); ``analysis_line`` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.analysis",
                             "--json"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def analysis_line(say, proc: subprocess.Popen) -> None:
    """The static checks' exit code, files and findings; the gate must be
    clean."""
    out, err = proc.communicate(timeout=120)
    doc = json.loads(out)
    say(f"analysis: python -m repro_torch.analysis exit {proc.returncode}, "
        f"{doc['n_files']} files, {doc['n_findings']} findings, "
        f"{len(doc['suppressed'])} suppressed")
    check(proc.returncode == 0 and doc["n_findings"] == 0
          and not doc["suppressed"], "the port's static checks are not "
          "clean: " + err[-2000:])


def score_gather(cfg, shape) -> float:
    """The bytes a device all-gathered at a decode cell on 16x16 while
    DTensor's softmax gathered the scores: each layer's (rows, H, S_max)
    fp32 scores, 15/16 of them from the other model-axis devices."""
    rows = shape.global_batch // 16
    return rows * cfg.n_heads * shape.seq_len * 4 * cfg.n_layers * 15 / 16


def dryrun_phase(dev, say) -> None:
    """The dry-run (``launch.dryrun.lower_cell``) of ``DRYRUN_CELLS`` on the
    card's host: fake DTensors over a fake process group, no card byte and
    no kernel.  dlrm-mlp at 1x1 is held to the card's own step at B = 256
    (F to ``counters.count``'s, the fake peak to the allocator's peak
    within ``PEAK_TOL``); at 16x16 its wire bytes to the ring all-reduce of
    its fp32 params, the planner's dp-16 term, within 1%.  The MoE's
    train cell counts F x N / F(1x1) at most ``MOE_REPEAT_MAX`` on 16x16
    and 2x16x16, its decode cell at most ``MOE_DECODE_REPEAT_MAX`` on
    16x16, the xLSTM's at most ``SSD_REPEAT_MAX`` on 16x16 and its
    all-gather at most ``MLSTM_ALL_GATHER_MAX`` a device, smollm's train
    cell's wire at most ``SP_WIRE_MAX`` a device on 16x16, whisper's
    prefill cell at most ``ENCDEC_REPEAT_MAX`` on 16x16, the
    decode cells of ``DECODE_CELLS`` all-gather at most
    ``DECODE_ALL_GATHER_MAX`` a device on 16x16, and one sLSTM block's
    all-gather at the train_4k batch grows linearly in S, its fit at S =
    4096 under ``SLSTM_ALL_GATHER_MAX``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.launch import dryrun
    from repro_torch.launch.plan import plan
    from repro_torch.launch.specs import param_counts
    from repro_torch.measure import counters
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.train import loop

    reset_counts()
    m0 = torch.cuda.memory_allocated(dev)
    t_all = time.perf_counter()
    cells = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rep, low = dryrun.lower_cell(arch, shape, mesh)
        cells[(arch, shape, mesh)] = low
        kinds = ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                          sorted(low.wire_bytes_by_kind.items()))
        say(f"  {arch} {shape} {mesh}: {time.perf_counter() - t0:.1f} s; "
            f"{rep.bottleneck}-bound on h100_sxm, runtime "
            f"{rep.runtime * 1e3:.3f} ms (t_C {rep.t_compute * 1e3:.3f}, t_M "
            f"{rep.t_memory * 1e3:.3f}, t_N {rep.t_network * 1e3:.3f}); "
            f"per device F {low.flops:.6g}, B_M {low.mem_bytes:.6g}, wire "
            f"{low.wire_bytes / 1e9:.4f} GB ({kinds or 'none'}), cross-pod "
            f"{low.cross_pod_wire_bytes / 1e9:.4f} GB, peak "
            f"{low.peak_memory_per_device / 1e9:.3f} GB; useful/counted F "
            f"{rep.useful_flops_ratio:.3f}; {rep.notes}")
    gathered = {}
    for S in SLSTM_FIT_S:
        name = f"train_s{S}"
        SHAPES[name] = ShapeSpec(name, S, SHAPES["train_4k"].global_batch,
                                 "train")
        try:
            _, low = dryrun.lower_cell(
                "xlstm-125m", name, "16x16", probe=False,
                overrides={"n_layers": 1, "slstm_layers": (0,)})
        finally:
            del SHAPES[name]
        gathered[S] = low.wire_bytes_by_kind.get("all-gather", 0.0)
    total_s = time.perf_counter() - t_all
    grown = torch.cuda.memory_allocated(dev) - m0
    say(f"dry-run of {len(DRYRUN_CELLS)} cells and {len(SLSTM_FIT_S)} "
        f"sLSTM blocks: {total_s:.1f} s (budget "
        f"{DRYRUN_BUDGET_S:g} s); card bytes allocated {grown}; launches "
        f"{launch_counts()}")
    check(grown == 0, f"the dry-run allocated {grown} card bytes")
    check(all(sum(v.values()) == 0 for v in launch_counts().values()),
          "the dry-run launched a kernel")
    check(total_s < DRYRUN_BUDGET_S, f"the dry-run took {total_s:.1f} s")

    moe_one = cells[("qwen2-moe-a2.7b", "train_4k", "1x1")]
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        moe_pod = cells[("qwen2-moe-a2.7b", "train_4k", mesh)]
        repeat = moe_pod.flops * n / moe_one.flops
        say(f"qwen2-moe-a2.7b train_4k per device F: {mesh} "
            f"{moe_pod.flops!r}, 1x1 {moe_one.flops!r} (torch "
            f"{torch.__version__}); F x {n} / F(1x1) {repeat:.4f} (at most "
            f"{MOE_REPEAT_MAX})")
        check(repeat <= MOE_REPEAT_MAX,
              f"the MoE repeats its work on {mesh}: {repeat:.4f}")
    dec_one = cells[("qwen2-moe-a2.7b", "decode_32k", "1x1")]
    dec_pod = cells[("qwen2-moe-a2.7b", "decode_32k", "16x16")]
    repeat = dec_pod.flops * 256 / dec_one.flops
    say(f"qwen2-moe-a2.7b decode_32k per device F: 16x16 {dec_pod.flops!r}, "
        f"1x1 {dec_one.flops!r} (torch {torch.__version__}); F x 256 / "
        f"F(1x1) {repeat:.4f} (at most {MOE_DECODE_REPEAT_MAX}; "
        f"{MOE_DECODE_BEFORE} while every data-axis device computed every "
        f"expert product, 1.0078 while every model-axis device routed "
        f"every token; the reference {MOE_DECODE_REFERENCE})")
    check(repeat <= MOE_DECODE_REPEAT_MAX,
          f"the MoE's decode repeats its work on 16x16: {repeat:.4f}")
    ssd_one = cells[("xlstm-125m", "train_4k", "1x1")]
    ssd_pod = cells[("xlstm-125m", "train_4k", "16x16")]
    repeat = ssd_pod.flops * 256 / ssd_one.flops
    say(f"xlstm-125m train_4k per device F: 16x16 {ssd_pod.flops!r}, 1x1 "
        f"{ssd_one.flops!r} (torch {torch.__version__}); F x 256 / F(1x1) "
        f"{repeat:.4f} (at most {SSD_REPEAT_MAX}; 1.4024 while each device "
        f"ran the whole sequence's SSD chunks; the reference 1.0369)")
    check(repeat <= SSD_REPEAT_MAX,
          f"the SSD recurrence repeats its work on 16x16: {repeat:.4f}")
    gather = ssd_pod.wire_bytes_by_kind.get("all-gather", 0.0)
    say(f"xlstm-125m train_4k 16x16: all-gather a device {gather!r} B "
        f"(torch {torch.__version__}; at most {MLSTM_ALL_GATHER_MAX:g}; "
        f"{MLSTM_BEFORE:g} while each row-parallel mLSTM product moved u "
        f"onto its channels; the reference {MLSTM_REFERENCE:g}), wire "
        f"{ssd_pod.wire_bytes!r} B, B_M {ssd_pod.mem_bytes!r}")
    check(gather <= MLSTM_ALL_GATHER_MAX,
          f"the mLSTM gathers {gather / 1e9:.4f} GB a device on 16x16")
    sp_pod = cells[("smollm-135m", "train_4k", "16x16")]
    say(f"smollm-135m train_4k 16x16: wire a device {sp_pod.wire_bytes!r} B "
        f"(torch {torch.__version__}; at most {SP_WIRE_MAX:g}; {SP_BEFORE:g} "
        f"while the FFN's and the head's products moved the activations; "
        f"the reference {SP_REFERENCE:g}), F {sp_pod.flops!r}, B_M "
        f"{sp_pod.mem_bytes!r}")
    check(sp_pod.wire_bytes <= SP_WIRE_MAX,
          f"smollm's train cell sends {sp_pod.wire_bytes / 1e9:.4f} GB a "
          f"device on 16x16")
    enc_one = cells[("whisper-tiny", "prefill_32k", "1x1")]
    enc_pod = cells[("whisper-tiny", "prefill_32k", "16x16")]
    repeat = enc_pod.flops * 256 / enc_one.flops
    say(f"whisper-tiny prefill_32k per device F: 16x16 {enc_pod.flops!r}, "
        f"1x1 {enc_one.flops!r} (torch {torch.__version__}); F x 256 / "
        f"F(1x1) {repeat:.4f} (at most {ENCDEC_REPEAT_MAX}; {ENCDEC_BEFORE} "
        f"while every model-axis device ran the whole encoder; the "
        f"reference {ENCDEC_REFERENCE})")
    check(repeat <= ENCDEC_REPEAT_MAX,
          f"the encoder repeats its work on 16x16: {repeat:.4f}")
    for arch in DECODE_CELLS:
        dec = cells[(arch, "decode_32k", "16x16")]
        gather = dec.wire_bytes_by_kind.get("all-gather", 0.0)
        say(f"{arch} decode_32k 16x16: all-gather a device {gather!r} B "
            f"(torch {torch.__version__}; at most "
            f"{DECODE_ALL_GATHER_MAX:g}; the fp32 scores' gather "
            f"{score_gather(get_config(arch), SHAPES['decode_32k']):.6g} B "
            f"before each device softmaxed its own keys), per device F "
            f"{dec.flops!r}, B_M {dec.mem_bytes!r}")
        check(gather <= DECODE_ALL_GATHER_MAX,
              f"{arch}'s decode gathers {gather / 1e9:.4f} GB a device")
    (s0, g0), (s1, g1) = sorted(gathered.items())
    fit = g0 + (g1 - g0) / (s1 - s0) * (SHAPES["train_4k"].seq_len - s0)
    cell = cells[("xlstm-125m", "train_4k", "16x16")]
    say(f"xlstm-125m one sLSTM block, train batch "
        f"{SHAPES['train_4k'].global_batch} on 16x16: all-gather a device "
        f"{g0:.6g} B at S {s0}, {g1:.6g} B at S {s1} ({g1 / g0:.4f}x, at "
        f"most {SLSTM_GROWTH_MAX}x); linear fit at S "
        f"{SHAPES['train_4k'].seq_len}: {fit / 1e9:.4f} GB (under "
        f"{SLSTM_ALL_GATHER_MAX / 1e9:g}); the train_4k cell's, whose k = "
        f"2, 4 probe holds mLSTM blocks only: "
        f"{cell.wire_bytes_by_kind.get('all-gather', 0.0) / 1e9:.4f} GB")
    check(g1 <= SLSTM_GROWTH_MAX * g0,
          f"the sLSTM's all-gather grows {g1 / g0:.2f}x per doubling of S")
    check(fit < SLSTM_ALL_GATHER_MAX,
          f"the sLSTM's all-gather at train_4k: {fit / 1e9:.3f} GB")

    cfg = get_config("dlrm-mlp")
    one = cells[("dlrm-mlp", "train_4k", "1x1")]
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    opt = AdamW(learning_rate=1e-3)
    state = loop.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                  cfg, opt, device=dev)
    batch = click_batch(np.random.default_rng(5), 256, cfg.mlp_widths[0], dev)
    step = loop.build_train_step(cfg, opt)
    out = step(state, batch)
    torch.cuda.synchronize()
    del out
    peak = torch.cuda.max_memory_allocated(dev) - base
    flops, _ = counters.count(step, state, batch)
    gap = (one.peak_memory_per_device - peak) / peak
    say(f"dlrm-mlp train_4k 1x1 against the card's step at B=256: F "
        f"dry-run {one.flops:.9g}, card counters.count {flops:.9g} (rel "
        f"{abs(one.flops - flops) / flops:.2e}, tol 1e-6); peak dry-run "
        f"{one.peak_memory_per_device / 1e9:.4f} GB, card "
        f"max_memory_allocated {peak / 1e9:.4f} GB: gap {100 * gap:+.2f}% "
        f"(tol {100 * PEAK_TOL:g}%)")
    check(abs(one.flops - flops) <= 1e-6 * flops, "F differs at 1x1")
    check(abs(gap) < PEAK_TOL, f"fake peak {100 * gap:+.1f}% off the card's")
    del state, batch

    pod = cells[("dlrm-mlp", "train_4k", "16x16")]
    want = 2 * 15 / 16 * 4 * param_counts(cfg)[0]
    dp16 = [p for p in plan(cfg, H100_SXM, 16, batch=256,
                            algorithms=("ring",)) if (p.dp, p.tp) == (16, 1)]
    say(f"dlrm-mlp train_4k 16x16: wire per device {pod.wire_bytes:.6g} B "
        f"against 2 x 15/16 x fp32 params {want:.6g} B (rel "
        f"{abs(pod.wire_bytes - want) / want:.2e}) and the planner's dp16 "
        f"term {dp16[0].net_bytes:.6g} B")
    check(abs(pod.wire_bytes - want) <= 0.01 * want, "dp-16 wire bytes")
    check(abs(pod.wire_bytes - dp16[0].net_bytes)
          <= 0.01 * dp16[0].net_bytes, "wire bytes off the planner's term")
    two = cells[("qwen2-7b", "train_4k", "2x16x16")]
    check(two.cross_pod_wire_bytes > 0, "no cross-pod bytes at 2x16x16")


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
    # an fp32 A 4 bytes past an aligned base: the 16-byte copies of the f32
    # kernel cannot read it, so it takes f32_edge
    flat = torch.randn(300 * 512 + 1, generator=gen, device=dev)
    a = flat[1:].view(300, 512)
    b = torch.randn((512, 520), generator=gen, device=dev)
    bias = torch.randn((520,), generator=gen, device=dev)
    var = bm.variant(300, 520, 512, torch.float32, bm.aligned(a, b, bias))
    before = dict(blocked_matmul.launches_by_variant)
    got = blocked_matmul(a, b, bias=bias, act="silu")
    err = rel_err(got, ref_matmul(a, b, bias=bias, act="silu"))
    say(f"  float32 (300,512,520) A at a 4-byte offset act=silu {var}: "
        f"rel_err {err:.3e} (tol {TOL[torch.float32]:g})")
    check(var == "f32_edge" and blocked_matmul.launches_by_variant
          == {**before, var: before[var] + 1},
          f"an unaligned fp32 A must take one f32_edge launch: {var}")
    check(err < TOL[torch.float32], f"f32_edge disagrees off 16 bytes: {err}")
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

    # ---- 5-6. moe_prefill and moe_decode: the MoE paths, on an empty card ----
    del a, b, bias, got, want, a3, b3, flat, q, k, v, clean_k, clean_v
    torch.cuda.empty_cache()
    moe_pre, moe_dec = moe_paths(dev, say, gen)

    # ---- 7-10. hybrid_prefill, hybrid_decode, xlstm_prefill, xlstm_decode --
    rec = recurrent_paths(dev, say, gen)
    hyb_pre, hyb_dec = rec["hybrid_prefill"], rec["hybrid_decode"]

    # ---- encdec_prefill, encdec_decode, vlm_prefill, vlm_decode ---------------
    ev = encdec_vlm_paths(dev, say, gen)
    ed_pre, ed_dec = ev["encdec_prefill"], ev["encdec_decode"]
    vl_pre, vl_dec = ev["vlm_prefill"], ev["vlm_decode"]

    # ---- 11. mlp_serve: the first main path ----------------------------------------
    phase("mlp_serve")
    from repro_torch.configs import get_config
    from repro_torch.convert import mlp_params_from_numpy
    from repro_torch.models import mlp_dlrm
    from repro_torch.tree import tree_leaves

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
    reset_counts()
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
    # every measured point of the main paths, for the ridgeline phase
    points = []
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
        points.append({
            "arch": "dlrm-mlp", "shape": f"serve_b{B}", "mesh": "1",
            "kind": "serve_step", "variant": "kernel", "flops": fwd_flops,
            "mem_bytes": fwd_bytes, "wire_bytes": 0.0, "by_kind": {},
            "tokens": float(B), "seconds": fwd.median, "main": True,
            "source": "chip_smoke mlp_serve host median",
            "notes": "the forward through the sm90 kernel"})
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
    mlp_params = float(sum(x.numel() for x in tree_leaves(params)))
    for p in points:
        p.update(peak=float(peak), params=mlp_params)
    points += [moe_pre["point"], moe_dec["point"], hyb_pre["point"],
               hyb_dec["point"], rec["xlstm_prefill"]["point"],
               rec["xlstm_decode"]["point"], ed_pre["point"],
               ed_dec["point"], vl_pre["point"], vl_dec["point"]]
    say(f"peak memory allocated {peak / 1e9:.3f} GB; weight casts "
        f"{cast_ms:.4f} ms per forward (bound "
        f"{L * 6.0 * (W * W + W) / H100_SXM.hbm_bw * 1e3:.4f} ms)")

    # ---- 12. lm_prefill: the second main path ----------------------------------------
    phase("lm_prefill")
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
    reset_counts()
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
    points.append({
        "arch": "smollm-135m", "shape": f"prefill_b{B0}_s{S0}", "mesh": "1",
        "kind": "prefill", "variant": "use_flash", "flops": lm_flops,
        "mem_bytes": lm_bytes, "wire_bytes": 0.0, "by_kind": {},
        "peak": float(lm_peak), "params": float(n_params), "tokens": float(T),
        "seconds": lm_fwd.median, "main": True,
        "source": "chip_smoke lm_prefill host median",
        "notes": "least bytes: params once, logits written"})
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
    for label, c, card_ms in (
            ("use_flash", lm_cfg, lm_ev),
            ("use_flash + use_kernel_matmul", lm_kmm, kmm_ev)):
        kern = profile_kernels(
            lambda: transformer.forward(lm_params, toks, c))
        kern_ms = sum(ms for _, _, ms in kern)
        check(kern_ms > 0, "the profiler saw no kernel time on the card")
        say(f"  B={B0} S={S0} profile of one forward ({label}): {len(kern)} "
            f"kernel names, {sum(n for _, n, _ in kern)} launches, "
            f"{kern_ms:.4f} ms of kernels = {100 * kern_ms / card_ms:.1f}% of "
            f"the unprofiled card time {card_ms:.4f} ms; by name, most first:")
        for name, n, ms in sorted(kern, key=lambda x: -x[2])[:20]:
            say(f"    {ms:9.4f} ms {100 * ms / kern_ms:5.1f}% x{n:<4d} "
                f"{name[:110]}")

    # the flash kernel per launch at each main-path shape (``flash_row``);
    # q, k, v of (8, 2048) are 31 MB, so they sit in L2
    flash_fns = fa._launcher()
    flash_rows = [flash_row(say, "lm_prefill", flash_fns, gen, B, S, H, K, dh,
                            NL * sum(1 for bs, _ in runs if bs == (B, S)))
                  for B, S in PREFILL]
    attn_ms = NL * flash_rows[0]["kernel_ms"]
    say(f"  B={B0} S={S0}: {NL} flash launches take {attn_ms:.4f} ms = "
        f"{100 * attn_ms / lm_ev:.1f}% of the forward's card time")

    # the FFN products of the use_kernel_matmul forward, per launch
    ffn = {n: lm_params["blocks"][0]["ffn"][n].to(bf16)
           for n in ("w_gate", "w_up", "w_down")}
    x_in = torch.randn((T, d), generator=gen, device=dev).to(bf16)
    x_mid = torch.randn((T, f), generator=gen, device=dev).to(bf16)
    ffn_rows = [ffn_row(say, "lm_prefill", a_, [b_], act, NL, H100_SXM)
                for a_, b_, act in ((x_in, ffn["w_gate"], "silu"),
                                    (x_in, ffn["w_up"], None),
                                    (x_mid, ffn["w_down"], None))]

    # ---- 13. lm_decode: the third main path ---------------------------------------
    phase("lm_decode")
    dec_paths, dec_rows, dec_placed = lm_decode(
        dev, say, lm_params, lm_cfg, tokens[PREFILL[0]])
    dec_variants = {v: sum(made[v] for made in dec_paths.values())
                    for v in bm.VARIANTS}
    for p in dec_placed:
        b = p["batch"]
        points.append({
            "arch": "smollm-135m", "shape": f"decode_b{b}_s{DECODE_MAX}",
            "mesh": "1", "kind": "decode", "variant": "use_kernel_matmul",
            "flops": p["flops"], "mem_bytes": p["mem_bytes"],
            "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
            "params": p["params"], "tokens": float(b),
            "seconds": p["seconds"], "main": True,
            "source": "chip_smoke lm_decode host median",
            "notes": "one step at the cache's last position; F and B_M "
                     "counted on the plain path"})

    # ---- 14. mlp_train: the fourth main path -------------------------------------
    phase("mlp_train")
    reset_counts()
    placed = mlp_train(dev, say, get_config("dlrm-mlp"),
                       np.random.default_rng(2))
    torch.cuda.synchronize()
    say(f"kernel launches during mlp_train: blocked_matmul "
        f"{blocked_matmul.launches}, flash {flash_attention_bhsd.launches}")
    check(blocked_matmul.launches == 0 and flash_attention_bhsd.launches == 0,
          "the train step reached a forward-only kernel")

    # the steps on the paper's data-parallel plane: the grads' ring
    # all-reduce at the paper's large-n asymptote (2 x their bytes, as
    # benchmarks/paper_case_study.py prices it); the step measured on one
    # card runs without it
    from repro_torch.distributed import collectives
    from repro_torch.models.mlp_dlrm import analytic_work_unit
    wire = float(collectives.all_reduce(4.0 * mlp_params, math.inf,
                                        "ring").wire_bytes)
    for B, work, host_s in placed:
        for variant, f_, m_, n_ in (
                ("counted", work.flops, work.mem_bytes, wire),
                ("paper_6bw2l", *analytic_work_unit(B, W, L))):
            points.append({
                "arch": "dlrm-mlp", "mesh": "dp",
                "shape": f"train_b{B}" + ("" if variant == "counted" else "_paper"),
                "kind": "train_step", "variant": variant, "flops": f_,
                "mem_bytes": m_, "wire_bytes": n_,
                "by_kind": {"all-reduce": n_}, "peak": 0.0,
                "params": mlp_params, "tokens": float(B), "seconds": host_s,
                "main": True, "source": "chip_smoke mlp_train host median",
                "notes": "one card, no all-reduce in the measured step"})

    # ---- 14b. train_cli, train_replay: the training substrate ------------------
    phase("train_cli")
    reset_counts()
    t_phase = time.perf_counter()
    train_tmp = tempfile.TemporaryDirectory()
    lm_train = train_cli(dev, say, train_tmp.name)
    say(f"train_cli took {time.perf_counter() - t_phase:.1f} s")
    phase("train_replay")
    t_phase = time.perf_counter()
    train_replay(dev, say, train_tmp.name)
    train_tmp.cleanup()
    torch.cuda.synchronize()
    say(f"train_replay took {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches during train_cli and train_replay: blocked_matmul "
        f"{blocked_matmul.launches}, flash {flash_attention_bhsd.launches}")
    check(blocked_matmul.launches == 0 and flash_attention_bhsd.launches == 0,
          "the training launcher reached a forward-only kernel")

    # ---- 14c. train_families: the moe, hybrid and ssm families train ---------
    phase("train_families")
    reset_counts()
    t_phase = time.perf_counter()
    fam_tmp = tempfile.TemporaryDirectory()
    train_families(dev, say, fam_tmp.name)
    fam_tmp.cleanup()
    torch.cuda.synchronize()
    say(f"train_families took {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches: {launch_counts()}")
    check(all(sum(v.values()) == 0 for v in launch_counts().values()),
          "a family's train step reached a forward-only kernel")
    points.append({
        "arch": "smollm-135m", "shape": "train_b8_s512", "mesh": "1",
        "kind": "train_step", "variant": "counted",
        "flops": lm_train["flops"], "mem_bytes": lm_train["mem_bytes"],
        "wire_bytes": 0.0, "by_kind": {}, "peak": 0.0,
        "params": lm_train["params"], "tokens": 8.0 * 512,
        "seconds": lm_train["seconds"], "main": True,
        "source": "chip_smoke train_cli host median",
        "notes": "one card; F and B_M counted by launch.train's report"})

    # ---- 15. calibrate: the fifth main path -------------------------------------
    phase("calibrate")
    reset_counts()
    cal_variants, f32_rows, cal_calib = calibrate(dev, say, card, placed,
                                                  get_config("dlrm-mlp"))
    cal_launches = sum(r["launches"] for r in f32_rows)
    say(f"blocked_matmul launches during calibrate, by variant: "
        f"{cal_variants} (the suite's GEMMs: {cal_launches})")
    check(cal_variants == {**dict.fromkeys(bm.VARIANTS, 0), "f32": cal_launches}
          and flash_attention_bhsd.launches == 0,
          f"the calibration GEMMs must each launch the f32 kernel once: "
          f"{cal_variants}")

    # ---- 16. calibrate_cli: the sixth main path ---------------------------------
    phase("calibrate_cli")
    tmp = tempfile.TemporaryDirectory()
    reset_counts()
    cli_variants, cli_rows, cli_calib, cli_ms = calibrate_cli(
        dev, say, tmp.name, cal_calib)

    # ---- 17. ridgeline: every main path's points on the plane -------------------
    phase("ridgeline")
    for m in cli_ms:
        points.append({
            "arch": dict(m.meta).get("arch", "microbench"),
            "shape": m.work.name, "mesh": "1", "kind": m.category,
            "variant": "measured", "flops": m.work.flops,
            "mem_bytes": m.work.mem_bytes, "wire_bytes": m.work.net_bytes,
            "by_kind": {}, "peak": 0.0, "params": 0.0, "tokens": 0.0,
            "seconds": m.seconds, "main": False,
            "source": "calibrate_cli host median",
            "notes": "calibration measurement"})
    ridgeline(say, tmp.name, points, cli_calib.spec())

    # ---- 17b. plan: the planner against what the card did -----------------------
    phase("plan")
    reset_counts()
    t_phase = time.perf_counter()
    drawn = {
        "dlrm-mlp": (get_config("dlrm-mlp"), mlp_params),
        "smollm-135m": (get_config("smollm-135m"), float(n_params)),
        "smollm-135m (trained)": (get_config("smollm-135m"),
                                  lm_train["params"]),
        MOE_ARCH: (get_config(MOE_ARCH), moe_pre["point"]["params"]),
        HYMBA_ARCH: (get_config(HYMBA_ARCH), hyb_pre["point"]["params"]),
        XLSTM_ARCH: (get_config(XLSTM_ARCH),
                     rec["xlstm_prefill"]["point"]["params"]),
        WHISPER_ARCH: (get_config(WHISPER_ARCH), ed_pre["point"]["params"]),
        f"{VLM_ARCH} at {VLM_LAYERS} layers": (
            get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS),
            vl_pre["point"]["params"])}
    plan_phase(dev, say, os.path.join(tmp.name, "calibration_torch"),
               tmp.name, drawn,
               {"dlrm-mlp": {B: s for B, _, s in placed},
                "smollm-135m": lm_train})
    tmp.cleanup()
    say(f"plan took {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"during plan: blocked_matmul {blocked_matmul.launches}, flash "
        f"{flash_attention_bhsd.launches}")
    check(blocked_matmul.launches == 0 and flash_attention_bhsd.launches == 0,
          "the planner launched a kernel")

    # ---- 17c. mesh_serve, mesh_train, dryrun: the mesh --------------------------
    phase("mesh_serve")
    t_phase = time.perf_counter()
    served = mesh_serve(dev, say, lm_params, lm_cfg, tokens[PREFILL[0]])
    # the main path's launches at lm_prefill's (8, 2048) shapes and
    # lm_decode's B = 8 shapes: their per-launch rows carry them
    flash_rows[0]["launches"] += sum(
        served["launches"]["flash_attention_bhsd"].values())
    for r in ffn_rows:
        r["launches"] += NL
    for r in dec_rows:
        if r["path"] == "lm_decode" and r["shape"][0] == MESH_B:
            r["launches"] += NL * served["steps"]
    say(f"mesh_serve took {time.perf_counter() - t_phase:.1f} s")
    phase("mesh_train")
    t_phase = time.perf_counter()
    reset_counts()
    mesh_tmp = tempfile.TemporaryDirectory()
    mesh_train(dev, say, mesh_tmp.name)
    mesh_tmp.cleanup()
    say(f"mesh_train took {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches: {launch_counts()}")
    check(all(sum(v.values()) == 0 for v in launch_counts().values()),
          "mesh_train reached a forward-only kernel")
    phase("dryrun")
    t_phase = time.perf_counter()
    dryrun_phase(dev, say)
    say(f"dryrun took {time.perf_counter() - t_phase:.1f} s")

    # ---- 17d. examples, analysis: the examples' counterparts, the gate ------
    phase("examples")
    t_phase = time.perf_counter()
    gate = analysis_start()
    with tempfile.TemporaryDirectory() as ex_tmp:
        ex_launches = examples_phase(say, ex_tmp)
    say(f"examples took {time.perf_counter() - t_phase:.1f} s; launches "
        f"(each example's own process) {ex_launches}")
    phase("analysis")
    analysis_line(say, gate)

    # ---- 18. tile_options -----------------------------------------------------
    phase("tile_options")
    # the sm90 kernel at every main-path shape under each tile width and
    # order, beside tile_plan's choice (PERF.md reads the rule off these);
    # each call takes the next of 8 weights, as a forward's layers do
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm90 = bm._launcher().sm90
    for row in (per_batch + ffn_rows + [r for r in dec_rows
                                        if r["dtype"] == "bf16"]
                + moe_pre["mm_rows"] + moe_dec["mm_rows"]
                + hyb_pre["mm_rows"] + hyb_dec["mm_rows"]):
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

    # ---- 19. f32_options ------------------------------------------------------
    phase("f32_options")
    # the f32 kernel at every calibration size under each tile, beside
    # f32_plan's choice (PERF.md reads the rule off these)
    f32 = bm._launcher().f32
    for row in f32_rows:
        s_ = row["shape"][0]
        a_, b_ = (torch.randn((s_, s_), generator=gen, device=dev)
                  for _ in range(2))
        rule = bm.f32_plan(s_, s_, s_, n_sms)
        timed = {t: kernel_ms(lambda i: f32_option(f32, a_, b_, None, None, t),
                              iters=20) for t in bm.F32_TILES}
        best = min(timed, key=timed.get)
        say(f"  {s_}^3: rule {rule.bm}x{rule.bn} {timed[rule]:.4f} ms; best "
            f"{best.bm}x{best.bn} {timed[best]:.4f} ms; all: "
            + ", ".join(f"{t.bm}x{t.bn} {ms:.4f}" for t, ms in timed.items()))
    del a_, b_

    # ---- 20. microbench -------------------------------------------------------
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

    new_paths = (ed_pre, ed_dec, vl_pre, vl_dec)
    mm_paths = (mlp_variants, lm_variants, dec_variants, cal_variants,
                cli_variants, moe_pre["blocked_matmul"],
                moe_dec["blocked_matmul"], hyb_pre["blocked_matmul"],
                hyb_dec["blocked_matmul"],
                served["launches"]["blocked_matmul"]) \
        + tuple(p["blocked_matmul"] for p in new_paths)
    fa_paths = (flash_variants, moe_pre["flash"],
                served["launches"]["flash_attention_bhsd"]) \
        + tuple(p["flash"] for p in new_paths if "flash" in p)
    summary = {"kernels": [
        entry("blocked_matmul",
              "src/repro_torch/kernels/csrc/blocked_matmul.cu",
              "src/repro/kernels/blocked_matmul.py:57",
              sum(sum(made.values()) for made in mm_paths),
              per_batch + ffn_rows + dec_rows + f32_rows + cli_rows
              + moe_pre["mm_rows"] + moe_dec["mm_rows"] + hyb_pre["mm_rows"]
              + hyb_dec["mm_rows"]
              + [r for p in new_paths for r in p["mm_rows"]],
              {v: sum(made[v] for made in mm_paths) for v in bm.VARIANTS}),
        entry("flash_attention_bhsd",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:75",
              sum(sum(made.values()) for made in fa_paths),
              flash_rows + moe_pre["flash_rows"]
              + [r for p in new_paths for r in p.get("flash_rows", [])],
              {v: sum(made[v] for made in fa_paths) for v in fa.VARIANTS}),
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
