// Fused GEMM + bias + activation for Hopper (sm_90a): out = act(A·B + bias).
//
// Replaces src/repro/kernels/blocked_matmul.py::blocked_matmul, the Pallas TPU
// kernel whose fp32 VMEM accumulator is carried across the sequential K grid
// axis and whose epilogue (_epilogue) adds the bias and applies the
// activation on that accumulator before one cast to the output dtype.
//
// What it computes: A (M,K) row-major, B (K,N) row-major, bias (N,) or null,
// out (M,N) row-major, all of one dtype (fp32 or bf16).  The product is
// accumulated in fp32; the bias is added in fp32; act is applied in fp32
// (0 none, 1 relu, 2 relu2 = relu^2, 3 silu = y*sigmoid(y),
// 4 gelu = 0.5*y*(1 + tanh(sqrt(2/pi)*(y + 0.044715*y^3)))); the result is
// cast to the output dtype once.  Any M, N, K >= 1; ragged edges are handled
// inside the kernels, so no padded copies are made.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3;
// ridge ~295 FLOP/byte), at the main paths' bf16 shapes (M, K, N), each
// input read once and the output written once:
//   (256, 4096, 4096)    dlrm B=256    37.7 MB, 8.6 GFLOP  -> bytes, 11.3 us
//   (1024, 4096, 4096)   dlrm B=1024   34.4 GFLOP          -> ops,   34.7 us
//   (4096, 4096, 4096)   dlrm B=4096   137 GFLOP           -> ops,   139 us
//   (16384, 576, 1536)   FFN gate, up  29.0 GFLOP, 71 MB   -> ops,   29.3 us
//   (16384, 1536, 576)   FFN down      29.0 GFLOP, 71 MB   -> ops,   29.3 us
// The FFN products write (or read) a 50 MB activation, so their byte time
// (21 us) is close behind the operations.
//
// Four kernels; blocked_matmul.py::variant picks one by dtype, shape and
// alignment alone.
//
// sm90 (bf16, K % 8 == 0, N % 8 == 0, A and B 16-byte aligned: TMA's rules
// for a row stride and a base; the bias 4-byte aligned, read in pairs).  The Hopper shape, for the operations:
//   * TMA loads into a ring of shared-memory stages (4 to 8, as many as fit)
//     under mbarriers, one full and one empty barrier per stage.  One
//     producer thread issues cp.async.bulk.tensor.2d for the A tile
//     (128 x 64, K-major) and the BN/64 boxes of the B tile (64 x 64 each,
//     N-major), all with 128-byte swizzle.  Out-of-bounds boxes read as
//     zeros, which handles ragged M, N and K edges with no padded copies.
//   * Two consumer warpgroups, 64 rows of the 128-row tile each, run
//     wgmma.mma_async m64nBNk16 on a stage (B with the transpose bit, as the
//     weights are (K, N) with N contiguous), keep one wgmma group in flight
//     and release a stage only after the wgmma that read it has retired.
//     setmaxnreg moves registers from the producer to them.
//   * A persistent grid: one CTA per SM walks the output tiles in the order
//     that shares the larger operand in L2: the N tile fastest (a band of
//     A's rows) when M >= N, else the M tile (a band of B's columns).  The
//     producer runs ahead into the next tile while the consumers run the
//     epilogue.
//   * The epilogue works on the accumulator registers: bias, act (one
//     instantiation per act), one cast to bf16, a 4x4 transpose within each
//     quad of lanes, and 16-byte guarded stores.
//   * blocked_matmul.py::tile_plan picks the tile width BN (64, 128, 192 or
//     256) and the order.  The memory-bound (256, 4096, 4096) takes narrow
//     tiles (BN 64, 128 CTAs) to fill the SMs; a split of K, with an fp32
//     workspace and a second pass for bias and act, was slower there
//     (chip_mutants.py times it as an edited copy).
// wmma (bf16 otherwise): nvcuda::wmma 16x16x16 tensor cores (mma.sync), one
// 128 x 128 tile per block, element-wise masked loads staged through
// registers into double-buffered shared memory.  PARITY_SHAPES in
// chip_smoke.py has two such shapes: (300, 700, 520) and (1, 4100, 17).
// f32 (fp32 with K % 4 == 0, N % 4 == 0, A, B and out 16-byte aligned: the
// rules of a 16-byte cp.async; the bias is read one float at a time).  IEEE
// fp32 FMAs on the CUDA cores: no TF32, no 3xTF32 split, so the bound is the
// 67 TFLOP/s of h100_sxm_fp32 (ridge 20 FLOP/byte: a square s^3 product is
// bound by its operations from s = 120 up; 64^3 by its bytes).  What bounds
// the inner loop is the instruction rate: an SM sub-partition dispatches one
// warp instruction a clock and its 32 FP32 lanes take one FFMA a clock, so
// every shared load, address or barrier takes a slot from an FFMA, and a
// warp waiting on global memory dispatches nothing.  The first design (f32_edge below) read 16 scalar
// LDS per 64 FFMAs, staged 8-deep K tiles through registers one tile ahead,
// and ran 128 x 128 tiles at every size (one CTA at 128^3, 16 at 512^3):
// 0.1-34% of its bound.  This design:
//   * A ring of 4 K stages of 16 in shared memory, filled by 16-byte
//     cp.async.cg copies under commit_group / wait_group, 3 tiles ahead of
//     the one read; zero-fill (src-size 0) covers ragged M, N and K.  One
//     __syncthreads a stage both publishes the landed tile and retires the
//     reads of the stage the next copy overwrites.  cp.async, not TMA: every
//     thread computes, so no producer warp or mbarrier is needed, and a
//     thread's copies cost 2-4 instructions a stage.
//   * 16-byte fragment reads: a thread holds TM rows x 8 columns (two
//     groups of 4, 32 apart) and reads, for 4 k at a time, one float4 of A
//     per row (A is row-major in shared memory, rows padded by 4 floats:
//     the four quarter-warps read four rows 80 bytes apart, distinct banks;
//     the 8 lanes of a quarter-warp read one address) and two float4 of B
//     per k (the 8 lanes read 128 contiguous bytes): 16 LDS.128 per 256
//     FFMAs at TM = 8.
//   * Two tiles of 4 warps (a warp: 4*TM rows x 64 columns): 64x128 at
//     TM = 8 and 32x64 at TM = 2.  blocked_matmul.py::f32_plan takes 64x128
//     where its grid covers half the SMs (768^3 and up) and 32x64 below,
//     where no tile fills the card and a thread's K loop sets the time.
//     128 threads and a ring of 52 KB (64x128) or 26 KB (32x64) let 3 or 7
//     CTAs share an SM (registers set the count).  chip_mutants.py keeps
//     the designs that lost or tied as alternatives: 128x128, 128x64 and
//     64x64 (TM = 4) tiles; K stages of 32, 3 or 6 stages; unpadded A rows;
//     a split of K into a workspace and a second pass.  The split won where
//     the grid is far below the SMs (256^3, 768^3) and lost at 64^3 and
//     1024^3; it is not in the rule (PERF.md).
//   * The epilogue adds the bias, applies act (accurate expf / tanhf: the
//     1e-5 parity leaves no room for tanh.approx) in one instantiation per
//     act, and stores each group of 4 columns as one float4, guarded per row
//     and group.
// f32_edge (the other fp32 calls): the first fp32 design, 8x8 outputs per
// thread, the same tiling and staging as wmma, element-wise masked loads.
//
// Build (plain C interface, loaded with ctypes; no -lcuda: the tensor-map
// encoder is found through cudaGetDriverEntryPoint):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libblocked_matmul.so blocked_matmul.cu

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kTileM = 128;
constexpr int kTileN = 128;

enum Act : int { kNone = 0, kRelu = 1, kRelu2 = 2, kSilu = 3, kGelu = 4 };

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(y, 0.0f);
    case kRelu2: {
      float r = fmaxf(y, 0.0f);
      return r * r;
    }
    case kSilu:
      return y * (1.0f / (1.0f + expf(-y)));
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    default:
      return y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// sm90: TMA ring, wgmma warpgroups, persistent grid.
// ---------------------------------------------------------------------------

constexpr int kSmBM = 128;            // two consumer warpgroups x 64 rows
constexpr int kSmBK = 64;             // one 128-byte swizzle row of bf16
constexpr int kSmThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;     // each releases every stage it read
constexpr int kSmemLimit = 232448;    // 227 KB per block on an H100
constexpr int kABytes = kSmBM * kSmBK * 2;   // 16 KB
constexpr int kBoxBytes = kSmBK * 64 * 2;    // one 64 x 64 B box, 8 KB

template <int BN>
struct Sm90Cfg {
  static constexpr int kStageBytes = kABytes + (BN / 64) * kBoxBytes;
  // as many stages as fit beside the barriers and 1 KB of alignment slack
  static constexpr int kStagesFit = (kSmemLimit - 2048) / kStageBytes;
  static constexpr int kStages = kStagesFit < 8 ? kStagesFit : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * 8 * kStages;
};

__device__ __forceinline__ float tanh_approx(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x));
  return t;
}

// The sm90 epilogue's activation, one instantiation per act so the unrolled
// epilogue holds no switch (a switch per element made the epilogue several
// times larger and the FFN products several times slower).  The functions
// of apply_act, on one SFU tanh each (tanh.approx.f32, relative error ~2^-11,
// below the bf16 rounding that follows): silu(y) = y/2 * (1 + tanh(y/2)).
template <int ACT>
__device__ __forceinline__ float fast_act(float y) {
  if (ACT == kRelu) return fmaxf(y, 0.0f);
  if (ACT == kRelu2) {
    const float r = fmaxf(y, 0.0f);
    return r * r;
  }
  if (ACT == kSilu) {
    const float h = 0.5f * y;
    return h + h * tanh_approx(h);
  }
  if (ACT == kGelu) {
    const float h = 0.5f * y;
    return h + h * tanh_approx(0.7978845608028654f * (y + 0.044715f * y * y * y));
  }
  return y;
}

// One consumer thread's share of a tile's epilogue.  The thread (warp w of
// its warpgroup, lane l, q = l % 4) holds rows row0 = 16w + l/4 and row0 + 8
// of the warpgroup's 64, at columns 8j + 2q and 8j + 2q + 1 for j < BN/8:
// acc[4j + 2h] and acc[4j + 2h + 1] for the row of half h.  bias + act +
// one cast; a 4x4 transpose within each quad of lanes then gives each lane
// 8 consecutive columns, one 16-byte store.
template <int BN, int ACT>
__device__ __forceinline__ void sm90_store_tile(
    const float* acc, int row0, int n0, int M, int N,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ C) {
  const int lane = threadIdx.x % 32, q = lane % 4;
#pragma unroll
  for (int g = 0; g < BN / 32; ++g) {
    uint32_t v[2][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * g + jj;
      const int col = n0 + 8 * j + 2 * q;
      float2 bz = make_float2(0.0f, 0.0f);
      if (bias != nullptr && col < N)
        bz = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h][jj] = pack_bf16x2(fast_act<ACT>(acc[4 * j + 2 * h] + bz.x),
                               fast_act<ACT>(acc[4 * j + 2 * h + 1] + bz.y));
    }
    const int col = n0 + 8 * (4 * g + q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // after round r, lane q holds lane src's pair of block 4g + q
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int send = (q + r) & 3, src = (q - r) & 3;
        const uint32_t out = send == 0 ? v[h][0] : send == 1 ? v[h][1]
                             : send == 2 ? v[h][2] : v[h][3];
        const uint32_t got = __shfl_sync(0xffffffffu, out, (lane & ~3) | src);
        w[0] = src == 0 ? got : w[0];
        w[1] = src == 1 ? got : w[1];
        w[2] = src == 2 ? got : w[2];
        w[3] = src == 3 ? got : w[3];
      }
      const int row = row0 + 8 * h;
      if (row < M && col < N)   // N % 8 == 0: the 8 columns are all in
        *reinterpret_cast<uint4*>(C + (int64_t)row * N + col) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The tile's epilogue: one instantiation per act, chosen once per tile.
template <int BN>
__device__ __forceinline__ void sm90_epilogue(
    const float* acc, int row0, int n0, int M, int N,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ C,
    int act) {
  switch (act) {
    case kRelu:
      sm90_store_tile<BN, kRelu>(acc, row0, n0, M, N, bias, C);
      break;
    case kRelu2:
      sm90_store_tile<BN, kRelu2>(acc, row0, n0, M, N, bias, C);
      break;
    case kSilu:
      sm90_store_tile<BN, kSilu>(acc, row0, n0, M, N, bias, C);
      break;
    case kGelu:
      sm90_store_tile<BN, kGelu>(acc, row0, n0, M, N, bias, C);
      break;
    default:
      sm90_store_tile<BN, kNone>(acc, row0, n0, M, N, bias, C);
  }
}

// The persistent warp-specialised GEMM.  The producer and both consumer
// warpgroups walk the same output tiles t = blockIdx.x + i * gridDim.x, the
// N tile fastest when n_fastest is set and the M tile otherwise, and the
// ring's stage and phase run on from one tile to the next.
template <int BN>
__global__ void __launch_bounds__(kSmThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ C, int M, int N, int K,
                 int act, int n_fastest) {
  using Cfg = Sm90Cfg<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  // a 128-byte swizzle atom is 8 rows of 128 bytes: align the ring to 1 KB
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * Cfg::kStageBytes);
  uint64_t* empty = full + S;

  const int m_tiles = (M + kSmBM - 1) / kSmBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_steps = (K + kSmBK - 1) / kSmBK;
  const int tiles = m_tiles * n_tiles;
  auto decode = [&](int t, int& m0, int& n0) {
    m0 = (n_fastest ? t / n_tiles : t % m_tiles) * kSmBM;
    n0 = (n_fastest ? t % n_tiles : t / m_tiles) * BN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        decode(t, m0, n0);
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[s], phase ^ 1);   // the first round passes
          uint8_t* st = ring + s * Cfg::kStageBytes;
          mbar_expect_tx(&full[s], Cfg::kStageBytes);
          tma_load_2d(st, &tma_a, &full[s], ks * kSmBK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(st + kABytes + c * kBoxBytes, &tma_b, &full[s],
                        n0 + 64 * c, ks * kSmBK);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 * cw .. 64 * cw + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      decode(t, m0, n0);
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[s], phase);
        const uint32_t a = smem_u32(ring + s * Cfg::kStageBytes) + cw * 64 * 128;
        const uint32_t b = smem_u32(ring + s * Cfg::kStageBytes + kABytes);
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSmBK / 16; ++kk)   // A: 32 bytes of K a step
          wgmma<BN>(acc, gmma_desc(a + 32 * kk, 16, 1024),   // B: 16 rows
                    gmma_desc(b + 2048 * kk, kBoxBytes, 1024),
                    (ks > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        fence_acc<BN / 2>(acc);
        wgmma_wait<1>();   // the k-step before this one has retired
        if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      sm90_epilogue<BN>(acc, m0 + 64 * cw + 16 * warp + lane / 4, n0, M, N,
                        bias, C, act);
    }
  }
}

// ---------------------------------------------------------------------------
// wmma: bf16 shapes the sm90 kernel does not take (K or N not a multiple of
// 8, or a base of A or B not 16-byte aligned, or of the bias not 4-byte).
// ---------------------------------------------------------------------------

constexpr int kBfTileK = 32;
constexpr int kBfPadA = kBfTileK + 8;  // smem row strides: multiples of 8
constexpr int kBfPadB = kTileN + 8;    // elements (wmma), and off the banks
constexpr int kWarpM = 64;             // each of the 8 warps: 64 x 32
constexpr int kWarpN = 32;
constexpr int kFragM = kWarpM / 16;    // 4
constexpr int kFragN = kWarpN / 16;    // 2

// One K tile of A (128 x 32) and B (32 x 128) as held in registers between
// the global load and the shared-memory store, one masked element at a time.
struct BfStage {
  __nv_bfloat16 a[16];  // 128*32 = 4096 elements of A, 16 per thread
  __nv_bfloat16 b[16];

  __device__ void load(const __nv_bfloat16* A, const __nv_bfloat16* B,
                       int M, int N, int K, int m0, int n0, int k0) {
    const int t = threadIdx.x;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = t + i * kThreads;
      const int gm = m0 + e / kBfTileK, gk = k0 + e % kBfTileK;
      a[i] = (gm < M && gk < K) ? A[(int64_t)gm * K + gk] : zero;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = t + i * kThreads;
      const int gk = k0 + e / kTileN, gn = n0 + e % kTileN;
      b[i] = (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : zero;
    }
  }

  __device__ void store(__nv_bfloat16 (*As)[kBfPadA],
                        __nv_bfloat16 (*Bs)[kBfPadB]) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = t + i * kThreads;
      As[e / kBfTileK][e % kBfTileK] = a[i];
      Bs[e / kTileN][e % kTileN] = b[i];
    }
  }
};

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ C, int M, int N, int K, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2][kTileM][kBfPadA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kBfTileK][kBfPadB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / (kTileN / kWarpN)) * kWarpM;  // 2 x 4 warps
  const int wn = (warp % (kTileN / kWarpN)) * kWarpN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = (K + kBfTileK - 1) / kBfTileK;
  BfStage next;
  next.load(A, B, M, N, K, m0, n0, 0);
  next.store(As[0], Bs[0]);
  __syncthreads();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) next.load(A, B, M, N, K, m0, n0, (kt + 1) * kBfTileK);
#pragma unroll
    for (int kk = 0; kk < kBfTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(fa[i], &As[cur][wm + i * 16][kk], kBfPadA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[cur][kk][wn + j * 16], kBfPadB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) next.store(As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }

  // Epilogue on the fp32 accumulator: each warp stages one 16x16 fragment
  // at a time; each lane finishes 8 consecutive columns of one row.
  float* st = stage[warp];
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm + i * 16 + r;
      const int gn0 = n0 + wn + j * 16 + c0;
      if (gm < M) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int gn = gn0 + c;
          if (gn < N) {
            float y = st[r * 16 + c0 + c];
            if (bias != nullptr) y += __bfloat162float(bias[gn]);
            C[(int64_t)gm * N + gn] = __float2bfloat16(apply_act(y, act));
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32_edge: IEEE FMAs on the CUDA cores, 8x8 outputs per thread, any fp32
// shape and base.
// ---------------------------------------------------------------------------

constexpr int kF32TileK = 8;
constexpr int kF32Pad = kTileM + 4;

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C,
                int M, int N, int K, int act) {
  // A is stored transposed (k-major) so a thread reads its 8 rows' values
  // for one k from one smem row.
  __shared__ __align__(16) float As[2][kF32TileK][kF32Pad];
  __shared__ __align__(16) float Bs[2][kF32TileK][kF32Pad];

  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // output (ty + 16*i, tx + 16*j)

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // 128*8 = 1024 elements of each tile, 4 per thread
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + i * kThreads;
      const int gm = m0 + e / kF32TileK, gk = k0 + e % kF32TileK;
      ra[i] = (gm < M && gk < K) ? A[(int64_t)gm * K + gk] : 0.0f;
      const int bk = k0 + e / kTileN, bn = n0 + e % kTileN;
      rb[i] = (bk < K && bn < N) ? B[(int64_t)bk * N + bn] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = t + i * kThreads;
      As[buf][e % kF32TileK][e / kF32TileK] = ra[i];
      Bs[buf][e / kTileN][e % kTileN] = rb[i];
    }
  };

  const int k_tiles = (K + kF32TileK - 1) / kF32TileK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) load((kt + 1) * kF32TileK);
#pragma unroll
    for (int k = 0; k < kF32TileK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[cur][k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[cur][k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float y = acc[i][j];
      if (bias != nullptr) y += bias[gn];
      C[(int64_t)gm * N + gn] = apply_act(y, act);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: cp.async K ring, 16-byte fragment reads, f32_plan's tile.
// ---------------------------------------------------------------------------

constexpr int kRingBK = 16;      // K depth of a stage
constexpr int kRingStages = 4;   // 3 tiles in flight beside the one read
constexpr int kRingPadA = 4;     // A rows 80 bytes apart in shared memory

template <int BM, int BN, int TM>
struct RingCfg {
  static constexpr int kWarpsN = BN / 64;             // a warp: 4*TM x 64
  static constexpr int kThreads = 32 * (BM / (4 * TM)) * kWarpsN;
  static constexpr int kAStride = kRingBK + kRingPadA;   // floats
  static constexpr int kAFloats = BM * kAStride;
  static constexpr int kStageFloats = kAFloats + kRingBK * BN;
  static constexpr int kSmem = kRingStages * kStageFloats * 4;
  // 16-byte chunks of a stage, per thread
  static constexpr int kAChunks = BM * kRingBK / 4 / kThreads;
  static constexpr int kBChunks = kRingBK * BN / 4 / kThreads;
  static_assert(BM % (4 * TM) == 0 && BN % 64 == 0, "warp tiles");
  static_assert(kAChunks * kThreads * 4 == BM * kRingBK &&
                kBChunks * kThreads * 4 == kRingBK * BN, "whole chunks");
};

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The tile's epilogue for one act: thread rows row0 + 4i (i < TM), columns
// col0 + {0..3} (acc[i][0..3]) and col0 + 32 + {0..3} (acc[i][4..7]);
// N % 4 == 0, so a group of 4 is in or out whole.
template <int TM, int ACT>
__device__ __forceinline__ void ring_store_tile(
    const float (*acc)[8], int row0, int col0, int M, int N,
    const float* __restrict__ bias, float* __restrict__ C) {
  float bz[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + (j / 4) * 32 + j % 4;
    bz[j] = (bias != nullptr && col < N) ? bias[col] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + 4 * i;
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 32 * h;
      if (col >= N) continue;
      float4 y;
      y.x = apply_act(acc[i][4 * h] + bz[4 * h], ACT);
      y.y = apply_act(acc[i][4 * h + 1] + bz[4 * h + 1], ACT);
      y.z = apply_act(acc[i][4 * h + 2] + bz[4 * h + 2], ACT);
      y.w = apply_act(acc[i][4 * h + 3] + bz[4 * h + 3], ACT);
      *reinterpret_cast<float4*>(C + (int64_t)row * N + col) = y;
    }
  }
}

// One CTA per BM x BN output tile, the N tile fastest.  Warp w covers rows
// (w / kWarpsN) * 4TM .. +4TM and columns (w % kWarpsN) * 64 .. +64 of the
// tile; lane l (lm = l / 8, ln = l % 8) rows lm + 4i, columns 4ln + {0..3}
// and 32 + 4ln + {0..3}.
template <int BM, int BN, int TM>
__global__ void __launch_bounds__(RingCfg<BM, BN, TM>::kThreads)
gemm_f32_ring_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ bias, float* __restrict__ C,
                     int M, int N, int K, int act) {
  using Cfg = RingCfg<BM, BN, TM>;
  constexpr int S = kRingStages, BK = kRingBK;
  extern __shared__ __align__(16) float ring_smem[];
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / Cfg::kWarpsN) * 4 * TM + lane / 8;
  const int wn = (warp % Cfg::kWarpsN) * 64 + 4 * (lane % 8);

  // copies of K tile kt into stage kt % S; chunks past an edge read nothing
  const int k_tiles = (K + BK - 1) / BK;
  auto load_tile = [&](int kt) {
    float* As = ring_smem + (kt % S) * Cfg::kStageFloats;
    float* Bs = As + Cfg::kAFloats;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < Cfg::kAChunks; ++i) {
      const int c = tid + i * Cfg::kThreads;
      const int r = c / (BK / 4), kc = 4 * (c % (BK / 4));
      const bool in = m0 + r < M && k0 + kc < K;
      cp_async16(smem_u32(As + r * Cfg::kAStride + kc),
                 in ? A + (int64_t)(m0 + r) * K + k0 + kc : A, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < Cfg::kBChunks; ++i) {
      const int c = tid + i * Cfg::kThreads;
      const int r = c / (BN / 4), nc = 4 * (c % (BN / 4));
      const bool in = k0 + r < K && n0 + nc < N;
      cp_async16(smem_u32(Bs + r * BN + nc),
                 in ? B + (int64_t)(k0 + r) * N + n0 + nc : B, in ? 16 : 0);
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < S - 1; ++s) {
    if (s < k_tiles) load_tile(s);
    cp_async_commit();   // one group per tile, empty past the end
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<S - 2>();   // this thread's copies of tile kt have landed
    __syncthreads();          // every thread's have, and every warp is done
                              // with tile kt - 1, whose stage is refilled:
    if (kt + S - 1 < k_tiles) load_tile(kt + S - 1);
    cp_async_commit();
    const float* As = ring_smem + (kt % S) * Cfg::kStageFloats;
    const float* Bs = As + Cfg::kAFloats;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            As + (wm + 4 * i) * Cfg::kAStride + kc);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* brow = Bs + (kc + k) * BN + wn;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y
                           : k == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av, b1.w, acc[i][7]);
        }
      }
    }
  }

  const int row0 = m0 + wm, col0 = n0 + wn;
  switch (act) {
    case kRelu:
      ring_store_tile<TM, kRelu>(acc, row0, col0, M, N, bias, C);
      break;
    case kRelu2:
      ring_store_tile<TM, kRelu2>(acc, row0, col0, M, N, bias, C);
      break;
    case kSilu:
      ring_store_tile<TM, kSilu>(acc, row0, col0, M, N, bias, C);
      break;
    case kGelu:
      ring_store_tile<TM, kGelu>(acc, row0, col0, M, N, bias, C);
      break;
    default:
      ring_store_tile<TM, kNone>(acc, row0, col0, M, N, bias, C);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A bf16 row-major (rows, cols) tensor read in (box_rows, 64) boxes with
// 128-byte swizzle; out-of-bounds elements read as zero.
bool encode_2d(CUtensorMap* map, const void* base, uint64_t rows,
               uint64_t cols, uint32_t box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// One persistent CTA per tile, at most one per SM.
template <int BN>
cudaError_t launch_sm90(const CUtensorMap& ta, const CUtensorMap& tb,
                        const __nv_bfloat16* bias, __nv_bfloat16* C, int M,
                        int N, int K, int act, int n_fastest,
                        cudaStream_t stream) {
  using Cfg = Sm90Cfg<BN>;
  // the SMs, read (and the shared-memory limit set) once per device
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    rc = cudaFuncSetAttribute(gemm_sm90_kernel<BN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg::kSmem);
    if (rc != cudaSuccess) return rc;
    rc = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                dev);
    if (rc != cudaSuccess) return rc;
  }
  const int64_t tiles = ((int64_t)M + kSmBM - 1) / kSmBM
                        * (((int64_t)N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms[dev] ? tiles : sms[dev]);
  gemm_sm90_kernel<BN><<<grid, kSmThreads, Cfg::kSmem, stream>>>(
      ta, tb, bias, C, M, N, K, act, n_fastest);
  return cudaGetLastError();
}

// One CTA per output tile.
template <int BM, int BN, int TM>
cudaError_t launch_ring(const float* a, const float* b, const float* bias,
                        float* C, int M, int N, int K, int act,
                        cudaStream_t stream) {
  using Cfg = RingCfg<BM, BN, TM>;
  // the shared-memory limit, set once per device (above 48 KB it must be)
  static bool set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!set[dev]) {
    rc = cudaFuncSetAttribute(gemm_f32_ring_kernel<BM, BN, TM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg::kSmem);
    if (rc != cudaSuccess) return rc;
    set[dev] = true;
  }
  const int64_t tiles =
      ((int64_t)M + BM - 1) / BM * (((int64_t)N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  gemm_f32_ring_kernel<BM, BN, TM>
      <<<static_cast<int>(tiles), Cfg::kThreads, Cfg::kSmem, stream>>>(
          a, b, bias, C, M, N, K, act);
  return cudaGetLastError();
}

}  // namespace

// The f32_edge and wmma kernels.  dtype: 0 = fp32 (f32_edge), 1 = bf16
// (wmma); blocked_matmul.py sends a call here only where the f32 or sm90
// kernel does not apply.  act: 0 none, 1 relu, 2 relu2, 3 silu, 4 gelu.
// bias may be null.  Launches on `stream` and returns cudaGetLastError().
extern "C" int blocked_matmul_launch(const void* a, const void* b,
                                     const void* bias, void* out, int M,
                                     int N, int K, int dtype, int act,
                                     void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kNone || act > kGelu ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
        act);
  else
    gemm_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

// The sm90 kernel, bf16 only, with the tile width `bn` (64, 128, 192, 256)
// and the tile order (`n_fastest`) that blocked_matmul.py::tile_plan chose,
// on one persistent CTA per tile, at most one per SM.  Needs K % 8 == 0,
// N % 8 == 0, 16-byte aligned a, b and out, and a 4-byte aligned bias.
// Returns cudaGetLastError().
extern "C" int blocked_matmul_sm90_launch(const void* a, const void* b,
                                          const void* bias, void* out, int M,
                                          int N, int K, int act, int bn,
                                          int n_fastest, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8 || act < kNone ||
      act > kGelu || (bn != 64 && bn != 128 && bn != 192 && bn != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = ((int64_t)M + kSmBM - 1) / kSmBM
                        * (((int64_t)N + bn - 1) / bn);
  if (tiles > 0x7fffffff || !aligned(a, 16) || !aligned(b, 16) ||
      !aligned(out, 16) || !aligned(bias, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!encode_2d(&ta, a, M, K, kSmBM) || !encode_2d(&tb, b, K, N, kSmBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bz = static_cast<const __nv_bfloat16*>(bias);
  auto* C = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (bn) {
    case 64:
      rc = launch_sm90<64>(ta, tb, bz, C, M, N, K, act, n_fastest, s);
      break;
    case 128:
      rc = launch_sm90<128>(ta, tb, bz, C, M, N, K, act, n_fastest, s);
      break;
    case 192:
      rc = launch_sm90<192>(ta, tb, bz, C, M, N, K, act, n_fastest, s);
      break;
    default:
      rc = launch_sm90<256>(ta, tb, bz, C, M, N, K, act, n_fastest, s);
  }
  return static_cast<int>(rc);
}

// The f32 kernel, fp32 only, with the tile (bm, bn) that
// blocked_matmul.py::f32_plan chose, 64x128 or 32x64, one CTA per tile.
// Needs K % 4 == 0, N % 4 == 0 and 16-byte aligned a, b and out; bias may be
// null.  Returns cudaGetLastError().
extern "C" int blocked_matmul_f32_launch(const void* a, const void* b,
                                         const void* bias, void* out, int M,
                                         int N, int K, int act, int bm, int bn,
                                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 || K % 4 || act < kNone ||
      act > kGelu || !aligned(a, 16) || !aligned(b, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  const auto* bz = static_cast<const float*>(bias);
  auto* C = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (bm == 64 && bn == 128)
    rc = launch_ring<64, 128, 8>(A, B, bz, C, M, N, K, act, s);
  else if (bm == 32 && bn == 64)
    rc = launch_ring<32, 64, 2>(A, B, bz, C, M, N, K, act, s);
  return static_cast<int>(rc);
}
