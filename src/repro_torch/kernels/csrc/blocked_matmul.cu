// Fused GEMM + bias + activation for Hopper (sm_90a): out = act(A·B + bias).
//
// Replaces src/repro/kernels/blocked_matmul.py::blocked_matmul, the Pallas TPU
// kernel whose fp32 VMEM accumulator is carried across the sequential K grid
// axis and whose epilogue adds the bias and applies the activation on that
// accumulator before one cast to the output dtype.
//
// What it computes: A (M,K) row-major, B (K,N) row-major, bias (N,) or null,
// out (M,N) row-major, all of one dtype (fp32 or bf16).  The product is
// accumulated in fp32; the bias is added in fp32; act is applied in fp32
// (0 none, 1 relu, 2 relu2 = relu^2, 3 silu = y*sigmoid(y),
// 4 gelu = 0.5*y*(1 + tanh(sqrt(2/pi)*(y + 0.044715*y^3)))); the result is
// cast to the output dtype once.  Any M, N, K >= 1: ragged edges are masked
// inside the kernel (zero-filled loads, guarded stores), so no padded copies
// are made.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3;
// ridge ~295 FLOP/byte): at the DLRM tower's shapes in bf16 (K = N = 4096,
// M = batch) a layer moves 2*(2*M*4096 + 4096^2) bytes for 2*M*4096^2 FLOP.
// At M = 256 that is ~37.7 MB, >= 11 us, memory-bound; from M ~ 345 up it is
// compute-bound (M = 4096: 137 GFLOP, >= 0.139 ms).  The fp32 path runs on
// the CUDA cores (67 TFLOP/s), compute-bound at all but tiny shapes.
//
// What this first design does about it: nothing beyond the fusion itself
// (the activation never makes a round trip through device memory).  One
// thread block owns one 128x128 output tile and loops over K inside the
// block; this loop replaces the TPU's sequential K grid axis, and the fp32
// accumulator lives in registers instead of a VMEM scratch.  A and B tiles
// are staged through double-buffered shared memory, with the next tile
// prefetched into registers while the current one is multiplied.
//   * bf16: tensor cores through nvcuda::wmma (16x16x16, bf16 in, fp32
//     accumulate); 8 warps, each a 64x32 sub-tile.
//   * fp32: plain IEEE fp32 FMAs on the CUDA cores (no TF32), 8x8 outputs
//     per thread.
// The redesign for speed (later work) is the usual Hopper shape: TMA loads
// into a multi-stage shared-memory ring under mbarriers, a producer warp and
// wgmma consumer warpgroups, a persistent grid over output tiles.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libblocked_matmul.so blocked_matmul.cu

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

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

// ---------------------------------------------------------------------------
// bf16: wmma tensor cores, fp32 accumulators.
// ---------------------------------------------------------------------------

constexpr int kBfTileK = 32;
constexpr int kBfPadA = kBfTileK + 8;  // smem row strides: multiples of 8
constexpr int kBfPadB = kTileN + 8;    // elements (wmma), and off the banks
constexpr int kWarpM = 64;             // each of the 8 warps: 64 x 32
constexpr int kWarpN = 32;
constexpr int kFragM = kWarpM / 16;    // 4
constexpr int kFragN = kWarpN / 16;    // 2

// One K tile of A (128 x 32) and B (32 x 128) as held in registers between
// the global load and the shared-memory store.  VEC: 16-byte vectors (K and
// N multiples of 8, 16-byte aligned bases); otherwise single elements.
template <bool VEC>
struct BfStage;

template <>
struct BfStage<true> {
  uint4 a[2];  // 128*32/8 = 512 vectors of A, 2 per thread
  uint4 b[2];  // 32*128/8 = 512 vectors of B, 2 per thread

  __device__ void load(const __nv_bfloat16* A, const __nv_bfloat16* B,
                       int M, int N, int K, int m0, int n0, int k0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = t + i * kThreads;
      const int row = v / (kBfTileK / 8), kc = (v % (kBfTileK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + kc;
      a[i] = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K)
        a[i] = *reinterpret_cast<const uint4*>(A + (int64_t)gm * K + gk);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = t + i * kThreads;
      const int row = v / (kTileN / 8), nc = (v % (kTileN / 8)) * 8;
      const int gk = k0 + row, gn = n0 + nc;
      b[i] = make_uint4(0, 0, 0, 0);
      if (gk < K && gn < N)
        b[i] = *reinterpret_cast<const uint4*>(B + (int64_t)gk * N + gn);
    }
  }

  __device__ void store(__nv_bfloat16 (*As)[kBfPadA],
                        __nv_bfloat16 (*Bs)[kBfPadB]) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = t + i * kThreads;
      *reinterpret_cast<uint4*>(&As[v / (kBfTileK / 8)][(v % (kBfTileK / 8)) * 8]) = a[i];
      *reinterpret_cast<uint4*>(&Bs[v / (kTileN / 8)][(v % (kTileN / 8)) * 8]) = b[i];
    }
  }
};

template <>
struct BfStage<false> {
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

template <bool VEC>
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
  BfStage<VEC> next;
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
// fp32: IEEE FMAs on the CUDA cores, 8x8 outputs per thread.
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  act: 0 none, 1 relu, 2 relu2, 3 silu, 4 gelu.
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
  if (dtype == 0) {
    gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
        act);
  } else {
    const auto* A = static_cast<const __nv_bfloat16*>(a);
    const auto* B = static_cast<const __nv_bfloat16*>(b);
    const auto* bz = static_cast<const __nv_bfloat16*>(bias);
    auto* C = static_cast<__nv_bfloat16*>(out);
    if (K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b))
      gemm_bf16_kernel<true><<<grid, kThreads, 0, s>>>(A, B, bz, C, M, N, K, act);
    else
      gemm_bf16_kernel<false><<<grid, kThreads, 0, s>>>(A, B, bz, C, M, N, K, act);
  }
  return static_cast<int>(cudaGetLastError());
}
