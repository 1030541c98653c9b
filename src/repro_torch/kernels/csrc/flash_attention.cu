// Causal / sliding-window / length-masked GQA flash attention for Hopper
// (sm_90a), forward only.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_bhsd, the
// Pallas TPU kernel whose running fp32 (m, l, acc) state lives in VMEM
// scratch across the innermost, sequential kv grid axis.
//
// What it computes, for each batch b, query head h and query row i:
//   kv head   = h / G                      (G = H / K query heads per kv head)
//   s_ij      = (q_i . k_j) * sm_scale     (fp32 sum, then one fp32 multiply)
//   visible   = j < seq_len  [and j <= i if causal]  [and j > i - window if
//               window > 0]; an invisible score is NEG_INF = -0.7 * FLT_MAX
//   online softmax over kv tiles: m' = max(m, max_j s_ij),
//     p_ij = exp(s_ij - m'), alpha = exp(m - m'), both guarded for rows that
//     have seen no visible key yet (m' <= NEG_INF: p = exp(NEG_INF) = 0,
//     alpha = 1), l' = l * alpha + sum_j p_ij,
//     acc' = acc * alpha + p.astype(v.dtype) @ v   (fp32 accumulate)
//   out_i     = (acc / max(l, 1e-20)).astype(q.dtype)
// NEG_INF is finite on purpose: with -inf, exp(-inf - -inf) is NaN.
// Tensors are (B, heads, S, dh) with any element strides whose innermost
// stride is 1 (the wrapper checks them), so both the model layout
// (B, S, H, dh) seen through a transpose and the (B, H, S, dh) layout are
// read in place, with no padded or transposed copy.  Any S >= 1: ragged
// tiles are zero-filled on load and guarded on store.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3):
// a causal launch at smollm-135m's prefill shape (B 8, S 2048, H 9, K 3,
// dh 64, bf16) does 4*B*H*dh*S(S+1)/2 = 38.7 GFLOP of useful matrix work on
// ~50 MB of q, k, v and o: 39 us of tensor-core time against 15 us of HBM
// time, so it is bound by operations, and only a tiled kernel that keeps the
// S x S scores out of device memory can get near that (the plain version
// writes and reads 1.2 GB of fp32 scores per launch).
//
// What this first design does about it: the scores and probabilities never
// leave registers (FlashAttention-2's register reuse: the fp32 S fragment of
// Q.K^T is repacked in place as the bf16 A operand of P.V), kv tiles wholly
// outside the causal / window band or at or past seq_len are skipped (which
// leaves the result unchanged: such a tile has alpha = 1 and p = 0), and the
// heaviest causal q tiles are scheduled first.  The TPU's sequential kv grid
// axis becomes a loop inside the block; the (m, l, acc) scratch becomes
// registers.
//   * bf16: one block of 4 warps per (b, h, 64 query rows); each warp owns
//     16 rows.  K and V tiles of 64 keys go through shared memory (padded
//     rows: conflict-free fragment reads); Q.K^T and P.V run on the tensor
//     cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//   * fp32: one block of 256 threads per (b, h, 64 query rows), 4 threads
//     per row, each owning dh/4 of the row's dims; plain IEEE fp32 FMAs on
//     the CUDA cores (no TF32), K and V tiles of 32 keys in shared memory.
// dh is a template parameter, instantiated for 64 and 128 only.
// The redesign for speed (later work) is FlashAttention-3's Hopper shape:
// TMA loads of K/V into a multi-stage ring under mbarriers, a producer warp,
// wgmma consumer warpgroups ping-ponging softmax against the next product.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libflash_attention.so flash_attention.cu

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kTileQ = 64;  // query rows per block (both dtypes)

// Element strides of the four tensors, each (batch, head, seq); dh has
// stride 1.  Passed by value to the kernels.
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

struct Problem {
  int G, S, kv_end;  // kv_end = min(S, seq_len): keys at or past it are masked
  int causal, window;
  float sm_scale;
};

// A query tile covers rows [q0, q0 + kTileQ).  The kv tiles of size TK
// that hold any key visible from it are [*first, *last).
template <int TK>
__device__ __forceinline__ void kv_tile_range(const Problem& p, int q0,
                                              int* first, int* last) {
  int end = p.kv_end;
  if (p.causal) end = min(end, q0 + kTileQ);  // row q0+63 sees keys <= q0+63
  int start = 0;
  if (p.window > 0) start = max(0, q0 - p.window + 1);  // row q0 sees > q0-window
  *first = start / TK;
  *last = end > start ? (end + TK - 1) / TK : *first;
}

__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  bool ok = kpos < p.kv_end;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kBfWarps = 4;
constexpr int kBfThreads = kBfWarps * 32;
constexpr int kBfTileK = 64;  // keys per kv tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16x16, row):  a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)
//                    a3 = (g+8, 2t+8..)
//   B (16x8, col):   b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):  c0, c1 = (g, 2t..2t+1)  c2, c3 = (g+8, 2t..2t+1)
template <int DH>
__global__ void __launch_bounds__(kBfThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ Q,
                  const __nv_bfloat16* __restrict__ Kp,
                  const __nv_bfloat16* __restrict__ Vp,
                  __nv_bfloat16* __restrict__ O, Strides st, Problem p) {
  constexpr int kPad = DH + 8;        // smem row: 16 B of padding, see header
  constexpr int kDChunks = DH / 16;   // k-steps of Q.K^T
  constexpr int kDTiles = DH / 8;     // n-tiles of P.V
  constexpr int kKTiles = kBfTileK / 8;  // n-tiles of Q.K^T
  constexpr int kVecPerRow = DH / 8;  // uint4 per K/V row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBfTileK][kPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBfTileK][kPad];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const int q0 = qt * kTileQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const __nv_bfloat16* q = Q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* k = Kp + b * st.k[0] + hk * st.k[1];
  const __nv_bfloat16* v = Vp + b * st.v[0] + hk * st.v[1];
  __nv_bfloat16* o = O + b * st.o[0] + h * st.o[1];

  // This warp's 16 query rows as A fragments, straight from global memory.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // the thread's two rows
  uint32_t qf[kDChunks][4];
#pragma unroll
  for (int c = 0; c < kDChunks; ++c) {
    const int d = c * 16 + 2 * t;
    qf[c][0] = r0 < p.S ? *reinterpret_cast<const uint32_t*>(q + r0 * st.q[2] + d) : 0u;
    qf[c][1] = r1 < p.S ? *reinterpret_cast<const uint32_t*>(q + r1 * st.q[2] + d) : 0u;
    qf[c][2] = r0 < p.S ? *reinterpret_cast<const uint32_t*>(q + r0 * st.q[2] + d + 8) : 0u;
    qf[c][3] = r1 < p.S ? *reinterpret_cast<const uint32_t*>(q + r1 * st.q[2] + d + 8) : 0u;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows r0, r1
  float l[2] = {0.0f, 0.0f};        // this thread's share of the running sum

  int kt_first, kt_last;
  kv_tile_range<kBfTileK>(p, q0, &kt_first, &kt_last);
  for (int kt = kt_first; kt < kt_last; ++kt) {
    const int k0 = kt * kBfTileK;
    // K and V tiles -> shared memory; rows at or past kv_end are zero, so a
    // masked p = 0 never meets a non-finite value.
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBfTileK * kVecPerRow; i += kBfThreads) {
      const int row = i / kVecPerRow, col = (i % kVecPerRow) * 8;
      const int kpos = k0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kpos < p.kv_end) {
        kv = *reinterpret_cast<const uint4*>(k + kpos * st.k[2] + col);
        vv = *reinterpret_cast<const uint4*>(v + kpos * st.v[2] + col);
      }
      *reinterpret_cast<uint4*>(&Ks[row][col]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row][col]) = vv;
    }
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows x 64 keys, fp32.
    float s[kKTiles][4];
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) {
        const __nv_bfloat16* kr = &Ks[n * 8 + g][c * 16 + 2 * t];
        mma_bf16(s[n], qf[c], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale, mask, and the online softmax update.
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? r0 : r1;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const float x = s[n][e] * p.sm_scale;
        s[n][e] = visible(p, qpos, kpos) ? x : kNegInf;
        mcur[e / 2] = fmaxf(mcur[e / 2], s[n][e]);
      }
    float alpha[2], mnew[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 1));
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 2));
      mnew[r] = fmaxf(m[r], mcur[r]);
      alpha[r] = mnew[r] <= kNegInf ? 1.0f : __expf(m[r] - mnew[r]);
      m[r] = mnew[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kKTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        // guarded row: p = exp(NEG_INF) = 0
        const float pe = mnew[r] <= kNegInf ? 0.0f : __expf(s[n][e] - mnew[r]);
        s[n][e] = pe;
        l[r] += pe;
      }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P (bf16) . V: the S fragments of key n-tiles 2c and 2c+1 are
    // exactly the A fragment of the k-step over keys [16c, 16c + 16).
#pragma unroll
    for (int c = 0; c < kBfTileK / 16; ++c) {
      const uint32_t pa[4] = {pack_f32x2(s[2 * c][0], s[2 * c][1]),
                              pack_f32x2(s[2 * c][2], s[2 * c][3]),
                              pack_f32x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_f32x2(s[2 * c + 1][2], s[2 * c + 1][3])};
      const int kr = c * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack_bf16x2(Vs[kr][col], Vs[kr + 1][col]);
        const uint32_t b1 = pack_bf16x2(Vs[kr + 8][col], Vs[kr + 9][col]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // Finish: the row sums are spread over the quad; normalise, cast, store.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int d = n * 8 + 2 * t;
    if (r0 < p.S)
      *reinterpret_cast<uint32_t*>(o + r0 * st.o[2] + d) =
          pack_f32x2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (r1 < p.S)
      *reinterpret_cast<uint32_t*>(o + r1 * st.o[2] + d) =
          pack_f32x2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on the CUDA cores, 4 threads per query row.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = kTileQ * 4;
constexpr int kF32TileK = 32;

template <int DH>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ Q, const float* __restrict__ Kp,
                 const float* __restrict__ Vp, float* __restrict__ O,
                 Strides st, Problem p) {
  constexpr int kPer = DH / 4;  // dims per thread: d = part + 4 * i
  constexpr int kVecPerRow = DH / 4;  // float4 per K/V row
  __shared__ __align__(16) float Ks[kF32TileK][DH];
  __shared__ __align__(16) float Vs[kF32TileK][DH];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const int q0 = qt * kTileQ;
  const int row = q0 + threadIdx.x / 4, part = threadIdx.x % 4;

  const float* q = Q + b * st.q[0] + h * st.q[1];
  const float* k = Kp + b * st.k[0] + hk * st.k[1];
  const float* v = Vp + b * st.v[0] + hk * st.v[1];
  float* o = O + b * st.o[0] + h * st.o[1];

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < p.S ? q[row * st.q[2] + part + 4 * i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  int kt_first, kt_last;
  kv_tile_range<kF32TileK>(p, q0, &kt_first, &kt_last);
  for (int kt = kt_first; kt < kt_last; ++kt) {
    const int k0 = kt * kF32TileK;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32TileK * kVecPerRow; i += kF32Threads) {
      const int r = i / kVecPerRow, col = (i % kVecPerRow) * 4;
      const int kpos = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kpos < p.kv_end) {
        kv = *reinterpret_cast<const float4*>(k + kpos * st.k[2] + col);
        vv = *reinterpret_cast<const float4*>(v + kpos * st.v[2] + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();

    float s[kF32TileK];
    float mcur = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32TileK; ++j) {
      float part_sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        part_sum = fmaf(qr[i], Ks[j][part + 4 * i], part_sum);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
      const float x = part_sum * p.sm_scale;
      s[j] = visible(p, row, k0 + j) ? x : kNegInf;
      mcur = fmaxf(mcur, s[j]);
    }
    const float mnew = fmaxf(m, mcur);
    const float alpha = mnew <= kNegInf ? 1.0f : expf(m - mnew);
    m = mnew;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32TileK; ++j) {
      const float pj = mnew <= kNegInf ? 0.0f : expf(s[j] - mnew);
      l += pj;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(pj, Vs[j][part + 4 * i], acc[i]);
    }
  }

  if (row < p.S) {
    const float inv = 1.0f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[row * st.o[2] + part + 4 * i] = acc[i] * inv;
  }
}

template <int DH>
void launch(int dtype, const void* q, const void* k, const void* v, void* o,
            const Strides& st, const Problem& p, dim3 grid, cudaStream_t s) {
  if (dtype == 0)
    flash_f32_kernel<DH><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st, p);
  else
    flash_bf16_kernel<DH><<<grid, kBfThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), st, p);
}

}  // namespace

// q, o: (B, H, S, dh); k, v: (B, K, S, dh), H = G * K; element strides in
// `strides` (12 int64: q, k, v, o, each batch, head, seq; the dh stride is
// 1).  dtype: 0 = fp32, 1 = bf16.  dh: 64 or 128.  seq_len: keys at or past
// it are masked.  window: 0 = none.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int B, int H,
                                      int K, int S, int dh, int seq_len,
                                      int causal, int window, float sm_scale,
                                      int dtype, void* stream) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || S < 1 || seq_len < 0 ||
      window < 0 || (dtype != 0 && dtype != 1) || (dh != 64 && dh != 128) ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  Problem p;
  p.G = H / K;
  p.S = S;
  p.kv_end = seq_len < S ? seq_len : S;
  p.causal = causal != 0;
  p.window = window;
  p.sm_scale = sm_scale;
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    launch<64>(dtype, q, k, v, o, st, p, grid, s);
  else
    launch<128>(dtype, q, k, v, o, st, p, grid, s);
  return static_cast<int>(cudaGetLastError());
}
