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
// read in place, with no padded or transposed copy.  Any S >= 1.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3):
// a causal launch at smollm-135m's prefill shape (B 8, S 2048, H 9, K 3,
// dh 64, bf16) does 4*B*H*dh*S(S+1)/2 = 38.7 GFLOP of useful matrix work on
// ~50 MB of q, k, v and o: 39 us of tensor-core time against 15 us of HBM
// time, so it is bound by operations.  At dh 64 the softmax weighs as much:
// the same launch takes B*H*S(S+1)/2 = 151 M exponentials, ~37 us on the
// SFUs (16 a clock on each of 132 SMs), so the exponentials of one set of
// rows have to run while the tensor cores work on another.
//
// Three kernels; flash_attention.py::variant picks one by dtype, head dim
// and whether TMA can read the tensors.
//
// sm90 (bf16, dh 64 or 128): FlashAttention-3's shape.
//   * TMA straight from the strided layout: one rank-4 tensor map an
//     operand over (dh, S, heads, B), 64-column boxes with 128-byte swizzle.
//     K and V are encoded with their S extent at kv_end = min(S, seq_len),
//     so keys at or past it arrive as zeros and never meet P.V as non-finite
//     values; Q rows past S arrive as zeros and are not stored.
//   * One producer warp loads the block's Q once, then K and V tiles of 128
//     keys into a ring of 2-4 stages (full and empty mbarriers each for K
//     and for V; stage and phase carried across tiles).
//   * Consumer warpgroups of 64 query rows run both products on wgmma:
//     S = Q.K^T from shared memory (both K-major), O += P.V with P from
//     registers (the fp32 S accumulator repacked to bf16 in place: wgmma's
//     accumulator and register-A layouts match) and V N-major (transpose
//     bit).  Within a warpgroup the P.V of one tile runs under the softmax
//     of the next.
//   * The softmax of one set of rows runs under another's products: at dh
//     64 two blocks of one consumer warpgroup (64-row q tiles) share each
//     SM; at dh 128, where a block's ring does not fit twice, one block
//     holds two warpgroups (128-row q tiles).  The warpgroups issue their
//     products as they are ready: FlashAttention-3's ping-pong (turns on
//     named barriers) and the 128-row tile at dh 64 were slower here, and
//     chip_mutants.py times both beside this kernel.
//   * exp2 with sm_scale * log2(e) folded into one FMA against the running
//     max kept in raw score units; the guard for rows that see no key is
//     kept (their subtrahend is 0, so a masked NEG_INF still gives p = 0).
//   * Only tiles that cross the causal diagonal, the window edge or kv_end
//     are masked element by element (one compare against the row's key
//     range); tiles wholly outside the band are never loaded.  Tiles run
//     from the diagonal down, and the q tile is the slowest grid axis, so
//     every head's heaviest causal tiles are scheduled first.
// mma (bf16, the first design, where sm90 does not apply): one block of 4
//   warps per (b, h, 64 query rows), each warp 16 rows; K and V tiles of 64
//   keys loaded by every thread into padded shared memory, zero past kv_end;
//   mma.sync m16n8k16 with the S fragment reused as P's A operand.
// f32: one block of 256 threads per (b, h, 64 query rows), 4 threads per
//   row, each owning dh/4 of the row's dims; plain IEEE fp32 FMAs on the
//   CUDA cores (no TF32), K and V tiles of 32 keys in shared memory.
// dh is a template parameter, instantiated for 64 and 128 only.
//
// Build (plain C interface, loaded with ctypes; no -lcuda: the tensor-map
// encoder is found through cudaGetDriverEntryPoint):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libflash_attention.so flash_attention.cu

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kTileQ = 64;  // query rows per block of the mma and f32 kernels

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

// A query tile covers rows [q0, q0 + TQ).  The kv tiles of size TK that
// hold any key visible from it are [*first, *last).
template <int TQ, int TK>
__device__ __forceinline__ void kv_tile_range(const Problem& p, int q0,
                                              int* first, int* last) {
  int end = p.kv_end;
  if (p.causal) end = min(end, q0 + TQ);  // row q0+TQ-1 sees keys < q0+TQ
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
// mma (bf16, the first design): mma.sync m16n8k16 on the tensor cores.
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
  kv_tile_range<kTileQ, kBfTileK>(p, q0, &kt_first, &kt_last);
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
// sm90 (bf16): TMA K/V ring, wgmma for Q.K^T and P.V, softmax under the
// products.
// ---------------------------------------------------------------------------

constexpr int kSmBN = 128;          // keys per kv tile
constexpr int kSmRows = 64;         // query rows per consumer warpgroup
constexpr int kSmemLimit = 232448;  // 227 KB per block on an H100
constexpr int kQBox = kSmRows * 128;  // one 64-row x 64-column Q box, 8 KB
constexpr int kKBox = kSmBN * 128;    // one 128-key x 64-column K/V box, 16 KB

// WG consumer warpgroups and one producer warp: 64-row q tiles (WG 1, two
// blocks an SM; dh 64) or 128-row ones (WG 2, one block an SM; dh 128).
template <int DH, int WG>
struct FlashCfg {
  static constexpr int kBM = WG * kSmRows;      // query rows per block
  static constexpr int kChunks = DH / 64;       // 64-column boxes a row
  static constexpr int kQBytes = WG * kChunks * kQBox;
  static constexpr int kTileBytes = kChunks * kKBox;  // one K or V tile
  // as many stages as fit (at most 4) beside the barriers and 1 KB of
  // alignment slack, in a block's share of the SM
  static constexpr int kBudget = kSmemLimit / (3 - WG) - 2048;
  static constexpr int kFit = (kBudget - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kTileBytes + 1024 + 8 * (1 + 4 * kStages);
  static_assert(kStages >= 2, "the ring needs two stages");
};

// Whether any score of the kv tile at k0 is invisible from the rows
// [r0, r0 + 64) of a warpgroup: the tile crosses kv_end, the causal
// diagonal or the window's lower edge.
__device__ __forceinline__ bool tile_needs_mask(const Problem& p, int r0,
                                                int k0) {
  return k0 + kSmBN > p.kv_end || (p.causal && k0 + kSmBN - 1 > r0) ||
         (p.window > 0 && k0 <= r0 + kSmRows - 1 - p.window);
}

// The online-softmax step on one tile's raw scores `sc` (the wgmma
// accumulator: sc[4j + 2r + e] is row `row` + 8r, key k0 + 8j + 2t + e,
// t = lane % 4).  The running max m is kept in raw score units and
// p = 2^(s * c2 - m * c2) with c2 = sm_scale * log2(e); a row that has seen
// no visible key (m <= NEG_INF) takes 0 as its subtrahend, so its masked
// NEG_INF scores give p = 0, and alpha = 1.  Leaves p in sc, updates m and
// this thread's share of l, returns alpha.  The maxima and sums run in four
// independent chains a row.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float* sc, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int row, int k0, const Problem& p,
                                             float c2) {
  const int col = k0 + 2 * (threadIdx.x % 4);  // the thread's first key
  if (kMask) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // row qpos sees keys [lo, hi); as offsets from col, [lo_off, hi_off)
      const int qpos = row + 8 * r;
      const int hi = p.causal ? min(p.kv_end, qpos + 1) : p.kv_end;
      const int lo = p.window > 0 ? qpos - p.window + 1 : 0;
      const int hi_off = hi - col, lo_off = lo - col;
#pragma unroll
      for (int j = 0; j < kSmBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e >= hi_off || 8 * j + e < lo_off)
            sc[4 * j + 2 * r + e] = kNegInf;
    }
  }
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int a = 0; a < 4; ++a) part[r][a] = kNegInf;
#pragma unroll
  for (int j = 0; j < kSmBN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[r][(2 * j + e) % 4] =
            fmaxf(part[r][(2 * j + e) % 4], sc[4 * j + 2 * r + e]);
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
    float mx = fmaxf(fmaxf(m[r], fmaxf(part[r][0], part[r][1])),
                     fmaxf(part[r][2], part[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const bool unseen = mx <= kNegInf;
    sub[r] = unseen ? 0.0f : mx * c2;
    alpha[r] = unseen ? 1.0f : ex2(fmaf(m[r], c2, -sub[r]));
    m[r] = mx;
#pragma unroll
    for (int a = 0; a < 4; ++a) part[r][a] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kSmBN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = ex2(fmaf(x, c2, -sub[r]));
        part[r][(2 * j + e) % 4] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((part[r][0] + part[r][1]) +
                              (part[r][2] + part[r][3]));
}

// O (64 x DH) += P (64 x 128 keys, bf16 A fragments) . V (128 keys x DH,
// N-major at `va`): one wgmma per 16 keys.
template <int DH>
__device__ __forceinline__ void pv_product(float* acc, uint32_t (*pa)[4],
                                           uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < kSmBN / 16; ++kk)
    wgmma_rs<DH>(acc, pa[kk], gmma_desc(va + 2048 * kk, kKBox, 1024), 1);
}

// One block per (h, b, q tile), the heaviest causal tiles first.
// Warpgroups 0..WG-1 are consumers of 64 query rows each; the warp after
// them is the producer.  A producer warp, not a warpgroup, leaves the
// consumers the launch's register cap (setmaxnreg moves registers at run
// time, but ptxas compiles the consumers' code within that cap).
template <int DH, int WG>
__global__ void __launch_bounds__(FlashCfg<DH, WG>::kThreads, 3 - WG)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tma_q,
                  const __grid_constant__ CUtensorMap tma_k,
                  const __grid_constant__ CUtensorMap tma_v,
                  __nv_bfloat16* __restrict__ O, Strides st, Problem p) {
  using Cfg = FlashCfg<DH, WG>;
  constexpr int S = Cfg::kStages;
  constexpr int kChunks = Cfg::kChunks;
  extern __shared__ uint8_t smem_raw[];
  // a 128-byte swizzle atom is 8 rows of 128 bytes: align to 1 KB
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + Cfg::kQBytes;
  uint8_t* vs = ks + S * Cfg::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + S * Cfg::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  // the q tile is the slowest grid axis: every head's heaviest causal tiles
  // are scheduled before any lighter ones
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / p.G;
  const int q0 = qt * Cfg::kBM;
  int kt_first, kt_last;
  kv_tile_range<Cfg::kBM, kSmBN>(p, q0, &kt_first, &kt_last);
  const int n = kt_last - kt_first;  // tiles, taken from kt_last - 1 down

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * WG);  // every consumer warp releases
      mbar_init(&v_empty[s], 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as far as the compiler can see, so the wgmma below sit on
  // no divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == WG) {
    // producer warp: one thread issues every TMA load
    if (threadIdx.x == 128 * WG && n > 0) {
      // Q boxes that start past S are not loaded: their rows are not stored
      uint32_t q_bytes = 0;
      for (int cw = 0; cw < WG; ++cw)
        if (q0 + kSmRows * cw < p.S) q_bytes += kChunks * kQBox;
      mbar_expect_tx(q_full, q_bytes);
      for (int cw = 0; cw < WG; ++cw)
        if (q0 + kSmRows * cw < p.S)
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(qs + (cw * kChunks + c) * kQBox, &tma_q, q_full,
                        64 * c, q0 + kSmRows * cw, h, b);
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n; ++t) {
        const int k0 = (kt_last - 1 - t) * kSmBN;
        mbar_wait(&k_empty[s], phase ^ 1);   // the first round passes
        mbar_expect_tx(&k_full[s], Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(ks + s * Cfg::kTileBytes + c * kKBox, &tma_k, &k_full[s],
                      64 * c, k0, hk, b);
        mbar_wait(&v_empty[s], phase ^ 1);
        mbar_expect_tx(&v_full[s], Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(vs + s * Cfg::kTileBytes + c * kKBox, &tma_v, &v_full[s],
                      64 * c, k0, hk, b);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: rows q0 + 64 * cw .. q0 + 64 * cw + 63
    const int cw = wg;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = q0 + kSmRows * cw;
    const int row = r0 + 16 * warp + lane / 4;  // the thread's rows: +0, +8
    const float c2 = p.sm_scale * 1.4426950408889634f;  // log2(e)
    const uint32_t qa = smem_u32(qs + cw * kChunks * kQBox);
    float sc[kSmBN / 2];          // this tile's scores, then its p in fp32
    float acc[DH / 2];
    uint32_t pa[kSmBN / 16][4];   // p of the tile before, bf16 A fragments
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};  // running max, raw score units
    float l[2] = {0.0f, 0.0f};        // this thread's share of the sum
    float alpha[2];

    // S = Q . K^T (64 x 128) on the K tile in stage st
    auto qk_product = [&](int st) {
      const uint32_t ka = smem_u32(ks + st * Cfg::kTileBytes);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_kk<kSmBN>(
            sc, gmma_desc(qa + (kk / 4) * kQBox + 32 * (kk % 4), 16, 1024),
            gmma_desc(ka + (kk / 4) * kKBox + 32 * (kk % 4), 16, 1024),
            kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    // the softmax of tile t (keys from (kt_last - 1 - t) * 128), then p
    // repacked: the accumulator's layout is wgmma's register-A layout, so
    // keys 16kk..16kk+15 are the score blocks 2kk and 2kk + 1
    auto softmax = [&](int t) {
      const int k0 = (kt_last - 1 - t) * kSmBN;
      if (tile_needs_mask(p, r0, k0))
        softmax_tile<true>(sc, m, l, alpha, row, k0, p, c2);
      else
        softmax_tile<false>(sc, m, l, alpha, row, k0, p, c2);
    };
    auto repack = [&] {
#pragma unroll
      for (int kk = 0; kk < kSmBN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_f32x2(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    };

    if (n > 0) {
      // the first tile: Q . K^T and its softmax (its P . V comes with the
      // next tile's Q . K^T).  The waits for the next K and for this V sit
      // under the products, off the path from one issue to the next.
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      fence_acc<kSmBN / 2>(sc);
      wgmma_fence();
      qk_product(0);
      if (n > 1) mbar_wait(&k_full[1], 0);
      mbar_wait(&v_full[0], 0);
      wgmma_wait<0>();
      fence_acc<kSmBN / 2>(sc);
      if (lane == 0) mbar_arrive(&k_empty[0]);
      softmax(0);
      repack();
      int s = 1, ps = 0;              // stages of this tile and the one before
      uint32_t phase = 0;
      for (int t = 1; t < n; ++t) {
        const int ns = s + 1 == S ? 0 : s + 1;        // the next tile's stage
        const uint32_t nphase = ns == 0 ? phase ^ 1 : phase;
        fence_acc<kSmBN / 2>(sc);
        fence_acc<DH / 2>(acc);
        wgmma_fence();
        qk_product(s);
        pv_product<DH>(acc, pa, smem_u32(vs + ps * Cfg::kTileBytes));
        wgmma_commit();
        if (t + 1 < n) mbar_wait(&k_full[ns], nphase);
        mbar_wait(&v_full[s], phase);
        wgmma_wait<1>();   // Q . K^T has retired; P . V may still run
        fence_acc<kSmBN / 2>(sc);
        if (lane == 0) mbar_arrive(&k_empty[s]);
        softmax(t);
        wgmma_wait<0>();
        fence_acc<DH / 2>(acc);
        fence_regs<kSmBN / 4>(&pa[0][0]);
        if (lane == 0) mbar_arrive(&v_empty[ps]);  // its P . V has retired
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        repack();
        ps = s;
        s = ns;
        phase = nphase;
      }
      // P . V of the last tile
      fence_acc<DH / 2>(acc);
      wgmma_fence();
      pv_product<DH>(acc, pa, smem_u32(vs + ps * Cfg::kTileBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<DH / 2>(acc);
      fence_regs<kSmBN / 4>(&pa[0][0]);
      if (lane == 0) mbar_arrive(&v_empty[ps]);  // the last P . V retired
    }
    // Finish: the row sums are spread over the quad; normalise, cast, store.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / fmaxf(l[r], 1e-20f);
    }
    __nv_bfloat16* o = O + b * st.o[0] + h * st.o[1];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      if (row < p.S)
        *reinterpret_cast<uint32_t*>(o + row * st.o[2] + d) =
            pack_f32x2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      if (row + 8 < p.S)
        *reinterpret_cast<uint32_t*>(o + (row + 8) * st.o[2] + d) =
            pack_f32x2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
    }
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
  kv_tile_range<kTileQ, kF32TileK>(p, q0, &kt_first, &kt_last);
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

// A (B, heads, S, dh) bf16 tensor with element strides (batch, head, seq) as
// a rank-4 tensor map over (dh, extent, heads, B), read in boxes of 64
// columns by `rows` rows with 128-byte swizzle; rows at or past `extent`
// read as zero.  An extent-1 dimension is never stepped over, so it takes a
// stride TMA accepts whatever the tensor's is.
bool encode_bhsd(CUtensorMap* map, const void* base, const int64_t* stride,
                 int B, int heads, int extent, int dh, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(extent),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)  // bytes of the seq, head and batch steps
    strides[i] = dims[i + 1] == 1 ? 16 : static_cast<cuuint64_t>(stride[2 - i]) * 2;
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int DH, int WG>
cudaError_t launch_sm90(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, __nv_bfloat16* o,
                        const Strides& st, const Problem& p, int B, int H,
                        cudaStream_t stream) {
  using Cfg = FlashCfg<DH, WG>;
  static bool ready[kMaxDevices] = {};  // the shared-memory limit, per device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    rc = cudaFuncSetAttribute(flash_sm90_kernel<DH, WG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg::kSmem);
    if (rc != cudaSuccess) return rc;
    ready[dev] = true;
  }
  const dim3 grid(H, B, (p.S + Cfg::kBM - 1) / Cfg::kBM);
  flash_sm90_kernel<DH, WG><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      tq, tk, tv, o, st, p);
  return cudaGetLastError();
}

// The arguments both launchers take, checked and gathered; false if the
// shapes are out of range.
bool make_problem(const int64_t* strides, int B, int H, int K, int S, int dh,
                  int seq_len, int causal, int window, float sm_scale,
                  Strides* st, Problem* p) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || S < 1 || seq_len < 0 ||
      window < 0 || (dh != 64 && dh != 128) || B > 65535 || H > 65535)
    return false;
  for (int i = 0; i < 3; ++i) {
    st->q[i] = strides[i];
    st->k[i] = strides[3 + i];
    st->v[i] = strides[6 + i];
    st->o[i] = strides[9 + i];
  }
  p->G = H / K;
  p->S = S;
  p->kv_end = seq_len < S ? seq_len : S;
  p->causal = causal != 0;
  p->window = window;
  p->sm_scale = sm_scale;
  return true;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

}  // namespace

// q, o: (B, H, S, dh); k, v: (B, K, S, dh), H = G * K; element strides in
// `strides` (12 int64: q, k, v, o, each batch, head, seq; the dh stride is
// 1).  dtype: 0 = fp32 (the f32 kernel), 1 = bf16 (the mma kernel;
// flash_attention.py sends bf16 here only where the sm90 kernel does not
// apply).  dh: 64 or 128.  seq_len: keys at or past it are masked.
// window: 0 = none.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int B, int H,
                                      int K, int S, int dh, int seq_len,
                                      int causal, int window, float sm_scale,
                                      int dtype, void* stream) {
  Strides st;
  Problem p;
  if ((dtype != 0 && dtype != 1) ||
      !make_problem(strides, B, H, K, S, dh, seq_len, causal, window,
                    sm_scale, &st, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    launch<64>(dtype, q, k, v, o, st, p, grid, s);
  else
    launch<128>(dtype, q, k, v, o, st, p, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// The sm90 kernel, bf16 only: 64-row q tiles at dh 64 (two blocks an SM),
// 128-row ones at dh 128 (two warpgroups a block; PERF.md has the times
// behind the choice).  Arguments as flash_attention_launch; q, k and
// v need 16-byte aligned bases and seq / head / batch strides that are
// multiples of 8 elements (TMA's rules), o a 4-byte aligned base.  Returns
// cudaGetLastError().
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           const int64_t* strides, int B,
                                           int H, int K, int S, int dh,
                                           int seq_len, int causal,
                                           int window, float sm_scale,
                                           void* stream) {
  Strides st;
  Problem p;
  if (!make_problem(strides, B, H, K, S, dh, seq_len, causal, window,
                    sm_scale, &st, &p) ||
      (S - 1) / kSmRows >= 65535 || !aligned(q, 16) ||
      !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // K and V end at kv_end, so TMA zero-fills the keys at or past it (an
  // extent of 0 is not encodable; with kv_end 0 no kv tile is loaded)
  const int kv_extent = p.kv_end > 0 ? p.kv_end : 1;
  CUtensorMap tq, tk, tv;
  if (!encode_bhsd(&tq, q, strides, B, H, S, dh, kSmRows) ||
      !encode_bhsd(&tk, k, strides + 3, B, K, kv_extent, dh, kSmBN) ||
      !encode_bhsd(&tv, v, strides + 6, B, K, kv_extent, dh, kSmBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<__nv_bfloat16*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dh == 128)
    rc = launch_sm90<128, 2>(tq, tk, tv, out, st, p, B, H, s);
  else
    rc = launch_sm90<64, 1>(tq, tk, tv, out, st, p, B, H, s);
  return static_cast<int>(rc);
}
