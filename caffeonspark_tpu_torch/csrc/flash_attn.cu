// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a).
//
// Replaces (caffeonspark_tpu/ops/pallas_kernels.py):
//   * `_flash_fwd_call` (kernel `_flash_fwd_kernel`)      -> `cos_flash_fwd`
//     (K6): O and the row log-sum-exp of softmax(Q K^T * scale) V;
//   * `flash_bwd_block`, its dq call (`_flash_bwd_dq_kernel`)
//     -> `cos_flash_bwd_dq` (K7);
//   * `flash_bwd_block`, its dk/dv call (`_flash_bwd_dkv_kernel`)
//     -> `cos_flash_bwd_dkv` (K8);
//   * `flash_block_update` (kernel `_flash_carry_kernel`)
//     -> `cos_flash_block_update` (K9): one ring-attention hop, K6's
//     loop started from and ended in an (m, l, acc) carry in memory
//     (see the section of K9 below).
//
// q, k, v, dO are (BH, T, D) row-major, f32 or bf16; lse and delta are
// (BH, T) f32.  scale = 1/sqrt(D).  With `causal`, key c is visible to
// query r when r >= c; a hidden score is the TPU kernels' finite -1e30,
// and the forward keeps their m_safe guard, so the arithmetic is theirs:
//   forward   m' = max(m, rowmax s), m_safe = (m' <= -5e29 ? 0 : m'),
//             p = exp(s - m_safe), corr = exp(m - m_safe),
//             l = l corr + rowsum p, acc = acc corr + p V;
//             O = acc / l, lse = m + log l
//   backward  p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale,
//             dq = ds K, dv = p^T dO, dk = ds^T q.
// Any T >= 1 (the ragged tail of a tile is zero-filled, and its keys
// are left out: p = 0) and any D <= 128 (padded with zeros to 32, 64 or
// 128 in shared memory).
//
// What bounds it on the H100: operations.  At (BH, T, D) = (64, 2048,
// 64), causal, the forward does 34.4 GFLOP (two products over half the
// T^2 scores), dq 51.5 and dk/dv 68.7, against 134-200 MB of operands
// and results: about 250 f32 operations per byte moved, far above the
// ~20 at which the card's f32 units (67 TFLOP/s outside the tensor
// cores) stop waiting on its 3.35 TB/s.
//
// What the design does about it (a first, simple SIMT kernel; wgmma and
// TMA are later work):
//   * a block of 128 threads owns a 64-row tile (queries for K6/K7, keys
//     for K8) and streams the other side's tiles through shared memory,
//     so every score, probability and dS stays on chip: no T^2 matrix
//     touches device memory, as on the TPU;
//   * each product is a register-blocked f32 FMA loop: a thread owns an
//     8 x 4 piece of the 64 x 64 score tile (8 x 2 of K8's 64 x 32, and
//     8 x D/16 of the output tile) and reads both operands as float4
//     from tiles stored with the reduction index outermost, so a step is
//     2-3 vector loads for 16-32 FMAs and the loads are conflict-free or
//     broadcasts;
//   * the 16 lanes that share a row reduce its max and sum by warp
//     shuffles; P (and dS) go back through shared memory, transposed,
//     to feed the next product;
//   * no atomics: every output tile has one owner block (K7 walks key
//     tiles for its queries, K8 query tiles for its keys), so all three
//     are deterministic, as the TPU split is;
//   * causal blocks stop at (K6, K7) or start from (K8) the diagonal,
//     the TPU kernels' skip, and the grid hands out the longest rows
//     first so the short ones fill the tail;
//   * math is f32 for f32 and bf16 inputs alike (bf16 is converted on
//     load; results are rounded with __float2bfloat16_rn); exp and log
//     are the accurate expf/logf.
//
// Shared memory is dynamic (cudaFuncSetAttribute above 48 KB): K6 67 KB
// at D <= 64 (117 KB at 128), K7 101 KB (185 KB), K8 85 KB (153 KB).
// K8 walks 32-row query tiles: with 64-row tiles it needed 134 KB at
// D = 64, so only one block fitted an SM (PERF.md has both times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // 8 row groups (ty) x 16 lanes (tx)
constexpr int kRows = 64;        // rows of the tile a block owns
constexpr int kLdT = kRows + 4;  // row stride of a 64-wide transposed tile
constexpr float kNeg = -1e30f;   // the TPU kernels' finite mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N contiguous floats from shared memory (16-byte aligned for N % 4 == 0,
// 8-byte for N == 2)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 t = reinterpret_cast<const float4*>(p)[u];
      r[4 * u] = t.x;
      r[4 * u + 1] = t.y;
      r[4 * u + 2] = t.z;
      r[4 * u + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) r[u] = p[u];
  }
}

// One thread's TM x TN piece of a tile product whose operands are stored
// reduction-index outermost:  c[i][j] += sum_k a[k * lda + i] * b[k * ldb + j]
template <int K, int TM, int TN>
__device__ __forceinline__ void tile_mma(const float* a, int lda,
                                         const float* b, int ldb,
                                         float (&c)[TM][TN]) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float ar[TM], br[TN];
    load_vec<TM>(a + kk * lda, ar);
    load_vec<TN>(b + kk * ldb, br);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fmaf(ar[i], br[j], c[i][j]);
  }
}

// max / sum over the 16 lanes (tx) that hold one row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [r0, r0 + R) of one head's (T, D) matrix into shared memory as f32,
// zero past T and past D (up to DP): transposed `t[d * ld + r]` and/or
// natural `n[r * DP + d]` (either may be null).  Global reads run along D.
template <typename T, int R, int DP>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int r0,
                                          int Tn, int D, float* t, int ld,
                                          float* n) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float v = 0.f;
    if (r0 + r < Tn && d < D) v = to_f32(g[(int64_t)(r0 + r) * D + d]);
    if (t) t[d * ld + r] = v;
    if (n) n[idx] = v;
  }
}

// x[i][j] of one thread's 8 x TN piece -> shared tile s, transposed:
// s[(col0 + j) * kLdT + row0 + i] (two float4 stores per column)
template <int TN>
__device__ __forceinline__ void store_t(float* s, int row0, int col0,
                                        const float (&x)[8][TN]) {
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float4* dst = reinterpret_cast<float4*>(s + (col0 + j) * kLdT + row0);
    dst[0] = make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    dst[1] = make_float4(x[4][j], x[5][j], x[6][j], x[7][j]);
  }
}

// ---------------------------------------------------------------------------
// K6: forward.  grid (BH, ceil(T / 64)); a block owns 64 query rows.
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * DP * kLdT + kRows * DP + kRows * kLdT);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tn, int D, float scale,
                 int causal) {
  constexpr int TD = DP / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][kLdT] queries
  float* kt = qt + DP * kLdT;                   // [DP][kLdT] keys
  float* vs = kt + DP * kLdT;                   // [kRows][DP] values
  float* pt = vs + kRows * DP;                  // [kRows][kLdT] P, key-major
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first

  load_tile<T, kRows, DP>(q + head, q0, Tn, D, qt, kLdT, nullptr);
  float m[8], l[8], acc[8][TD];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  const int q_end = min(Tn, q0 + kRows);
  const int kv_end = causal ? q_end : Tn;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kRows, DP>(k + head, k0, Tn, D, kt, kLdT, nullptr);
    load_tile<T, kRows, DP>(v + head, k0, Tn, D, nullptr, 0, vs);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_mma<DP, 8, 4>(qt + ty * 8, kLdT, kt + tx * 4, kLdT, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + ty * 8 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (c >= Tn) x = -INFINITY;  // past the end: no contribution
        else if (causal && r < c) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNeg * 0.5f ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_safe);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    store_t<4>(pt, ty * 8, tx * 4, s);
    __syncthreads();
    tile_mma<kRows, 8, TD>(pt + ty * 8, kLdT, vs + tx * TD, DP, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx * TD + j;
      if (d < D) store(o + head + (int64_t)r * D + d, acc[i][j] / l[i]);
    }
    if (tx == 0) lse[(int64_t)blockIdx.x * Tn + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// K7: dq.  grid (BH, ceil(T / 64)); a block owns 64 query rows and walks
// the key tiles up to the diagonal.
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * DP * kLdT + kRows * DP + kRows * kLdT);
}

template <typename TI, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                    const TI* __restrict__ v, const TI* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, TO* __restrict__ dq,
                    int Tn, int D, float scale, int causal) {
  constexpr int TD = DP / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][kLdT] queries
  float* dot = qt + DP * kLdT;                  // [DP][kLdT] dO
  float* kt = dot + DP * kLdT;                  // [DP][kLdT] keys
  float* vt = kt + DP * kLdT;                   // [DP][kLdT] values
  float* ks = vt + DP * kLdT;                   // [kRows][DP] keys
  float* dst = ks + kRows * DP;                 // [kRows][kLdT] dS, key-major
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;

  load_tile<TI, kRows, DP>(q + head, q0, Tn, D, qt, kLdT, nullptr);
  load_tile<TI, kRows, DP>(dout + head, q0, Tn, D, dot, kLdT, nullptr);
  float lr[8], dr[8], acc[8][TD];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    lr[i] = r < Tn ? lse[row0 + r] : 0.f;
    dr[i] = r < Tn ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  const int q_end = min(Tn, q0 + kRows);
  const int kv_end = causal ? q_end : Tn;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();
    load_tile<TI, kRows, DP>(k + head, k0, Tn, D, kt, kLdT, ks);
    load_tile<TI, kRows, DP>(v + head, k0, Tn, D, vt, kLdT, nullptr);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<DP, 8, 4>(qt + ty * 8, kLdT, kt + tx * 4, kLdT, s);
    tile_mma<DP, 8, 4>(dot + ty * 8, kLdT, vt + tx * 4, kLdT, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && r < c) x = kNeg;
        const float p = c < Tn ? expf(x - lr[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dr[i]) * scale;
      }
    }
    store_t<4>(dst, ty * 8, tx * 4, s);
    __syncthreads();
    tile_mma<kRows, 8, TD>(dst + ty * 8, kLdT, ks + tx * TD, DP, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx * TD + j;
      if (d < D) store(dq + head + (int64_t)r * D + d, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K8: dk and dv.  grid (BH, ceil(T / 64)); a block owns 64 key rows and
// walks the query tiles, kDkvRows rows each, from the diagonal.
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 32;

template <int DP>
constexpr size_t dkv_smem() {
  constexpr int BN = kDkvRows;
  return sizeof(float) * (2 * DP * kLdT + 2 * DP * (BN + 4) + 2 * BN * DP +
                          2 * BN * kLdT + 2 * BN);
}

template <typename TI, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                     const TI* __restrict__ v, const TI* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, TO* __restrict__ dk,
                     TO* __restrict__ dv, int Tn, int D, float scale,
                     int causal) {
  constexpr int TD = DP / 16;
  constexpr int BN = kDkvRows;
  constexpr int TN = BN / 16;
  constexpr int LDN = BN + 4;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DP][kLdT] keys
  float* vt = kt + DP * kLdT;                   // [DP][kLdT] values
  float* qt = vt + DP * kLdT;                   // [DP][LDN] queries
  float* dot = qt + DP * LDN;                   // [DP][LDN] dO
  float* qs = dot + DP * LDN;                   // [BN][DP] queries
  float* dos = qs + BN * DP;                    // [BN][DP] dO
  float* ps = dos + BN * DP;                    // [BN][kLdT] P, query-major
  float* dss = ps + BN * kLdT;                  // [BN][kLdT] dS, query-major
  float* ls = dss + BN * kLdT;                  // [BN] lse
  float* dls = ls + BN;                         // [BN] delta
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int k0 = blockIdx.y * kRows;  // causal: the first keys see most

  load_tile<TI, kRows, DP>(k + head, k0, Tn, D, kt, kLdT, nullptr);
  load_tile<TI, kRows, DP>(v + head, k0, Tn, D, vt, kLdT, nullptr);
  float gk[8][TD], gv[8][TD];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) gk[i][j] = gv[i][j] = 0.f;
  // causal: query tiles ending before k0 see only hidden scores
  for (int q0 = causal ? k0 : 0; q0 < Tn; q0 += BN) {
    __syncthreads();
    load_tile<TI, BN, DP>(q + head, q0, Tn, D, qt, LDN, qs);
    load_tile<TI, BN, DP>(dout + head, q0, Tn, D, dot, LDN, dos);
    for (int r = threadIdx.x; r < BN; r += kThreads) {
      const bool in = q0 + r < Tn;
      ls[r] = in ? lse[row0 + q0 + r] : 0.f;
      dls[r] = in ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[8][TN], dpt[8][TN];  // [key][query]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_mma<DP, 8, TN>(kt + ty * 8, kLdT, qt + tx * TN, LDN, st);
    tile_mma<DP, 8, TN>(vt + ty * 8, kLdT, dot + tx * TN, LDN, dpt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = k0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int rl = tx * TN + j;
        float x = st[i][j] * scale;
        if (causal && q0 + rl < c) x = kNeg;
        const float p = q0 + rl < Tn ? expf(x - ls[rl]) : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dls[rl]) * scale;
      }
    }
    store_t<TN>(ps, ty * 8, tx * TN, st);
    store_t<TN>(dss, ty * 8, tx * TN, dpt);
    __syncthreads();
    tile_mma<BN, 8, TD>(ps + ty * 8, kLdT, dos + tx * TD, DP, gv);
    tile_mma<BN, 8, TD>(dss + ty * 8, kLdT, qs + tx * TD, DP, gk);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = k0 + ty * 8 + i;
    if (c >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx * TD + j;
      if (d < D) {
        store(dk + head + (int64_t)c * D + d, gk[i][j]);
        store(dv + head + (int64_t)c * D + d, gv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9: one ring hop.  grid (BH, ceil(Tq / 64)); a block owns 64 query rows
// of the fixed shard and walks the visiting block's key tiles.
//
// It is K6 with three changes: the (m, l, acc) carry is read from memory
// at the start and written back at the end (no acc / l, no lse); the
// causal test uses the blocks' global offsets, q_off + r >= k_off + c,
// passed as plain int arguments (scalar prefetch on the TPU); and Tq and
// Tk may differ.  What bounds it is what bounds K6: at the LM's per-rank
// shape (64, 512, 512, 64) a full hop is 4.3 GFLOP of f32 FMA against
// ~42 MB of operands and carry, ~100 operations per byte.
//
// The TPU kernel walks every key tile, so a row whose keys in this hop
// are all hidden leaves with m' = max(m, -1e30): -1e30 where it came in
// at -inf (the ring's first carry), with l and acc unchanged (corr =
// exp(-inf - 0) = 0 multiplies zeros).  This kernel skips the tiles past
// the causal edge, as K6 does, and writes max(m, -1e30) for a causal hop
// instead, which gives the same m' for every row: a row that processed a
// tile saw a score >= -1e30 there.  m_safe is finite in every processed
// tile (each holds a key < Tk, visible or -1e30), so exp(m - m_safe) is
// exp(-inf) = 0, never NaN, for a row that has seen nothing yet.
// The outputs are separate buffers (the wrapper allocates them).
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_carry_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   const float* __restrict__ acc_in,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out, int Tq, int Tk, int D,
                   float scale, int q_off, int k_off, int causal) {
  constexpr int TD = DP / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][kLdT] queries
  float* kt = qt + DP * kLdT;                   // [DP][kLdT] keys
  float* vs = kt + DP * kLdT;                   // [kRows][DP] values
  float* pt = vs + kRows * DP;                  // [kRows][kLdT] P, key-major
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qhead = (int64_t)blockIdx.x * Tq * D;
  const int64_t khead = (int64_t)blockIdx.x * Tk * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first

  load_tile<T, kRows, DP>(q + qhead, q0, Tq, D, qt, kLdT, nullptr);
  float m[8], l[8], acc[8][TD];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    const bool in = r < Tq;
    m[i] = in ? m_in[row0 + r] : kNeg;  // rows past Tq are never stored
    l[i] = in ? l_in[row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx * TD + j;
      acc[i][j] = in && d < D ? acc_in[qhead + (int64_t)r * D + d] : 0.f;
    }
  }
  const int q_end = min(Tq, q0 + kRows);
  // causal: keys c with k_off + c > q_off + q_end - 1 are hidden from
  // every row of the tile
  const int kv_end = causal ? max(0, min(Tk, q_off + q_end - k_off)) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kRows, DP>(k + khead, k0, Tk, D, kt, kLdT, nullptr);
    load_tile<T, kRows, DP>(v + khead, k0, Tk, D, nullptr, 0, vs);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_mma<DP, 8, 4>(qt + ty * 8, kLdT, kt + tx * 4, kLdT, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q_off + q0 + ty * 8 + i;  // global positions
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (c >= Tk) x = -INFINITY;  // past the end: no contribution
        else if (causal && r < k_off + c) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNeg * 0.5f ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_safe);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    store_t<4>(pt, ty * 8, tx * 4, s);
    __syncthreads();
    tile_mma<kRows, 8, TD>(pt + ty * 8, kLdT, vs + tx * TD, DP, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx * TD + j;
      if (d < D) acc_out[qhead + (int64_t)r * D + d] = acc[i][j];
    }
    if (tx == 0) {
      m_out[row0 + r] = causal ? fmaxf(m[i], kNeg) : m[i];
      l_out[row0 + r] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_for(int BH, int Tn) { return dim3(BH, (Tn + kRows - 1) / kRows); }

template <typename T, int DP>
int fwd_launch(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int Tn, int D, float scale, int causal,
               cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, DP>;
  constexpr size_t smem = fwd_smem<DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tn), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tn, D, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int DP>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int Tn,
              int D, float scale, int causal, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<TI, TO, DP>;
  constexpr size_t smem = dq_smem<DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tn), kThreads, smem, s>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TI*>(dout), lse, delta,
      static_cast<TO*>(dq), Tn, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int DP>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int BH, int Tn, int D, float scale, int causal,
               cudaStream_t s) {
  auto kern = flash_bwd_dkv_kernel<TI, TO, DP>;
  constexpr size_t smem = dkv_smem<DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tn), kThreads, smem, s>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TI*>(dout), lse, delta,
      static_cast<TO*>(dk), static_cast<TO*>(dv), Tn, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int carry_launch(const void* q, const void* k, const void* v,
                 const float* m_in, const float* l_in, const float* acc_in,
                 float* m_out, float* l_out, float* acc_out, int BH, int Tq,
                 int Tk, int D, float scale, int q_off, int k_off,
                 int causal, cudaStream_t s) {
  auto kern = flash_carry_kernel<T, DP>;
  constexpr size_t smem = fwd_smem<DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tq), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m_in, l_in, acc_in, m_out, l_out, acc_out,
      Tq, Tk, D, scale, q_off, k_off, causal);
  return (int)cudaGetLastError();
}

int check_args(int BH, int Tn, int D) {
  if (BH <= 0 || Tn <= 0 || D <= 0 || D > 128 ||
      (Tn + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// D -> the padded width the kernels are compiled for
template <template <int> class Fn, typename... Args>
int by_width(int D, Args... args) {
  if (D <= 32) return Fn<32>::run(args...);
  if (D <= 64) return Fn<64>::run(args...);
  return Fn<128>::run(args...);
}

template <typename T>
struct Fwd {
  template <int DP>
  struct W {
    template <typename... A>
    static int run(A... a) { return fwd_launch<T, DP>(a...); }
  };
};

template <typename TI, typename TO>
struct Dq {
  template <int DP>
  struct W {
    template <typename... A>
    static int run(A... a) { return dq_launch<TI, TO, DP>(a...); }
  };
};

template <typename TI, typename TO>
struct Dkv {
  template <int DP>
  struct W {
    template <typename... A>
    static int run(A... a) { return dkv_launch<TI, TO, DP>(a...); }
  };
};

template <typename T>
struct Carry {
  template <int DP>
  struct W {
    template <typename... A>
    static int run(A... a) { return carry_launch<T, DP>(a...); }
  };
};

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each entry point returns
// cudaGetLastError() of its launch (0 on success), or
// cudaErrorInvalidValue for refused arguments.

// K6: o (BH, T, D) in the input dtype, lse (BH, T) f32.
extern "C" int cos_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int Tn, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  int err = check_args(BH, Tn, D);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_width<Fwd<float>::W>(D, q, k, v, o, lse, BH, Tn, D, scale,
                                   causal, s);
  if (dtype == 1)
    return by_width<Fwd<__nv_bfloat16>::W>(D, q, k, v, o, lse, BH, Tn, D,
                                           scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// K7: dq (BH, T, D) in out_dtype, from q, k, v, dO (in_dtype), lse, delta.
extern "C" int cos_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int BH, int Tn,
                                int D, float scale, int causal, int in_dtype,
                                int out_dtype, void* stream) {
  int err = check_args(BH, Tn, D);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COS_DQ(TI, TO)                                                    \
  return by_width<Dq<TI, TO>::W>(D, q, k, v, dout, lse, delta, dq, BH, Tn, \
                                 D, scale, causal, s)
  if (in_dtype == 0 && out_dtype == 0) COS_DQ(float, float);
  if (in_dtype == 0 && out_dtype == 1) COS_DQ(float, __nv_bfloat16);
  if (in_dtype == 1 && out_dtype == 0) COS_DQ(__nv_bfloat16, float);
  if (in_dtype == 1 && out_dtype == 1) COS_DQ(__nv_bfloat16, __nv_bfloat16);
#undef COS_DQ
  return (int)cudaErrorInvalidValue;
}

// K8: dk, dv (BH, T, D) in out_dtype.
extern "C" int cos_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int BH, int Tn, int D, float scale,
                                 int causal, int in_dtype, int out_dtype,
                                 void* stream) {
  int err = check_args(BH, Tn, D);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COS_DKV(TI, TO)                                                   \
  return by_width<Dkv<TI, TO>::W>(D, q, k, v, dout, lse, delta, dk, dv,   \
                                  BH, Tn, D, scale, causal, s)
  if (in_dtype == 0 && out_dtype == 0) COS_DKV(float, float);
  if (in_dtype == 0 && out_dtype == 1) COS_DKV(float, __nv_bfloat16);
  if (in_dtype == 1 && out_dtype == 0) COS_DKV(__nv_bfloat16, float);
  if (in_dtype == 1 && out_dtype == 1) COS_DKV(__nv_bfloat16, __nv_bfloat16);
#undef COS_DKV
  return (int)cudaErrorInvalidValue;
}

// K9: (m_out, l_out, acc_out) = the (m_in, l_in, acc_in) carry of q (BH, Tq,
// D) with the block k, v (BH, Tk, D) folded in; q, k, v in `dtype`, the
// carry (BH, Tq) / (BH, Tq, D) f32; q_off, k_off the global offsets.
extern "C" int cos_flash_block_update(const void* q, const void* k,
                                      const void* v, const float* m_in,
                                      const float* l_in, const float* acc_in,
                                      float* m_out, float* l_out,
                                      float* acc_out, int BH, int Tq, int Tk,
                                      int D, float scale, int q_off,
                                      int k_off, int causal, int dtype,
                                      void* stream) {
  int err = check_args(BH, Tq, D);
  if (!err) err = check_args(BH, Tk, D);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_width<Carry<float>::W>(D, q, k, v, m_in, l_in, acc_in, m_out,
                                     l_out, acc_out, BH, Tq, Tk, D, scale,
                                     q_off, k_off, causal, s);
  if (dtype == 1)
    return by_width<Carry<__nv_bfloat16>::W>(D, q, k, v, m_in, l_in, acc_in,
                                             m_out, l_out, acc_out, BH, Tq,
                                             Tk, D, scale, q_off, k_off,
                                             causal, s);
  return (int)cudaErrorInvalidValue;
}
