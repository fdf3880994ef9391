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
//     -> `cos_flash_block_update` (K9): one ring-attention hop, the
//     forward's online softmax started from and ended in an (m, l, acc)
//     carry in memory (see the section of K9 below).
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
// are left out: p = 0) and any D <= 256 (padded with zeros to 32, 64,
// 128 or 256 in shared memory).
//
// What bounds them on the H100: operations.  At (BH, T, D) = (64, 2048,
// 64), causal, the forward does 34.4 GFLOP (two products over half the
// T^2 scores), dq 51.5 and dk/dv 68.7 (together about 120 GFLOP),
// against 134-200 MB of operands and results: about 250 operations per
// byte moved, above the ~20 at which the card's f32 units (67 TFLOP/s
// outside the tensor cores) and the ~150 at which its TF32 tensor cores
// (495 TFLOP/s) stop waiting on its 3.35 TB/s.
//
// K6, K7 and K8 run all their products on the tensor cores (`mma.sync`,
// 3xTF32 for f32 inputs, bf16 for bf16 inputs, f32 accumulators) and
// stream the other side's tiles with `cp.async` in a two-stage ring; the
// section of K6, K7 and K8 below has the details.  Under 3xTF32 the
// forward's 34.4 GFLOP cost at least 0.208 ms at 495 TFLOP/s, K7 + K8's
// 120 GFLOP at least 0.73 ms.
//
// K9 is a simple SIMT kernel (its redesign is later work):
//   * a block of 128 threads owns a 64-row query tile and streams the
//     key tiles through shared memory, so every score and probability
//     stays on chip: no T^2 matrix touches device memory, as on the TPU;
//   * each product is a register-blocked f32 FMA loop: a thread owns an
//     8 x 4 piece of the 64 x 64 score tile (and 8 x D/16 of the output
//     tile) and reads both operands as float4 from tiles stored with the
//     reduction index outermost;
//   * the 16 lanes that share a row reduce its max and sum by warp
//     shuffles; P goes back through shared memory, transposed, to feed
//     the second product;
//   * math is f32 for f32 and bf16 inputs alike (bf16 is converted on
//     load); exp and log are the accurate expf/logf.
//
// Common to all four:
//   * no atomics: every output tile has one owner block (K6, K7 and K9
//     own query rows, K8 key rows and, at D > 128, half of the columns),
//     so all are deterministic, as the TPU split is;
//   * causal blocks stop at (K6, K7) or start from (K8) the diagonal,
//     the TPU kernels' skip, and the grid hands out the longest rows
//     first so the short ones fill the tail.
//
// Shared memory is dynamic (cudaFuncSetAttribute above 48 KB); the
// sizes of K6, K7 and K8 follow from `FwdTiles` and `BwdTiles` below
// (at most 200 KB, f32 at D = 256), K9's from `fwd_smem` (67 KB at
// D <= 64, 117 KB at 128, 217 KB at 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
// K6, K7 and K8 on the tensor cores.
//
// Each block has 4 warps; a warp owns one or two 16-row m-tiles of the
// block's tile (FwdTiles, BwdTiles below) and computes its rows of every
// product with `mma.sync` (m16n8k8 tf32 for f32 inputs, m16n8k16 bf16
// for bf16 inputs, f32 accumulators).  The operands that stream past the owned
// tile sit in a two-stage ring of dynamic shared memory, filled by
// 16-byte `cp.async` copies (zero-filled past T and past D); the next
// tile's copies are issued before the current tile's products.  Rows
// are padded by 16 bytes (4 floats, 8 bf16), so the fragment loads
// below hit 32 distinct banks.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k8 / m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   C (16 x 8)  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   tf32 A (16 x 8): (g, t) (g+8, t) (g, t+4) (g+8, t+4); B (8 x 8):
//     (t, g) (t+4, g)
//   bf16 A (16 x 16): pairs (g, 2t..2t+1) (g+8, 2t..) (g, 2t+8..)
//     (g+8, 2t+8..); B (16 x 8): pairs (2t..2t+1, g) (2t+8..2t+9, g)
// The second product of each pair (P V in K6; dS K; P^T dO, dS^T Q)
// takes its A operand straight from the first product's C registers.  In bf16 the C
// layout of two n-tiles is the A layout of one k-step.  In tf32 it is
// not, so the reduction index is permuted: A's column t stands for key
// (or query) 2t of the k-step and column t+4 for 2t+1, and the B loads
// read the same rows (`load_bt`).  A product's sum does not depend on
// the order of its reduction index, so nothing else changes.
//
// Precision: f32 inputs go through 3xTF32: each operand x is split into
// big = tf32(x) and small = tf32(x - big) (round to nearest), and a
// product is small*big + big*small + big*big, which keeps about f32's
// accuracy where one tf32 product keeps three digits.  bf16 inputs (Q,
// K, V, dO) are exact in bf16, so Q K^T and dO V^T are one bf16 product
// each; P and dS are f32 values and enter their products as a bf16 high
// part plus a bf16 remainder (two products), about 16 bits of mantissa.
//
// K6 reads its bf16 fragments with `ldmatrix` (one instruction loads the
// A fragment, or the B fragments of two n-tiles; `.trans` for V, whose
// rows are the reduction index), and keeps the Q fragments in registers
// for the whole key loop where they fit (bf16 at D <= 128: 4 D/16
// registers an m-tile).  Its f32 fragments are split as they are loaded
// (`frag_*` fall back to the scalar loads), Q's anew for every key tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R) of one head's (T, D) matrix into a shared tile of row
// stride LD in the input type, zero past T and past D (up to DP).  With
// `vec` (rows a whole number of 16-byte chunks, 16-byte aligned) the
// copies are asynchronous; otherwise element by element.
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void load_rows(T* s, const T* __restrict__ g,
                                          int r0, int Tn, int D, int vec) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = DP / EPC;
  if (vec) {
    for (int idx = threadIdx.x; idx < R * CPR; idx += kThreads) {
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      const bool ok = r0 + r < Tn && c < D;
      cp_async16(s + r * LD + c, ok ? g + (int64_t)(r0 + r) * D + c : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const bool ok = r0 + r < Tn && d < D;
      s[r * LD + d] = ok ? g[(int64_t)(r0 + r) * D + d] : T(0.f);
    }
  }
}

// the nearest tf32 value of x, as f32 bits (low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rn(x);
  small = tf32_rn(x - __uint_as_float(big));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragment loads and products of one input type.  `AS` is an A
// operand read from shared memory, `AR` one built from C registers, `B`
// a B operand; `load_bn` reads B[k][n] = tile[n][k] (the other side's
// rows, e.g. K in Q K^T) and `load_bt` B[k][n] = tile[k][n] (its
// columns, e.g. K in dS K).
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int KS = 8;   // reduction depth of one mma
  static constexpr int LDP = 4;  // row padding, elements
  struct Frag {
    uint32_t big[4], small[4];
  };
  using AS = Frag;
  using AR = Frag;
  struct B {
    uint32_t big[2], small[2];
  };
  __device__ static void load_a(AS& a, const float* s, int ld, int r, int k,
                                int g, int t) {
    const float* p = s + (r + g) * ld + k + t;
    split_tf32(p[0], a.big[0], a.small[0]);
    split_tf32(p[8 * ld], a.big[1], a.small[1]);
    split_tf32(p[4], a.big[2], a.small[2]);
    split_tf32(p[8 * ld + 4], a.big[3], a.small[3]);
  }
  __device__ static void load_bn(B& b, const float* s, int ld, int n, int k,
                                 int g, int t) {
    const float* p = s + (n + g) * ld + k + t;
    split_tf32(p[0], b.big[0], b.small[0]);
    split_tf32(p[4], b.big[1], b.small[1]);
  }
  __device__ static void load_bt(B& b, const float* s, int ld, int k, int n,
                                 int g, int t) {
    const float* p = s + (k + 2 * t) * ld + n + g;  // permuted rows
    split_tf32(p[0], b.big[0], b.small[0]);
    split_tf32(p[ld], b.big[1], b.small[1]);
  }
  // k-step j of a row of C tiles (8 columns each): tile j, permuted
  __device__ static void a_from_c(AR& a, const float (*c)[4], int j) {
    split_tf32(c[j][0], a.big[0], a.small[0]);
    split_tf32(c[j][2], a.big[1], a.small[1]);
    split_tf32(c[j][1], a.big[2], a.small[2]);
    split_tf32(c[j][3], a.big[3], a.small[3]);
  }
  __device__ static void mma(float (&c)[4], const Frag& a, const B& b) {
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.big, b.big);
  }
  // K6's loads: the fragments above, B two n-tiles at a time
  __device__ static void frag_a(AS& a, const float* s, int ld, int r, int k,
                                int lane) {
    load_a(a, s, ld, r, k, lane >> 2, lane & 3);
  }
  __device__ static void frag_bn2(B (&b)[2], const float* s, int ld, int n,
                                  int k, int lane) {
    load_bn(b[0], s, ld, n, k, lane >> 2, lane & 3);
    load_bn(b[1], s, ld, n + 8, k, lane >> 2, lane & 3);
  }
  __device__ static void frag_bt2(B (&b)[2], const float* s, int ld, int k,
                                  int n, int lane) {
    load_bt(b[0], s, ld, k, n, lane >> 2, lane & 3);
    load_bt(b[1], s, ld, k, n + 8, lane >> 2, lane & 3);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int KS = 16;
  static constexpr int LDP = 8;
  struct AS {
    uint32_t x[4];
  };
  struct AR {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t x[2];
  };
  __device__ static uint32_t word(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static uint32_t pair(const __nv_bfloat16* p, int ld) {
    const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
    return (uint32_t)u[0] | ((uint32_t)u[ld] << 16);
  }
  __device__ static void load_a(AS& a, const __nv_bfloat16* s, int ld, int r,
                                int k, int g, int t) {
    const __nv_bfloat16* p = s + (r + g) * ld + k + 2 * t;
    a.x[0] = word(p);
    a.x[1] = word(p + 8 * ld);
    a.x[2] = word(p + 8);
    a.x[3] = word(p + 8 * ld + 8);
  }
  __device__ static void load_bn(B& b, const __nv_bfloat16* s, int ld, int n,
                                 int k, int g, int t) {
    const __nv_bfloat16* p = s + (n + g) * ld + k + 2 * t;
    b.x[0] = word(p);
    b.x[1] = word(p + 8);
  }
  __device__ static void load_bt(B& b, const __nv_bfloat16* s, int ld, int k,
                                 int n, int g, int t) {
    const __nv_bfloat16* p = s + (k + 2 * t) * ld + n + g;
    b.x[0] = pair(p, ld);
    b.x[1] = pair(p + 8 * ld, ld);
  }
  // k-step j of a row of C tiles: tiles 2j and 2j + 1, high and remainder
  __device__ static void split_pair(float x0, float x1, uint32_t& hi,
                                    uint32_t& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
    hi = (uint32_t)__bfloat16_as_ushort(h0) |
         ((uint32_t)__bfloat16_as_ushort(h1) << 16);
    lo = bf16_pair(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
  }
  __device__ static void a_from_c(AR& a, const float (*c)[4], int j) {
    split_pair(c[2 * j][0], c[2 * j][1], a.hi[0], a.lo[0]);
    split_pair(c[2 * j][2], c[2 * j][3], a.hi[1], a.lo[1]);
    split_pair(c[2 * j + 1][0], c[2 * j + 1][1], a.hi[2], a.lo[2]);
    split_pair(c[2 * j + 1][2], c[2 * j + 1][3], a.hi[3], a.lo[3]);
  }
  __device__ static void mma(float (&c)[4], const AS& a, const B& b) {
    mma_bf16(c, a.x, b.x);
  }
  __device__ static void mma(float (&c)[4], const AR& a, const B& b) {
    mma_bf16(c, a.lo, b.x);
    mma_bf16(c, a.hi, b.x);
  }
  // K6's loads by ldmatrix: lane l gives the row address of 8 x 8 matrix
  // l / 8 and receives its (l / 4, 2 (l % 4)) pair of every matrix, which
  // is the fragment layout above (`.trans`: the (2 (l % 4), l / 4) pair)
  __device__ static void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
  __device__ static void ldsm4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
  // matrices: rows r / r+8 / r / r+8, columns k / k / k+8 / k+8
  __device__ static void frag_a(AS& a, const __nv_bfloat16* s, int ld,
                                int r, int k, int lane) {
    const int i = lane >> 3;
    ldsm4(a.x, s + (r + (i & 1) * 8 + (lane & 7)) * ld + k + (i >> 1) * 8);
  }
  // tile[n][k]: matrices (n, k) (n, k+8) (n+8, k) (n+8, k+8)
  __device__ static void frag_bn2(B (&b)[2], const __nv_bfloat16* s, int ld,
                                  int n, int k, int lane) {
    const int i = lane >> 3;
    uint32_t r[4];
    ldsm4(r, s + (n + (i >> 1) * 8 + (lane & 7)) * ld + k + (i & 1) * 8);
    b[0].x[0] = r[0];
    b[0].x[1] = r[1];
    b[1].x[0] = r[2];
    b[1].x[1] = r[3];
  }
  // tile[k][n], transposed: matrices (k, n) (k+8, n) (k, n+8) (k+8, n+8)
  __device__ static void frag_bt2(B (&b)[2], const __nv_bfloat16* s, int ld,
                                  int k, int n, int lane) {
    const int i = lane >> 3;
    uint32_t r[4];
    ldsm4_t(r, s + (k + (i & 1) * 8 + (lane & 7)) * ld + n + (i >> 1) * 8);
    b[0].x[0] = r[0];
    b[0].x[1] = r[1];
    b[1].x[0] = r[2];
    b[1].x[1] = r[3];
  }
};

// The reduction depth of one partial sum of the score products: f32
// inputs at D > 128 sum Q K^T and dO V^T in groups of 64 (see the tile
// shapes below); everything else in one chain.
constexpr int score_group(bool f32, int dp) {
  return f32 && dp > 128 ? 64 : dp;
}

// s = p (first group) or s += p, elementwise over one warp's C tiles
template <int MT, int NT>
__device__ __forceinline__ void add_group(float (&s)[MT][NT][4],
                                          const float (&p)[MT][NT][4],
                                          bool first) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[m][j][e] = first ? p[m][j][e] : s[m][j][e] + p[m][j][e];
}

// ---------------------------------------------------------------------------
// Tile shapes of K6, K7 and K8.  A warp owns MT m-tiles (16 rows each),
// so every B fragment it loads from shared memory feeds MT products.
// f32 inputs at D <= 64 take MT = 2 (a block owns 128 rows; by
// chip_smoke.py on an H100, K7 + K8 6-10 % faster than with MT = 1, whose
// 3xTF32 fragments are split anew for every product); bf16 inputs and
// D >= 128 take MT = 1 (64 rows), where two m-tiles need smaller
// streamed tiles to fit the registers (the accumulators alone take D
// floats an m-tile), and the extra tile steps cost bf16 more than the
// shared loads save (11 % slower with MT = 2).
//
// D = 256 (D in 129..256, padded): one m-tile a warp, and streamed
// tiles of 16 (f32) or 32 (bf16) rows, so that two stages of them
// beside the resident 64 rows fit 227 KB (f32 K7: 4 B x 2 x (64 + 2 x
// 16) x 260 = 200 KB).  K8 cannot hold dK and dV of a 16-row m-tile in
// registers there (2 x 16 x 256 f32 over 32 lanes is 256 registers a
// lane), so it splits the D columns of its accumulators over grid.z:
// each of two blocks owns the same 64 keys and half of dK's and dV's
// columns, and both compute the full S^T and dP^T (their reduction runs
// over all of D).  The split costs those two products twice (1.5x K8's
// operations) but no extra shared memory, no second warp layout and no
// exchange between warps; splitting over two warps of one block would
// save the recomputation's loads of Q and dO but needs 8 warps and an
// exchange of P^T and dS^T, or the same recomputation inside the block.
//
// Also at D = 256 in f32, the score products (S and dP; S^T and dP^T)
// sum their reduction over D in groups of GK = 64: each group's mma
// chain starts from zero registers and is added to the scores by f32
// adds.  The tensor cores' f32 accumulation does not round to nearest,
// and one chain over all 256 (3 x 32 mma steps) drifted dq and dk past
// FLASH_GRAD_ATOL on a few elements of (16, 2048, 256) on an H100,
// where shorter chains stayed inside it; groups of 64 kept most of that
// accuracy for a few per cent of time, shorter groups cost more time
// than they gained accuracy (chip_smoke.py reports each D = 256 check's
// error against a float64 reference beside the plain version's).
// ---------------------------------------------------------------------------

template <typename TI, int DP>
struct BwdTiles {
  static constexpr bool kF32 = sizeof(TI) == 4;
  static constexpr bool kTwoTiles = kF32 && DP <= 64;
  static constexpr int MT = kTwoTiles ? 2 : 1;         // m-tiles a warp
  static constexpr int ROWS = 4 * 16 * MT;             // rows a block owns
  static constexpr int DQ_KEYS =                       // K7's key tile
      kTwoTiles ? 32 : (DP <= 128 ? 64 : (kF32 ? 16 : 32));
  static constexpr int DKV_QUERIES =                   // K8's query tile
      kTwoTiles ? 16 : (DP <= 64 ? 64 : (DP <= 128 || !kF32 ? 32 : 16));
  static constexpr int DKV_SPLIT = DP > 128 ? 2 : 1;   // K8's grid.z
  static constexpr int GK = score_group(kF32, DP);
};

// K6: f32 at D <= 64 two m-tiles a warp and 32-key tiles (three blocks
// an SM), f32 at D = 128 32-key tiles (two an SM); bf16 64-key tiles at
// D <= 128; 32-key tiles at D = 256 (f32 one block an SM, bf16 two).
template <typename TI, int DP>
struct FwdTiles {
  static constexpr bool kF32 = sizeof(TI) == 4;
  static constexpr int MT = kF32 && DP <= 64 ? 2 : 1;
  static constexpr int ROWS = 4 * 16 * MT;
  static constexpr int KEYS = kF32 || DP > 128 ? 32 : 64;
  static constexpr bool kQRegs = !kF32 && DP <= 128;  // Q in registers
  static constexpr int GK = score_group(kF32, DP);
};

template <typename TI, int DP>
constexpr size_t fwd_mma_smem() {
  using S = FwdTiles<TI, DP>;
  return sizeof(TI) * (S::ROWS + 4 * S::KEYS) * (DP + Mma<TI>::LDP);
}

// ---------------------------------------------------------------------------
// K6: forward.  grid (BH, ceil(T / ROWS)); a block owns ROWS query rows
// (Q resident) and walks the key tiles (K and V, two stages) up to the
// diagonal.  Per key tile a warp computes its rows of S = Q K^T in C
// registers, runs the online softmax on them (the 4 lanes of a quad
// share a row: its max and sum by two xor shuffles), rescales its O
// accumulators by corr and adds P V with P's registers as the A operand.
// O = acc / l and lse = m + log l are written by the owner block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename TI, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                 const TI* __restrict__ v, TI* __restrict__ o,
                 float* __restrict__ lse, int Tn, int D, float scale,
                 int causal, int vec) {
  using M = Mma<TI>;
  using S = FwdTiles<TI, DP>;
  constexpr int LD = DP + M::LDP;
  constexpr int MT = S::MT;
  constexpr int BR = S::ROWS;  // query rows a block
  constexpr int BC = S::KEYS;  // keys a tile
  constexpr int NT = BC / 8;   // n-tiles of S
  constexpr int ND = DP / 8;   // n-tiles of O
  constexpr int KQ = S::kQRegs ? DP / M::KS : 1;
  extern __shared__ float4 smem4[];
  TI* qs = reinterpret_cast<TI*>(smem4);  // [BR][LD] queries
  TI* ks = qs + BR * LD;                  // [2][BC][LD] keys
  TI* vs = ks + 2 * BC * LD;              // [2][BC][LD] values
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16 * MT;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const int q_end = min(Tn, q0 + BR);
  const int n_tiles = ((causal ? q_end : Tn) + BC - 1) / BC;

  load_rows<TI, BR, DP, LD>(qs, q + head, q0, Tn, D, vec);
  load_rows<TI, BC, DP, LD>(ks, k + head, 0, Tn, D, vec);
  load_rows<TI, BC, DP, LD>(vs, v + head, 0, Tn, D, vec);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNeg;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  typename M::AS aq[MT][KQ];  // Q's fragments, where kQRegs

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BC;
    const int buf = it & 1;
    __syncthreads();  // every warp is done with the other stage
    if (it + 1 < n_tiles) {
      load_rows<TI, BC, DP, LD>(ks + (buf ^ 1) * BC * LD, k + head, k0 + BC,
                                Tn, D, vec);
      load_rows<TI, BC, DP, LD>(vs + (buf ^ 1) * BC * LD, v + head, k0 + BC,
                                Tn, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copies (all but the newest group)
    __syncthreads();
    const TI* kt = ks + buf * BC * LD;
    const TI* vt = vs + buf * BC * LD;
    if constexpr (S::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kq = 0; kq < KQ; ++kq)
            M::frag_a(aq[mt][kq], qs, LD, rw + 16 * mt, kq * M::KS, lane);
      }
    }

    // S = Q K^T
    float s[MT][NT][4];
#pragma unroll
    for (int kg = 0; kg < DP; kg += S::GK) {
      float ps[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = kg; kk < kg + S::GK; kk += M::KS) {
        typename M::AS a[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (S::kQRegs)
            a[mt] = aq[mt][kk / M::KS];
          else
            M::frag_a(a[mt], qs, LD, rw + 16 * mt, kk, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename M::B b[2];
          M::frag_bn2(b, kt, LD, 8 * j, kk, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            M::mma(ps[mt][j], a[mt], b[0]);
            M::mma(ps[mt][j + 1], a[mt], b[1]);
          }
        }
      }
      add_group(s, ps, kg == 0);
    }
    // the online softmax of rows g and g + 8 of each m-tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + rw + 16 * mt + g + 8 * h;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + 2 * t + e;
            float x = s[mt][j][2 * h + e] * scale;
            if (c >= Tn) x = -INFINITY;  // past the end: no contribution
            else if (causal && r < c) x = kNeg;
            s[mt][j][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = quad_max(mx);
        const float m_new = fmaxf(m[mt][h], mx);
        const float m_safe = m_new <= kNeg * 0.5f ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[mt][j][2 * h + e] - m_safe);
            s[mt][j][2 * h + e] = p;
            sum += p;
          }
        sum = quad_sum(sum);
        const float corr = expf(m[mt][h] - m_safe);
        l[mt][h] = l[mt][h] * corr + sum;
        m[mt][h] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[mt][n][2 * h] *= corr;
          acc[mt][n][2 * h + 1] *= corr;
        }
      }
    // O += P V
#pragma unroll
    for (int j = 0; j < BC / M::KS; ++j) {
      typename M::AR a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) M::a_from_c(a[mt], s[mt], j);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        typename M::B b[2];
        M::frag_bt2(b, vt, LD, j * M::KS, 8 * n, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          M::mma(acc[mt][n], a[mt], b[0]);
          M::mma(acc[mt][n + 1], a[mt], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + rw + 16 * mt + g + 8 * h;
      if (r >= Tn) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * t + e;
          if (d < D)
            store(o + head + (int64_t)r * D + d,
                  acc[mt][n][2 * h + e] / l[mt][h]);
        }
      if (t == 0)
        lse[(int64_t)blockIdx.x * Tn + r] = m[mt][h] + logf(l[mt][h]);
    }
}

// ---------------------------------------------------------------------------
// K7: dq.  grid (BH, ceil(T / ROWS)); a block owns ROWS query rows (Q and
// dO resident) and walks the key tiles (K and V, two stages) up to the
// diagonal.  Per key tile a warp computes its rows of S = Q K^T and
// dP = dO V^T, then dS, then dQ += dS K from dS's registers.
// ---------------------------------------------------------------------------

template <typename TI, int DP>
constexpr size_t dq_smem() {
  using S = BwdTiles<TI, DP>;
  return sizeof(TI) * 2 * (S::ROWS + 2 * S::DQ_KEYS) * (DP + Mma<TI>::LDP);
}

template <typename TI, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                    const TI* __restrict__ v, const TI* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, TO* __restrict__ dq,
                    int Tn, int D, float scale, int causal, int vec) {
  using M = Mma<TI>;
  using S = BwdTiles<TI, DP>;
  constexpr int LD = DP + M::LDP;
  constexpr int MT = S::MT;
  constexpr int BR = S::ROWS;     // query rows a block
  constexpr int BC = S::DQ_KEYS;  // keys a tile
  constexpr int NT = BC / 8;      // n-tiles of S
  constexpr int ND = DP / 8;      // n-tiles of dQ
  extern __shared__ float4 smem4[];
  TI* qs = reinterpret_cast<TI*>(smem4);  // [BR][LD] queries
  TI* dos = qs + BR * LD;                 // [BR][LD] dO
  TI* ks = dos + BR * LD;                 // [2][BC][LD] keys
  TI* vs = ks + 2 * BC * LD;              // [2][BC][LD] values
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16 * MT;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const int q_end = min(Tn, q0 + BR);
  const int n_tiles = ((causal ? q_end : Tn) + BC - 1) / BC;

  load_rows<TI, BR, DP, LD>(qs, q + head, q0, Tn, D, vec);
  load_rows<TI, BR, DP, LD>(dos, dout + head, q0, Tn, D, vec);
  load_rows<TI, BC, DP, LD>(ks, k + head, 0, Tn, D, vec);
  load_rows<TI, BC, DP, LD>(vs, v + head, 0, Tn, D, vec);
  cp_async_commit();

  float lr[MT][2], dr[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + rw + 16 * m + g + 8 * h;
      lr[m][h] = r < Tn ? lse[row0 + r] : 0.f;
      dr[m][h] = r < Tn ? delta[row0 + r] : 0.f;
    }
  float acc[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BC;
    const int buf = it & 1;
    __syncthreads();  // every warp is done with the other stage
    if (it + 1 < n_tiles) {
      load_rows<TI, BC, DP, LD>(ks + (buf ^ 1) * BC * LD, k + head, k0 + BC,
                                Tn, D, vec);
      load_rows<TI, BC, DP, LD>(vs + (buf ^ 1) * BC * LD, v + head, k0 + BC,
                                Tn, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copies (all but the newest group)
    __syncthreads();
    const TI* kt = ks + buf * BC * LD;
    const TI* vt = vs + buf * BC * LD;

    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int kg = 0; kg < DP; kg += S::GK) {
      float ps[MT][NT][4], pdp[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[m][j][e] = pdp[m][j][e] = 0.f;
#pragma unroll
      for (int kk = kg; kk < kg + S::GK; kk += M::KS) {
        typename M::AS aq[MT], ado[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          M::load_a(aq[m], qs, LD, rw + 16 * m, kk, g, t);
          M::load_a(ado[m], dos, LD, rw + 16 * m, kk, g, t);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          typename M::B bk, bv;
          M::load_bn(bk, kt, LD, 8 * j, kk, g, t);
          M::load_bn(bv, vt, LD, 8 * j, kk, g, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            M::mma(ps[m][j], aq[m], bk);
            M::mma(pdp[m][j], ado[m], bv);
          }
        }
      }
      add_group(s, ps, kg == 0);
      add_group(dp, pdp, kg == 0);
    }
    // p = exp(s scale - lse), dS = p (dP - delta) scale, into s
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + rw + 16 * m + g + 8 * (e >> 1);
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          float x = s[m][j][e] * scale;
          if (causal && r < c) x = kNeg;
          const float p = c < Tn ? expf(x - lr[m][e >> 1]) : 0.f;
          s[m][j][e] = p * (dp[m][j][e] - dr[m][e >> 1]) * scale;
        }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BC / M::KS; ++j) {
      typename M::AR a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) M::a_from_c(a[m], s[m], j);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        typename M::B b;
        M::load_bt(b, kt, LD, j * M::KS, 8 * n, g, t);
#pragma unroll
        for (int m = 0; m < MT; ++m) M::mma(acc[m][n], a[m], b);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + rw + 16 * m + g + 8 * (e >> 1);
        const int d = 8 * n + 2 * t + (e & 1);
        if (r < Tn && d < D)
          store(dq + head + (int64_t)r * D + d, acc[m][n][e]);
      }
}

// ---------------------------------------------------------------------------
// K8: dk and dv.  grid (BH, ceil(T / ROWS)); a block owns ROWS key rows (K
// and V resident) and walks the query tiles (Q, dO, lse and delta, two
// stages) from the diagonal.  A warp computes the transposed scores of
// its keys, S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T are the
// A operands of dV += P^T dO and dK += dS^T Q in its own registers.  At
// D > 128 block z of grid.z = 2 owns columns [z DP/2, (z+1) DP/2) of dK
// and dV (BwdTiles).
// ---------------------------------------------------------------------------

template <typename TI, int DP>
constexpr size_t dkv_smem() {
  using S = BwdTiles<TI, DP>;
  return sizeof(TI) * 2 * (S::ROWS + 2 * S::DKV_QUERIES) *
             (DP + Mma<TI>::LDP) +
         sizeof(float) * 4 * S::DKV_QUERIES;
}

template <typename TI, typename TO, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                     const TI* __restrict__ v, const TI* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, TO* __restrict__ dk,
                     TO* __restrict__ dv, int Tn, int D, float scale,
                     int causal, int vec) {
  using M = Mma<TI>;
  using S = BwdTiles<TI, DP>;
  constexpr int LD = DP + M::LDP;
  constexpr int MT = S::MT;
  constexpr int BK = S::ROWS;         // key rows a block
  constexpr int BQ = S::DKV_QUERIES;  // queries a tile
  constexpr int NT = BQ / 8;          // n-tiles of S^T
  constexpr int DH = DP / S::DKV_SPLIT;  // columns of dK, dV a block
  constexpr int ND = DH / 8;          // n-tiles of dK, dV
  extern __shared__ float4 smem4[];
  TI* ks = reinterpret_cast<TI*>(smem4);  // [BK][LD] keys
  TI* vs = ks + BK * LD;                  // [BK][LD] values
  TI* qs = vs + BK * LD;                  // [2][BQ][LD] queries
  TI* dos = qs + 2 * BQ * LD;             // [2][BQ][LD] dO
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ] lse
  float* dls = ls + 2 * BQ;                                 // [2][BQ] delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16 * MT;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int d0 = blockIdx.z * DH;        // the block's dK, dV columns
  const int k0 = blockIdx.y * BK;        // causal: the first keys see most
  const int q_begin = causal ? k0 : 0;   // earlier queries see none of them
  const int n_tiles = (Tn - q_begin + BQ - 1) / BQ;

  auto load_stage = [&](int stage, int q0) {
    load_rows<TI, BQ, DP, LD>(qs + stage * BQ * LD, q + head, q0, Tn, D, vec);
    load_rows<TI, BQ, DP, LD>(dos + stage * BQ * LD, dout + head, q0, Tn, D,
                              vec);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool ok = q0 + i < Tn;
      cp_async4(ls + stage * BQ + i, ok ? lse + row0 + q0 + i : lse, ok);
      cp_async4(dls + stage * BQ + i, ok ? delta + row0 + q0 + i : delta, ok);
    }
  };
  load_rows<TI, BK, DP, LD>(ks, k + head, k0, Tn, D, vec);
  load_rows<TI, BK, DP, LD>(vs, v + head, k0, Tn, D, vec);
  load_stage(0, q_begin);
  cp_async_commit();

  float gk[MT][ND][4], gv[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[m][n][e] = gv[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    const int buf = it & 1;
    __syncthreads();
    if (it + 1 < n_tiles) load_stage(buf ^ 1, q0 + BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const TI* qt = qs + buf * BQ * LD;
    const TI* dot = dos + buf * BQ * LD;
    const float* lt = ls + buf * BQ;
    const float* dlt = dls + buf * BQ;

    float st[MT][NT][4], dpt[MT][NT][4];  // [key][query]
#pragma unroll
    for (int kg = 0; kg < DP; kg += S::GK) {
      float ps[MT][NT][4], pdp[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[m][j][e] = pdp[m][j][e] = 0.f;
#pragma unroll
      for (int kk = kg; kk < kg + S::GK; kk += M::KS) {
        typename M::AS ak[MT], av[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          M::load_a(ak[m], ks, LD, rw + 16 * m, kk, g, t);
          M::load_a(av[m], vs, LD, rw + 16 * m, kk, g, t);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          typename M::B bq, bdo;
          M::load_bn(bq, qt, LD, 8 * j, kk, g, t);
          M::load_bn(bdo, dot, LD, 8 * j, kk, g, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            M::mma(ps[m][j], ak[m], bq);
            M::mma(pdp[m][j], av[m], bdo);
          }
        }
      }
      add_group(st, ps, kg == 0);
      add_group(dpt, pdp, kg == 0);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + rw + 16 * m + g + 8 * (e >> 1);
          const int rl = 8 * j + 2 * t + (e & 1);
          float x = st[m][j][e] * scale;
          if (causal && q0 + rl < c) x = kNeg;
          const float p = q0 + rl < Tn ? expf(x - lt[rl]) : 0.f;
          st[m][j][e] = p;
          dpt[m][j][e] = p * (dpt[m][j][e] - dlt[rl]) * scale;
        }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BQ / M::KS; ++j) {
      typename M::AR ap[MT], ads[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        M::a_from_c(ap[m], st[m], j);
        M::a_from_c(ads[m], dpt[m], j);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        typename M::B bdo, bq;
        M::load_bt(bdo, dot, LD, j * M::KS, d0 + 8 * n, g, t);
        M::load_bt(bq, qt, LD, j * M::KS, d0 + 8 * n, g, t);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          M::mma(gv[m][n], ap[m], bdo);
          M::mma(gk[m][n], ads[m], bq);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + rw + 16 * m + g + 8 * (e >> 1);
        const int d = d0 + 8 * n + 2 * t + (e & 1);
        if (c < Tn && d < D) {
          store(dk + head + (int64_t)c * D + d, gk[m][n][e]);
          store(dv + head + (int64_t)c * D + d, gv[m][n][e]);
        }
      }
}

// ---------------------------------------------------------------------------
// K9: one ring hop.  grid (BH, ceil(Tq / 64)); a block owns 64 query rows
// of the fixed shard and walks the visiting block's key tiles.
//
// It is the forward's online softmax as a SIMT kernel (`load_tile`,
// `tile_mma`), with three changes from the forward: the (m, l, acc)
// carry is read from memory at the start and written back at the end
// (no acc / l, no lse); the causal test uses the blocks' global offsets,
// q_off + r >= k_off + c, passed as plain int arguments (scalar prefetch
// on the TPU); and Tq and Tk may differ.  What bounds it is operations,
// as for K6: at the LM's per-rank shape (64, 512, 512, 64) a full hop is
// 4.3 GFLOP of f32 FMA against ~42 MB of operands and carry, ~100
// operations per byte.  At D = 256 its tiles take 217 KB of shared
// memory (one block an SM) and a thread's acc is 8 x 16 floats.
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

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * DP * kLdT + kRows * DP + kRows * kLdT);
}

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

dim3 grid_for(int BH, int Tn, int rows = kRows) {
  return dim3(BH, (Tn + rows - 1) / rows);
}

// 16-byte copies need rows of whole 16-byte chunks and aligned bases
template <typename TI>
int vec_ok(int D, const void* q, const void* k, const void* v,
           const void* dout) {
  if ((D * sizeof(TI)) % 16) return 0;
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <typename T, int DP>
int fwd_launch(const void* q, const void* k, const void* v, void* o,
               float* lse, int BH, int Tn, int D, float scale, int causal,
               cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, DP>;
  constexpr size_t smem = fwd_mma_smem<T, DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tn, FwdTiles<T, DP>::ROWS), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tn, D, scale,
      causal, vec_ok<T>(D, q, k, v, q));
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int DP>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int Tn,
              int D, float scale, int causal, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<TI, TO, DP>;
  constexpr size_t smem = dq_smem<TI, DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid_for(BH, Tn, BwdTiles<TI, DP>::ROWS), kThreads, smem, s>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TI*>(dout), lse, delta,
      static_cast<TO*>(dq), Tn, D, scale, causal,
      vec_ok<TI>(D, q, k, v, dout));
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int DP>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int BH, int Tn, int D, float scale, int causal,
               cudaStream_t s) {
  auto kern = flash_bwd_dkv_kernel<TI, TO, DP>;
  constexpr size_t smem = dkv_smem<TI, DP>();
  int err = prepare(kern, smem);
  if (err) return err;
  dim3 grid = grid_for(BH, Tn, BwdTiles<TI, DP>::ROWS);
  grid.z = BwdTiles<TI, DP>::DKV_SPLIT;
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TI*>(dout), lse, delta,
      static_cast<TO*>(dk), static_cast<TO*>(dv), Tn, D, scale, causal,
      vec_ok<TI>(D, q, k, v, dout));
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
  if (BH <= 0 || Tn <= 0 || D <= 0 || D > 256 ||
      (Tn + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// D -> the padded width the kernels are compiled for
template <template <int> class Fn, typename... Args>
int by_width(int D, Args... args) {
  if (D <= 32) return Fn<32>::run(args...);
  if (D <= 64) return Fn<64>::run(args...);
  if (D <= 128) return Fn<128>::run(args...);
  return Fn<256>::run(args...);
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
