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
//     online softmax started from and ended in an (m, l, acc) carry in
//     memory (see "K6 and K9" below).
// Each has a `_wide` twin for head widths above 256 (see "Wide heads"):
// a second entry point rather than a width argument, because the two
// families hold D differently (compile-time padded tiles against
// run-time slices and column groups over grid.z), so each entry keeps
// its own checks (the padded one still refuses D > 256) and geometry.
//
// q, k, v, dO are (BH, T, D) row-major, f32 or bf16; lse and delta are
// (BH, T) f32.  scale = 1/sqrt(D).  With `causal`, key c is visible to
// query r when r >= c (K9: q_off + r >= k_off + c); a hidden score is the
// TPU kernels' finite -1e30, and the forward keeps their m_safe guard,
// so the arithmetic is theirs:
//   forward   m' = max(m, rowmax s), m_safe = (m' <= -5e29 ? 0 : m'),
//             p = exp(s - m_safe), corr = exp(m - m_safe),
//             l = l corr + rowsum p, acc = acc corr + p V;
//             O = acc / l, lse = m + log l
//   backward  p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale,
//             dq = ds K, dv = p^T dO, dk = ds^T q.
// Any T >= 1 (the ragged tail of a tile is zero-filled, and its keys
// are left out: p = 0) and any D >= 1: D <= 256 runs tiles padded with
// zeros to 32, 64, 128 or 256 columns, D > 256 the wide kernels.
//
// What bounds them on the H100: operations.  At (BH, T, D) = (64, 2048,
// 64), causal, the forward does 34.4 GFLOP (two products over half the
// T^2 scores), dq 51.5 and dk/dv 68.7 (together about 120 GFLOP),
// against 134-200 MB of operands and results: about 250 operations per
// byte moved, above the ~20 at which the card's f32 units (67 TFLOP/s
// outside the tensor cores) and the ~150 at which its TF32 tensor cores
// (495 TFLOP/s) stop waiting on its 3.35 TB/s.  A K9 hop at the ring's
// per-rank (64, 512, 512, 64) is 2.2 (diagonal) or 4.3 (full) GFLOP
// against ~42 MB of operands and carry, ~100 operations per byte.
//
// All four run every product on the tensor cores (`mma.sync`, 3xTF32
// for f32 inputs, bf16 for bf16 inputs, f32 accumulators) and stream
// the other side's tiles with `cp.async` in a two-stage ring; the
// sections below have the details.  Under 3xTF32 the forward's 34.4
// GFLOP cost at least 0.208 ms at 495 TFLOP/s, K7 + K8's 120 GFLOP at
// least 0.73 ms.
//
// Common to all:
//   * no atomics: every output tile has one owner block (K6, K7 and K9
//     own query rows, K8 key rows; at D > 128 K8, and at D > 256 all of
//     them, own a group of the output's columns too), so all are
//     deterministic, as the TPU split is;
//   * causal blocks stop at (K6, K7, K9) or start from (K8) the
//     diagonal, the TPU kernels' skip, and the grid hands out the
//     longest rows first so the short ones fill the tail.
//
// Shared memory is dynamic (cudaFuncSetAttribute above 48 KB); the
// sizes follow from `FwdTiles`, `BwdTiles` and `WideTiles` below (at
// most 200 KB, f32 at D = 256; 37-104 KB for the wide kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kMinRows = 64;     // the fewest rows a block owns (grid.y)
constexpr float kNeg = -1e30f;   // the TPU kernels' finite mask value

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// The tensor-core pieces of K6-K9.
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

// Rows [r0, r0 + R) and columns [c0, c0 + W) of one head's (T, D)
// matrix into a shared tile of row stride LD in the input type, zero past
// T and past D.  With `vec` (rows a whole number of 16-byte chunks,
// 16-byte aligned; c0 a multiple of 16 bytes) the copies are
// asynchronous; otherwise element by element.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void load_block(T* s, const T* __restrict__ g,
                                           int r0, int Tn, int D, int c0,
                                           int vec) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = W / EPC;
  if (vec) {
    for (int idx = threadIdx.x; idx < R * CPR; idx += kThreads) {
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      const bool ok = r0 + r < Tn && c0 + c < D;
      cp_async16(s + r * LD + c,
                 ok ? g + (int64_t)(r0 + r) * D + c0 + c : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
      const int r = idx / W, d = idx % W;
      const bool ok = r0 + r < Tn && c0 + d < D;
      s[r * LD + d] = ok ? g[(int64_t)(r0 + r) * D + c0 + d] : T(0.f);
    }
  }
}

// all DP (padded) columns of rows [r0, r0 + R)
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void load_rows(T* s, const T* __restrict__ g,
                                          int r0, int Tn, int D, int vec) {
  load_block<T, R, DP, LD>(s, g, r0, Tn, D, 0, vec);
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

// K6 and K9: f32 at D <= 64 two m-tiles a warp and 32-key tiles (three
// blocks an SM), f32 at D = 128 32-key tiles (two an SM); bf16 64-key
// tiles at D <= 128; 32-key tiles at D = 256 (f32 one block an SM, bf16
// two).  At the ring's per-rank (64, 512, 512, 64) f32 a hop is 256
// blocks of 128 rows, all resident at once.
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
// K6 and K9: the forward, one body in two modes.  grid (BH, ceil(Tq /
// ROWS)); a block owns ROWS query rows (Q resident) and walks the key
// tiles (K and V, two stages) up to the causal edge.  Per key tile a
// warp computes its rows of S = Q K^T in C registers, runs the online
// softmax on them (the 4 lanes of a quad share a row: its max and sum by
// two xor shuffles), rescales its O accumulators by corr and adds P V
// with P's registers as the A operand.
//
// K6 (`flash_fwd_kernel`) starts every row at (m, l, acc) = (-1e30, 0,
// 0) and writes O = acc / l and lse = m + log l.  K9
// (`flash_carry_kernel`) is one ring hop: it reads the (m, l, acc) carry
// into the same registers at the start and writes it back at the end (no
// acc / l, no lse); Tq and Tk may differ, and the causal test uses the
// blocks' global offsets, q_off + r >= k_off + c (plain int arguments,
// scalar prefetch on the TPU).  K6 is the case q_off = k_off = 0, Tq =
// Tk.  The carry is f32 for f32 and bf16 inputs alike.  The outputs are
// separate buffers (the wrapper allocates them).
//
// The TPU's K9 walks every key tile, so a row whose keys in this hop
// are all hidden leaves with m' = max(m, -1e30): -1e30 where it came in
// at -inf (the ring's first carry), with l and acc unchanged (corr =
// exp(-inf - 0) = 0 multiplies zeros).  This kernel skips the tiles past
// the causal edge, as K6 does, and writes max(m, -1e30) for a causal hop
// instead, which gives the same m' for every row: a row that processed a
// tile saw a score >= -1e30 there.  m_safe is finite in every processed
// tile (each holds a key < Tk, visible or -1e30), so exp(m - m_safe) is
// exp(-inf) = 0, never NaN, for a row that has seen nothing yet.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// What a forward launch reads and writes: K6 fills o and lse, K9 reads
// (m_in, l_in, acc_in) and fills (m_out, l_out, acc_out).
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  int Tq, Tk, D;
  float scale;
  int q_off, k_off, causal, vec;
};

// the block's key tiles: all of Tk, or (causal) those with a key visible
// to its last row q_end - 1
__device__ __forceinline__ int key_tiles(int causal, int Tk, int q_off,
                                         int k_off, int q_end, int bc) {
  const int kv_end = causal ? max(0, min(Tk, q_off + q_end - k_off)) : Tk;
  return (kv_end + bc - 1) / bc;
}

// The rows' state at the start: K6 (-1e30, 0, 0); K9 the carry of the
// rows < Tq, columns [c0, c0 + 8 ND) of acc.  `rq` is the local row of
// lane group g of m-tile 0.
template <bool CARRY, int MT, int ND>
__device__ __forceinline__ void fwd_start(const FwdArgs& a, int64_t row0,
                                          int rq, int c0, int t,
                                          float (&m)[MT][2],
                                          float (&l)[MT][2],
                                          float (&acc)[MT][ND][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rq + 16 * mt + 8 * h;
      const bool in = CARRY && r < a.Tq;  // rows past Tq are never stored
      const int64_t at = (row0 + r) * a.D;
      m[mt][h] = in ? a.m_in[row0 + r] : kNeg;
      l[mt][h] = in ? a.l_in[row0 + r] : 0.f;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c0 + 8 * n + 2 * t + e;
          acc[mt][n][2 * h + e] = in && d < a.D ? a.acc_in[at + d] : 0.f;
        }
    }
}

// The online softmax of one key tile's scores s (keys k0 + [0, 8 NT)
// of Tk, as raw Q K^T sums) into (m, l, acc); `rq` as in fwd_start,
// q_off and k_off the global offsets (K6 passes literal zeros, and its
// Tq as Tk).
template <int MT, int NT, int ND>
__device__ __forceinline__ void online_softmax(const FwdArgs& a, int Tk,
                                               int q_off, int k_off, int rq,
                                               int k0, int t,
                                               float (&s)[MT][NT][4],
                                               float (&m)[MT][2],
                                               float (&l)[MT][2],
                                               float (&acc)[MT][ND][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q_off + rq + 16 * mt + 8 * h;  // global positions
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t + e;
          float x = s[mt][j][2 * h + e] * a.scale;
          if (c >= Tk) x = -INFINITY;  // past the end: no contribution
          else if (a.causal && r < k_off + c) x = kNeg;
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
}

// The end: K6 writes O = acc / l (columns [c0, c0 + 8 ND)) and, where
// `stats`, lse; K9 writes acc and, where `stats`, m (max(m, -1e30) for
// a causal hop) and l.
template <bool CARRY, typename TI, int MT, int ND>
__device__ __forceinline__ void fwd_finish(const FwdArgs& a, int64_t row0,
                                           int rq, int c0, bool stats,
                                           int t, const float (&m)[MT][2],
                                           const float (&l)[MT][2],
                                           const float (&acc)[MT][ND][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rq + 16 * mt + 8 * h;
      if (r >= a.Tq) continue;
      const int64_t at = (row0 + r) * a.D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c0 + 8 * n + 2 * t + e;
          if (d >= a.D) continue;
          if constexpr (CARRY)
            a.acc_out[at + d] = acc[mt][n][2 * h + e];
          else
            store(static_cast<TI*>(a.o) + at + d,
                  acc[mt][n][2 * h + e] / l[mt][h]);
        }
      if (stats && t == 0) {
        if constexpr (CARRY) {
          a.m_out[row0 + r] = a.causal ? fmaxf(m[mt][h], kNeg) : m[mt][h];
          a.l_out[row0 + r] = l[mt][h];
        } else {
          a.lse[row0 + r] = m[mt][h] + logf(l[mt][h]);
        }
      }
    }
}

template <typename TI, int DP, bool CARRY>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
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
  const TI* q = static_cast<const TI*>(a.q);
  const TI* k = static_cast<const TI*>(a.k);
  const TI* v = static_cast<const TI*>(a.v);
  const int D = a.D, vec = a.vec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16 * MT;
  const int64_t row0 = (int64_t)blockIdx.x * a.Tq;
  const int64_t qhead = row0 * D;
  // K6: Tk = Tq and no offsets, as literals where the compiler can see them
  const int Tk = CARRY ? a.Tk : a.Tq;
  const int q_off = CARRY ? a.q_off : 0, k_off = CARRY ? a.k_off : 0;
  const int64_t khead = (int64_t)blockIdx.x * Tk * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const int n_tiles =
      key_tiles(a.causal, Tk, q_off, k_off, min(a.Tq, q0 + BR), BC);
  const int rq = q0 + rw + g;

  load_rows<TI, BR, DP, LD>(qs, q + qhead, q0, a.Tq, D, vec);
  load_rows<TI, BC, DP, LD>(ks, k + khead, 0, Tk, D, vec);
  load_rows<TI, BC, DP, LD>(vs, v + khead, 0, Tk, D, vec);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][ND][4];
  fwd_start<CARRY>(a, row0, rq, 0, t, m, l, acc);
  typename M::AS aq[MT][KQ];  // Q's fragments, where kQRegs

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BC;
    const int buf = it & 1;
    __syncthreads();  // every warp is done with the other stage
    if (it + 1 < n_tiles) {
      load_rows<TI, BC, DP, LD>(ks + (buf ^ 1) * BC * LD, k + khead, k0 + BC,
                                Tk, D, vec);
      load_rows<TI, BC, DP, LD>(vs + (buf ^ 1) * BC * LD, v + khead, k0 + BC,
                                Tk, D, vec);
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
        typename M::AS af[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (S::kQRegs)
            af[mt] = aq[mt][kk / M::KS];
          else
            M::frag_a(af[mt], qs, LD, rw + 16 * mt, kk, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          typename M::B b[2];
          M::frag_bn2(b, kt, LD, 8 * j, kk, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            M::mma(ps[mt][j], af[mt], b[0]);
            M::mma(ps[mt][j + 1], af[mt], b[1]);
          }
        }
      }
      add_group(s, ps, kg == 0);
    }
    online_softmax(a, Tk, q_off, k_off, rq, k0, t, s, m, l, acc);
    // O += P V
#pragma unroll
    for (int j = 0; j < BC / M::KS; ++j) {
      typename M::AR ar[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) M::a_from_c(ar[mt], s[mt], j);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        typename M::B b[2];
        M::frag_bt2(b, vt, LD, j * M::KS, 8 * n, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          M::mma(acc[mt][n], ar[mt], b[0]);
          M::mma(acc[mt][n + 1], ar[mt], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  fwd_finish<CARRY, TI>(a, row0, rq, 0, true, t, m, l, acc);
}

template <typename TI, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  fwd_body<TI, DP, false>(a);
}

template <typename TI, int DP>
__global__ void __launch_bounds__(kThreads) flash_carry_kernel(FwdArgs a) {
  fwd_body<TI, DP, true>(a);
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
// Wide heads: K6, K7, K8 and K9 at D > 256.
//
// The padded-width kernels above hold a whole row of D in shared memory
// and their column accumulators in registers; at D = 512 an f32 64-row Q
// alone is 128 KB, and O's accumulators would be 256 registers a lane.
// The wide kernels take D at run time and split it two ways:
//   * the output's columns over grid.z, in groups of DC = 256 for O / acc
//     (K6, K9) and dQ (K7), 128 for dK and dV together (K8): the widths
//     whose accumulators a warp already holds at D = 256.  Block z owns
//     its rows (keys for K8) and columns [z DC, (z + 1) DC);
//   * the score products S = Q K^T and dP = dO V^T (K8: S^T, dP^T),
//     which reduce over all of D, into slices of GK = 64 columns.  Each
//     slice's mma chain starts from zero and is added to the scores by
//     f32 adds, as the f32 score groups of D = 256 are.
// Every column group therefore computes the same scores, so the same m
// and l (or p), and only group 0 writes the row statistics (lse; K9's m
// and l): still no atomics, and two runs are bit-equal.  The cost is the
// recomputation: a group repeats the score products, so a wide launch
// does ceil(D / DC) times their work (at D 512: K6 / K9 1.5x the
// operations of one pass, K7 1.67x, K8 2.5x).
//
// Nothing of D stays resident: per tile of the streamed side, the
// kernel walks a sequence of items, first the ceil(D / 64) score slices
// (64 columns of the owned rows' operands and of the tile's), then the
// DC / 64 chunks of the second product's operand in its column group
// (V for K6 / K9, K for K7, dO and Q for K8).  Items pass through a
// two-slot ring of shared memory by `cp.async`, each issued one item
// ahead; an f32 slot is 26 KB for K6 / K9 ((64 + 32) x 68 floats), 52
// KB for K7 and K8.  The owned rows' slices are read again for
// every tile (from L2), which is what keeps shared memory small enough
// for two or more blocks an SM where the registers allow it.  The
// accumulators of a column group take 128 registers a lane, so every
// wide kernel runs at 250-255 registers, at most two blocks an SM
// (chip_smoke.py's `ptxas` line lists each kernel's registers and
// spills).
// ---------------------------------------------------------------------------

constexpr int kGK = 64;  // columns of a score slice and of a chunk

template <typename TI>
struct WideTiles {
  static constexpr bool kF32 = sizeof(TI) == 4;
  static constexpr int ROWS = 64;                // rows a block owns
  static constexpr int FWD_KEYS = kF32 ? 32 : 64;  // K6 / K9 key tile
  static constexpr int DQ_KEYS = 32;             // K7's key tile
  // K8's query tile: at f32, 16 queries spill no registers but ran K8
  // at (8, 2048, 512) slower than 32, which spill 244 bytes (PERF.md)
  static constexpr int DKV_QUERIES = 32;
  static constexpr int FWD_COLS = 256;           // DC of O / acc
  static constexpr int DQ_COLS = 256;            // DC of dQ
  static constexpr int DKV_COLS = 128;           // DC of dK and dV
  static constexpr int LD = kGK + Mma<TI>::LDP;  // a slot's row stride
};

template <typename TI>
constexpr size_t wide_fwd_smem() {
  using W = WideTiles<TI>;
  return sizeof(TI) * 2 * (W::ROWS + W::FWD_KEYS) * W::LD;
}
template <typename TI>
constexpr size_t wide_dq_smem() {
  using W = WideTiles<TI>;
  return sizeof(TI) * 2 * (2 * W::ROWS + 2 * W::DQ_KEYS) * W::LD;
}
template <typename TI>
constexpr size_t wide_dkv_smem() {
  using W = WideTiles<TI>;
  return sizeof(TI) * 2 * (2 * W::ROWS + 2 * W::DKV_QUERIES) * W::LD;
}

// The item ring: `issue(i)` starts item i's copies into slot i % 2 (no
// copies past the last item, but always one commit group), and
// `next(i)` returns the slot of item i once it has landed, after the
// issue of item i + 1 into the slot that item i - 1 used.
template <typename TI, typename Issue>
struct ItemRing {
  TI* base;
  int slot;
  Issue issue;
  __device__ __forceinline__ const TI* next(int i) {
    __syncthreads();  // every warp is done with item i - 1's slot
    issue(i + 1);
    cp_async_wait<1>();  // item i's group (all but the newest)
    __syncthreads();
    return base + (i & 1) * slot;
  }
};
template <typename TI, typename Issue>
__device__ __forceinline__ ItemRing<TI, Issue> item_ring(TI* base, int slot,
                                                         Issue issue) {
  return ItemRing<TI, Issue>{base, slot, issue};
}

template <int MT, int NT>
__device__ __forceinline__ void zero_tiles(float (&x)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][j][e] = 0.f;
}

// K6 / K9 at D > 256.  grid (BH, ceil(Tq / 64), ceil(D / 256)).
template <typename TI, bool CARRY>
__device__ __forceinline__ void fwd_wide_body(const FwdArgs& a) {
  using M = Mma<TI>;
  using W = WideTiles<TI>;
  constexpr int LD = W::LD;
  constexpr int BR = W::ROWS;      // query rows a block
  constexpr int BC = W::FWD_KEYS;  // keys a tile
  constexpr int NT = BC / 8;       // n-tiles of S
  constexpr int DC = W::FWD_COLS;  // columns of O a block
  constexpr int ND = DC / 8;       // n-tiles of O
  constexpr int NCH = DC / kGK;    // chunks of V a tile, at most
  constexpr int NC8 = kGK / 8;     // n-tiles of a chunk
  extern __shared__ float4 smem4[];
  const TI* q = static_cast<const TI*>(a.q);
  const TI* k = static_cast<const TI*>(a.k);
  const TI* v = static_cast<const TI*>(a.v);
  const int D = a.D, vec = a.vec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, rw = warp * 16;
  const int64_t row0 = (int64_t)blockIdx.x * a.Tq;
  const int64_t qhead = row0 * D;
  const int Tk = CARRY ? a.Tk : a.Tq;
  const int q_off = CARRY ? a.q_off : 0, k_off = CARRY ? a.k_off : 0;
  const int64_t khead = (int64_t)blockIdx.x * Tk * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const int c0 = blockIdx.z * DC;
  const int n_tiles =
      key_tiles(a.causal, Tk, q_off, k_off, min(a.Tq, q0 + BR), BC);
  const int n_s = (D + kGK - 1) / kGK;                       // score slices
  const int n_v = min(NCH, (D - c0 + kGK - 1) / kGK);        // V chunks
  const int per_tile = n_s + n_v, total = n_tiles * per_tile;
  const int rq = q0 + rw + (lane >> 2);

  // item j < n_s of tile it: Q [BR][kGK] then K [BC][kGK], columns
  // j kGK; item n_s + c: V [BC][kGK], columns c0 + c kGK
  auto ring = item_ring(reinterpret_cast<TI*>(smem4), (BR + BC) * LD,
                        [&](int i) {
    if (i < total) {
      const int it = i / per_tile, j = i % per_tile;
      TI* s = reinterpret_cast<TI*>(smem4) + (i & 1) * (BR + BC) * LD;
      if (j < n_s) {
        load_block<TI, BR, kGK, LD>(s, q + qhead, q0, a.Tq, D, j * kGK, vec);
        load_block<TI, BC, kGK, LD>(s + BR * LD, k + khead, it * BC, Tk, D,
                                    j * kGK, vec);
      } else {
        load_block<TI, BC, kGK, LD>(s, v + khead, it * BC, Tk, D,
                                    c0 + (j - n_s) * kGK, vec);
      }
    }
    cp_async_commit();
  });

  float m[1][2], l[1][2], acc[1][ND][4];
  fwd_start<CARRY>(a, row0, rq, c0, t, m, l, acc);
  ring.issue(0);
  int i = 0;
  for (int it = 0; it < n_tiles; ++it) {
    // S = Q K^T, slice by slice
    float s[1][NT][4];
    zero_tiles(s);
    for (int j = 0; j < n_s; ++j) {
      const TI* sl = ring.next(i++);
      float ps[1][NT][4];
      zero_tiles(ps);
#pragma unroll
      for (int kk = 0; kk < kGK; kk += M::KS) {
        typename M::AS af;
        M::frag_a(af, sl, LD, rw, kk, lane);
#pragma unroll
        for (int jn = 0; jn < NT; jn += 2) {
          typename M::B b[2];
          M::frag_bn2(b, sl + BR * LD, LD, 8 * jn, kk, lane);
          M::mma(ps[0][jn], af, b[0]);
          M::mma(ps[0][jn + 1], af, b[1]);
        }
      }
      add_group(s, ps, false);
    }
    online_softmax(a, Tk, q_off, k_off, rq, it * BC, t, s, m, l, acc);
    // O[:, group] += P V[tile, group], chunk by chunk
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= n_v) break;
      const TI* vt = ring.next(i++);
#pragma unroll
      for (int jj = 0; jj < BC / M::KS; ++jj) {
        typename M::AR ar;
        M::a_from_c(ar, s[0], jj);
#pragma unroll
        for (int n = 0; n < NC8; n += 2) {
          typename M::B b[2];
          M::frag_bt2(b, vt, LD, jj * M::KS, 8 * n, lane);
          M::mma(acc[0][c * NC8 + n], ar, b[0]);
          M::mma(acc[0][c * NC8 + n + 1], ar, b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  fwd_finish<CARRY, TI>(a, row0, rq, c0, blockIdx.z == 0, t, m, l, acc);
}

template <typename TI>
__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(FwdArgs a) {
  fwd_wide_body<TI, false>(a);
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
flash_carry_wide_kernel(FwdArgs a) {
  fwd_wide_body<TI, true>(a);
}

// K7 at D > 256.  grid (BH, ceil(T / 64), ceil(D / 256)); a block owns 64
// query rows and 256 columns of dQ.  Per key tile: score slices of (Q,
// dO, K, V), then dS in registers, then the K chunks of its columns.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                         const TI* __restrict__ v,
                         const TI* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, TO* __restrict__ dq,
                         int Tn, int D, float scale, int causal, int vec) {
  using M = Mma<TI>;
  using W = WideTiles<TI>;
  constexpr int LD = W::LD;
  constexpr int BR = W::ROWS;     // query rows a block
  constexpr int BC = W::DQ_KEYS;  // keys a tile
  constexpr int NT = BC / 8;      // n-tiles of S
  constexpr int DC = W::DQ_COLS;  // columns of dQ a block
  constexpr int ND = DC / 8;
  constexpr int NCH = DC / kGK;
  constexpr int NC8 = kGK / 8;
  constexpr int SLOT = (2 * BR + 2 * BC) * LD;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // longest first
  const int c0 = blockIdx.z * DC;
  const int q_end = min(Tn, q0 + BR);
  const int n_tiles = ((causal ? q_end : Tn) + BC - 1) / BC;
  const int n_s = (D + kGK - 1) / kGK;
  const int n_c = min(NCH, (D - c0 + kGK - 1) / kGK);
  const int per_tile = n_s + n_c, total = n_tiles * per_tile;

  // item j < n_s: Q, dO [BR][kGK], K, V [BC][kGK] at columns j kGK;
  // item n_s + c: K [BC][kGK] at columns c0 + c kGK
  auto ring = item_ring(reinterpret_cast<TI*>(smem4), SLOT, [&](int i) {
    if (i < total) {
      const int it = i / per_tile, j = i % per_tile;
      TI* s = reinterpret_cast<TI*>(smem4) + (i & 1) * SLOT;
      if (j < n_s) {
        const int cj = j * kGK;
        load_block<TI, BR, kGK, LD>(s, q + head, q0, Tn, D, cj, vec);
        load_block<TI, BR, kGK, LD>(s + BR * LD, dout + head, q0, Tn, D, cj,
                                    vec);
        load_block<TI, BC, kGK, LD>(s + 2 * BR * LD, k + head, it * BC, Tn,
                                    D, cj, vec);
        load_block<TI, BC, kGK, LD>(s + (2 * BR + BC) * LD, v + head,
                                    it * BC, Tn, D, cj, vec);
      } else {
        load_block<TI, BC, kGK, LD>(s, k + head, it * BC, Tn, D,
                                    c0 + (j - n_s) * kGK, vec);
      }
    }
    cp_async_commit();
  });

  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + rw + g + 8 * h;
    lr[h] = r < Tn ? lse[row0 + r] : 0.f;
    dr[h] = r < Tn ? delta[row0 + r] : 0.f;
  }
  float acc[1][ND][4];
  zero_tiles(acc);
  ring.issue(0);
  int i = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BC;
    float s[1][NT][4], dp[1][NT][4];
    zero_tiles(s);
    zero_tiles(dp);
    for (int j = 0; j < n_s; ++j) {
      const TI* sl = ring.next(i++);
      float ps[1][NT][4], pdp[1][NT][4];
      zero_tiles(ps);
      zero_tiles(pdp);
#pragma unroll
      for (int kk = 0; kk < kGK; kk += M::KS) {
        typename M::AS aq, ado;
        M::load_a(aq, sl, LD, rw, kk, g, t);
        M::load_a(ado, sl + BR * LD, LD, rw, kk, g, t);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          typename M::B bk, bv;
          M::load_bn(bk, sl + 2 * BR * LD, LD, 8 * jn, kk, g, t);
          M::load_bn(bv, sl + (2 * BR + BC) * LD, LD, 8 * jn, kk, g, t);
          M::mma(ps[0][jn], aq, bk);
          M::mma(pdp[0][jn], ado, bv);
        }
      }
      add_group(s, ps, false);
      add_group(dp, pdp, false);
    }
    // p = exp(s scale - lse), dS = p (dP - delta) scale, into s
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + rw + g + 8 * (e >> 1);
        const int c = k0 + 8 * jn + 2 * t + (e & 1);
        float x = s[0][jn][e] * scale;
        if (causal && r < c) x = kNeg;
        const float p = c < Tn ? expf(x - lr[e >> 1]) : 0.f;
        s[0][jn][e] = p * (dp[0][jn][e] - dr[e >> 1]) * scale;
      }
    // dQ[:, group] += dS K[tile, group], chunk by chunk
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= n_c) break;
      const TI* kt = ring.next(i++);
#pragma unroll
      for (int jj = 0; jj < BC / M::KS; ++jj) {
        typename M::AR ar;
        M::a_from_c(ar, s[0], jj);
#pragma unroll
        for (int n = 0; n < NC8; ++n) {
          typename M::B b;
          M::load_bt(b, kt, LD, jj * M::KS, 8 * n, g, t);
          M::mma(acc[0][c * NC8 + n], ar, b);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + rw + g + 8 * (e >> 1);
      const int d = c0 + 8 * n + 2 * t + (e & 1);
      if (r < Tn && d < D) store(dq + head + (int64_t)r * D + d, acc[0][n][e]);
    }
}

// K8 at D > 256.  grid (BH, ceil(T / 64), ceil(D / 128)); a block owns 64
// key rows and 128 columns of dK and dV.  Per query tile: score slices
// of (K, V, Q, dO) into S^T and dP^T, then P^T and dS^T in registers
// (lse and delta read from global memory), then the (dO, Q) chunks of its
// columns.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                          const TI* __restrict__ v,
                          const TI* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          TO* __restrict__ dk, TO* __restrict__ dv, int Tn,
                          int D, float scale, int causal, int vec) {
  using M = Mma<TI>;
  using W = WideTiles<TI>;
  constexpr int LD = W::LD;
  constexpr int BK = W::ROWS;         // key rows a block
  constexpr int BQ = W::DKV_QUERIES;  // queries a tile
  constexpr int NT = BQ / 8;          // n-tiles of S^T
  constexpr int DC = W::DKV_COLS;     // columns of dK, dV a block
  constexpr int ND = DC / 8;
  constexpr int NCH = DC / kGK;
  constexpr int NC8 = kGK / 8;
  constexpr int SLOT = (2 * BK + 2 * BQ) * LD;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rw = warp * 16;
  const int64_t head = (int64_t)blockIdx.x * Tn * D;
  const int64_t row0 = (int64_t)blockIdx.x * Tn;
  const int k0 = blockIdx.y * BK;       // causal: the first keys see most
  const int c0 = blockIdx.z * DC;
  const int q_begin = causal ? k0 : 0;  // earlier queries see none of them
  const int n_tiles = (Tn - q_begin + BQ - 1) / BQ;
  const int n_s = (D + kGK - 1) / kGK;
  const int n_c = min(NCH, (D - c0 + kGK - 1) / kGK);
  const int per_tile = n_s + n_c, total = n_tiles * per_tile;

  // item j < n_s: K, V [BK][kGK], Q, dO [BQ][kGK] at columns j kGK;
  // item n_s + c: dO, Q [BQ][kGK] at columns c0 + c kGK
  auto ring = item_ring(reinterpret_cast<TI*>(smem4), SLOT, [&](int i) {
    if (i < total) {
      const int it = i / per_tile, j = i % per_tile;
      const int q0 = q_begin + it * BQ;
      TI* s = reinterpret_cast<TI*>(smem4) + (i & 1) * SLOT;
      if (j < n_s) {
        const int cj = j * kGK;
        load_block<TI, BK, kGK, LD>(s, k + head, k0, Tn, D, cj, vec);
        load_block<TI, BK, kGK, LD>(s + BK * LD, v + head, k0, Tn, D, cj,
                                    vec);
        load_block<TI, BQ, kGK, LD>(s + 2 * BK * LD, q + head, q0, Tn, D, cj,
                                    vec);
        load_block<TI, BQ, kGK, LD>(s + (2 * BK + BQ) * LD, dout + head, q0,
                                    Tn, D, cj, vec);
      } else {
        const int cc = c0 + (j - n_s) * kGK;
        load_block<TI, BQ, kGK, LD>(s, dout + head, q0, Tn, D, cc, vec);
        load_block<TI, BQ, kGK, LD>(s + BQ * LD, q + head, q0, Tn, D, cc,
                                    vec);
      }
    }
    cp_async_commit();
  });

  float gk[1][ND][4], gv[1][ND][4];
  zero_tiles(gk);
  zero_tiles(gv);
  ring.issue(0);
  int i = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    float st[1][NT][4], dpt[1][NT][4];  // [key][query]
    zero_tiles(st);
    zero_tiles(dpt);
    for (int j = 0; j < n_s; ++j) {
      const TI* sl = ring.next(i++);
      float ps[1][NT][4], pdp[1][NT][4];
      zero_tiles(ps);
      zero_tiles(pdp);
#pragma unroll
      for (int kk = 0; kk < kGK; kk += M::KS) {
        typename M::AS ak, av;
        M::load_a(ak, sl, LD, rw, kk, g, t);
        M::load_a(av, sl + BK * LD, LD, rw, kk, g, t);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          typename M::B bq, bdo;
          M::load_bn(bq, sl + 2 * BK * LD, LD, 8 * jn, kk, g, t);
          M::load_bn(bdo, sl + (2 * BK + BQ) * LD, LD, 8 * jn, kk, g, t);
          M::mma(ps[0][jn], ak, bq);
          M::mma(pdp[0][jn], av, bdo);
        }
      }
      add_group(st, ps, false);
      add_group(dpt, pdp, false);
    }
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + rw + g + 8 * (e >> 1);
        const int r = q0 + 8 * jn + 2 * t + (e & 1);
        float x = st[0][jn][e] * scale;
        if (causal && r < c) x = kNeg;
        const bool in = r < Tn;
        const float p = in ? expf(x - lse[row0 + r]) : 0.f;
        st[0][jn][e] = p;
        dpt[0][jn][e] =
            p * (dpt[0][jn][e] - (in ? delta[row0 + r] : 0.f)) * scale;
      }
    // dV[:, group] += P^T dO[tile, group], dK[:, group] += dS^T Q[tile, group]
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= n_c) break;
      const TI* sl = ring.next(i++);
#pragma unroll
      for (int jj = 0; jj < BQ / M::KS; ++jj) {
        typename M::AR ap, ads;
        M::a_from_c(ap, st[0], jj);
        M::a_from_c(ads, dpt[0], jj);
#pragma unroll
        for (int n = 0; n < NC8; ++n) {
          typename M::B bdo, bq;
          M::load_bt(bdo, sl, LD, jj * M::KS, 8 * n, g, t);
          M::load_bt(bq, sl + BQ * LD, LD, jj * M::KS, 8 * n, g, t);
          M::mma(gv[0][c * NC8 + n], ap, bdo);
          M::mma(gk[0][c * NC8 + n], ads, bq);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k0 + rw + g + 8 * (e >> 1);
      const int d = c0 + 8 * n + 2 * t + (e & 1);
      if (c < Tn && d < D) {
        store(dk + head + (int64_t)c * D + d, gk[0][n][e]);
        store(dv + head + (int64_t)c * D + d, gv[0][n][e]);
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

// grid (BH, row blocks, column groups)
dim3 grid_for(int BH, int Tn, int rows, int D = 1, int cols = 1) {
  return dim3(BH, (Tn + rows - 1) / rows, (D + cols - 1) / cols);
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

// DP: the padded width, or 0 for the wide kernels
template <typename T, int DP, bool CARRY>
int fwd_launch(FwdArgs a, int BH, cudaStream_t s) {
  a.vec = vec_ok<T>(a.D, a.q, a.k, a.v, a.q);
  void (*kern)(FwdArgs);
  size_t smem;
  dim3 grid;
  if constexpr (DP == 0) {
    kern = CARRY ? flash_carry_wide_kernel<T> : flash_fwd_wide_kernel<T>;
    smem = wide_fwd_smem<T>();
    grid = grid_for(BH, a.Tq, WideTiles<T>::ROWS, a.D,
                    WideTiles<T>::FWD_COLS);
  } else {
    kern = CARRY ? flash_carry_kernel<T, DP> : flash_fwd_kernel<T, DP>;
    smem = fwd_mma_smem<T, DP>();
    grid = grid_for(BH, a.Tq, FwdTiles<T, DP>::ROWS);
  }
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int DP>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int Tn,
              int D, float scale, int causal, cudaStream_t s) {
  using Fn = void (*)(const TI*, const TI*, const TI*, const TI*,
                      const float*, const float*, TO*, int, int, float, int,
                      int);
  Fn kern;
  size_t smem;
  dim3 grid;
  if constexpr (DP == 0) {
    kern = flash_bwd_dq_wide_kernel<TI, TO>;
    smem = wide_dq_smem<TI>();
    grid = grid_for(BH, Tn, WideTiles<TI>::ROWS, D, WideTiles<TI>::DQ_COLS);
  } else {
    kern = flash_bwd_dq_kernel<TI, TO, DP>;
    smem = dq_smem<TI, DP>();
    grid = grid_for(BH, Tn, BwdTiles<TI, DP>::ROWS);
  }
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid, kThreads, smem, s>>>(
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
  using Fn = void (*)(const TI*, const TI*, const TI*, const TI*,
                      const float*, const float*, TO*, TO*, int, int, float,
                      int, int);
  Fn kern;
  size_t smem;
  dim3 grid;
  if constexpr (DP == 0) {
    kern = flash_bwd_dkv_wide_kernel<TI, TO>;
    smem = wide_dkv_smem<TI>();
    grid = grid_for(BH, Tn, WideTiles<TI>::ROWS, D, WideTiles<TI>::DKV_COLS);
  } else {
    kern = flash_bwd_dkv_kernel<TI, TO, DP>;
    smem = dkv_smem<TI, DP>();
    grid = grid_for(BH, Tn, BwdTiles<TI, DP>::ROWS);
    grid.z = BwdTiles<TI, DP>::DKV_SPLIT;
  }
  int err = prepare(kern, smem);
  if (err) return err;
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TI*>(dout), lse, delta,
      static_cast<TO*>(dk), static_cast<TO*>(dv), Tn, D, scale, causal,
      vec_ok<TI>(D, q, k, v, dout));
  return (int)cudaGetLastError();
}

// The padded-width entry points take D <= 256 ...
int check_args(int BH, int Tn, int D) {
  if (BH <= 0 || Tn <= 0 || D <= 0 || D > 256 ||
      (Tn + kMinRows - 1) / kMinRows > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ... the wide ones any D whose column groups fit grid.z
int check_wide_args(int BH, int Tn, int D, int cols) {
  if (BH <= 0 || Tn <= 0 || D <= 0 ||
      (Tn + kMinRows - 1) / kMinRows > 65535 || (D + cols - 1) / cols > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// D -> the padded width the kernels are compiled for; `wide` -> 0
template <template <int> class Fn, typename... Args>
int by_width(bool wide, int D, Args... args) {
  if (wide) return Fn<0>::run(args...);
  if (D <= 32) return Fn<32>::run(args...);
  if (D <= 64) return Fn<64>::run(args...);
  if (D <= 128) return Fn<128>::run(args...);
  return Fn<256>::run(args...);
}

template <typename T, bool CARRY>
struct Fwd {
  template <int DP>
  struct W {
    template <typename... A>
    static int run(A... a) { return fwd_launch<T, DP, CARRY>(a...); }
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

template <bool CARRY>
int fwd_entry(const FwdArgs& a, int BH, int dtype, bool wide,
              cudaStream_t s) {
  if (dtype == 0) return by_width<Fwd<float, CARRY>::template W>(
      wide, a.D, a, BH, s);
  if (dtype == 1) return by_width<Fwd<__nv_bfloat16, CARRY>::template W>(
      wide, a.D, a, BH, s);
  return (int)cudaErrorInvalidValue;
}

FwdArgs k6_args(const void* q, const void* k, const void* v, void* o,
                float* lse, int Tn, int D, float scale, int causal) {
  FwdArgs a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse;
  a.Tq = a.Tk = Tn, a.D = D, a.scale = scale, a.causal = causal;
  return a;
}

FwdArgs k9_args(const void* q, const void* k, const void* v,
                const float* m_in, const float* l_in, const float* acc_in,
                float* m_out, float* l_out, float* acc_out, int Tq, int Tk,
                int D, float scale, int q_off, int k_off, int causal) {
  FwdArgs a{};
  a.q = q, a.k = k, a.v = v, a.m_in = m_in, a.l_in = l_in;
  a.acc_in = acc_in, a.m_out = m_out, a.l_out = l_out, a.acc_out = acc_out;
  a.Tq = Tq, a.Tk = Tk, a.D = D, a.scale = scale;
  a.q_off = q_off, a.k_off = k_off, a.causal = causal;
  return a;
}

int dq_entry(bool wide, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             void* dq, int BH, int Tn, int D, float scale, int causal,
             int in_dtype, int out_dtype, cudaStream_t s) {
#define COS_DQ(TI, TO)                                                    \
  return by_width<Dq<TI, TO>::W>(wide, D, q, k, v, dout, lse, delta, dq,  \
                                 BH, Tn, D, scale, causal, s)
  if (in_dtype == 0 && out_dtype == 0) COS_DQ(float, float);
  if (in_dtype == 0 && out_dtype == 1) COS_DQ(float, __nv_bfloat16);
  if (in_dtype == 1 && out_dtype == 0) COS_DQ(__nv_bfloat16, float);
  if (in_dtype == 1 && out_dtype == 1) COS_DQ(__nv_bfloat16, __nv_bfloat16);
#undef COS_DQ
  return (int)cudaErrorInvalidValue;
}

int dkv_entry(bool wide, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dk, void* dv, int BH, int Tn, int D, float scale,
              int causal, int in_dtype, int out_dtype, cudaStream_t s) {
#define COS_DKV(TI, TO)                                                    \
  return by_width<Dkv<TI, TO>::W>(wide, D, q, k, v, dout, lse, delta, dk,  \
                                  dv, BH, Tn, D, scale, causal, s)
  if (in_dtype == 0 && out_dtype == 0) COS_DKV(float, float);
  if (in_dtype == 0 && out_dtype == 1) COS_DKV(float, __nv_bfloat16);
  if (in_dtype == 1 && out_dtype == 0) COS_DKV(__nv_bfloat16, float);
  if (in_dtype == 1 && out_dtype == 1) COS_DKV(__nv_bfloat16, __nv_bfloat16);
#undef COS_DKV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each entry point returns
// cudaGetLastError() of its launch (0 on success), or
// cudaErrorInvalidValue for refused arguments.  Each kernel has two with
// the same arguments: the padded widths (D <= 256, refused above) and
// `_wide` (any D; the wrappers send it D > 256).

// K6: o (BH, T, D) in the input dtype, lse (BH, T) f32.
extern "C" int cos_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int Tn, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  int err = check_args(BH, Tn, D);
  if (err) return err;
  return fwd_entry<false>(k6_args(q, k, v, o, lse, Tn, D, scale, causal),
                          BH, dtype, false,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int cos_flash_fwd_wide(const void* q, const void* k,
                                  const void* v, void* o, float* lse, int BH,
                                  int Tn, int D, float scale, int causal,
                                  int dtype, void* stream) {
  int err = check_wide_args(BH, Tn, D, WideTiles<float>::FWD_COLS);
  if (err) return err;
  return fwd_entry<false>(k6_args(q, k, v, o, lse, Tn, D, scale, causal),
                          BH, dtype, true,
                          static_cast<cudaStream_t>(stream));
}

// K7: dq (BH, T, D) in out_dtype, from q, k, v, dO (in_dtype), lse, delta.
extern "C" int cos_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int BH, int Tn,
                                int D, float scale, int causal, int in_dtype,
                                int out_dtype, void* stream) {
  int err = check_args(BH, Tn, D);
  if (err) return err;
  return dq_entry(false, q, k, v, dout, lse, delta, dq, BH, Tn, D, scale,
                  causal, in_dtype, out_dtype,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int cos_flash_bwd_dq_wide(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int BH, int Tn, int D,
                                     float scale, int causal, int in_dtype,
                                     int out_dtype, void* stream) {
  int err = check_wide_args(BH, Tn, D, WideTiles<float>::DQ_COLS);
  if (err) return err;
  return dq_entry(true, q, k, v, dout, lse, delta, dq, BH, Tn, D, scale,
                  causal, in_dtype, out_dtype,
                  static_cast<cudaStream_t>(stream));
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
  return dkv_entry(false, q, k, v, dout, lse, delta, dk, dv, BH, Tn, D,
                   scale, causal, in_dtype, out_dtype,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int cos_flash_bwd_dkv_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int BH, int Tn,
                                      int D, float scale, int causal,
                                      int in_dtype, int out_dtype,
                                      void* stream) {
  int err = check_wide_args(BH, Tn, D, WideTiles<float>::DKV_COLS);
  if (err) return err;
  return dkv_entry(true, q, k, v, dout, lse, delta, dk, dv, BH, Tn, D,
                   scale, causal, in_dtype, out_dtype,
                   static_cast<cudaStream_t>(stream));
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
  return fwd_entry<true>(k9_args(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                                 acc_out, Tq, Tk, D, scale, q_off, k_off,
                                 causal),
                         BH, dtype, false, static_cast<cudaStream_t>(stream));
}

extern "C" int cos_flash_block_update_wide(
    const void* q, const void* k, const void* v, const float* m_in,
    const float* l_in, const float* acc_in, float* m_out, float* l_out,
    float* acc_out, int BH, int Tq, int Tk, int D, float scale, int q_off,
    int k_off, int causal, int dtype, void* stream) {
  int err = check_wide_args(BH, Tq, D, WideTiles<float>::FWD_COLS);
  if (!err) err = check_wide_args(BH, Tk, D, WideTiles<float>::FWD_COLS);
  if (err) return err;
  return fwd_entry<true>(k9_args(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                                 acc_out, Tq, Tk, D, scale, q_off, k_off,
                                 causal),
                         BH, dtype, true, static_cast<cudaStream_t>(stream));
}
