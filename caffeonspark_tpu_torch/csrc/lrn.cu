// Caffe across-channel LRN, forward and backward, for Hopper (sm_90a),
// NCHW layout.
//
// Replaces (caffeonspark_tpu/ops/pallas_kernels.py):
//   * `_lrn_fwd_call` (public `lrn_across_channels`, optional fuse_relu)
//     -> entry point `cos_lrn_fwd` (K1);
//   * `_bias_lrn_fwd_call` (public `bias_relu_lrn_across_channels`, the
//     conv-stem epilogue lrn(relu(x + bias))) -> `cos_bias_relu_lrn_fwd`
//     (K3);
//   * `_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel`) -> `cos_lrn_bwd` (K2);
//   * `_bias_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel_bias`, and the
//     channel sum of its dx that XLA reduces after it)
//     -> `cos_bias_relu_lrn_bwd` (K4): dx and d_bias in one pass.
//
//   y[n,c,p] = x'[n,c,p] * exp(-beta * log(k + alpha/n * S[n,c,p]))
//   S[n,c,p] = sum over |j - c| <= local_size/2 of x'[n,j,p]^2
//   x' = x, relu(x) or relu(x + bias[c]) (compile-time variants).
//
// Backward, with x' as above (the normalizer recomputed from x', as the
// TPU kernel recomputes it):
//   s_j  = k + alpha/n * S_j
//   u_j  = dy_j * x'_j * s_j^-beta / s_j
//   dx_c = dy_c * s_c^-beta - (2 alpha beta / n) * x'_c * sum_W(u)_c
//   dx_c = 0 where x'_c <= 0 when a ReLU is fused.
// mul/add/div use the _rn intrinsics wherever a result must be the plain
// version's, so nvcc contracts nothing into an FMA that the plain PyTorch
// version does not perform.
//
// K4 (the next section) was rebuilt first; K1, K3 and K2 (the last
// section) are built on its staging and its normalizer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------------------
// K4: dx and d_bias of lrn(relu(x + bias)), one pass
//
// The backward formulas above with x' = relu(x + bias[c]) and the ReLU
// mask; d_bias[c] is the sum of dx over (n, h, w) of the values stored
// (in bf16 the rounded ones, as the JAX VJP sums dx.astype(f32) after
// the cast).
//
// What bounds it on the H100: its bytes are x and dy read and dx
// written (12 an element in f32, 6 in bf16), but the steps alone take
// longer than that: in f32 the plain version's precise logf / expf and
// IEEE division (kept so that dx is bit for bit the plain dx), in bf16
// the instructions around the hardware's lg2 / ex2.  The copies run
// under the steps, and d_bias's sums add a few per cent.
//
// What the design does about it:
//   * a block owns one sample n, a tile of kTile spatial positions (one
//     a thread) and a run of channels [cs, ce), planned on the host
//     (ops/kernels.py `k4_plan`: the runs cut from the card's SM count
//     and this kernel's occupancy until N x tiles x runs fills a wave);
//   * x and dy reach shared memory through a ring of kStages stages of
//     kStage channel rows each, with cp.async: while one stage is
//     computed the next two are in flight, so the bytes in flight do
//     not depend on how many warps fit on an SM; eight threads copy a
//     row, each every eighth 16-byte word;
//   * a channel plane may start anywhere (H*W is odd at 55x55, 27x27,
//     13x13), so a row is copied as the 16-byte words that cover it,
//     from the aligned word at or below its first element, and read back
//     at its offset in the first word; the word that would pass the end
//     of a tensor copies only the bytes inside it (cp.async's src-size);
//     channels outside [0, C) are zero-filled rows (x' = relu(0 + 0) = 0
//     and dy = 0 give the zero-padded window) and a stage's bias entries
//     outside [0, C) are 0, so the compute has no channel bound checks,
//     and a stage whose eight dx all lie in the run stores unchecked;
//   * the compute walks x channel i of the staged rows in order, keeping
//     register rings of x', x'^2 (i - 2 pad .. i), u (j - 2 pad .. j) and
//     t = dy s^-beta (j - pad .. j) for j = i - pad, and writes dx_c for
//     c = i - 2 pad; window sums run centre first, then -1/+1, -2/+2, ...
//     as the TPU kernel's `_window_sum`;
//   * the normalizer (`Norm`): in f32 the plain version's operations in
//     its order (precise logf / expf and IEEE division), so that dx is
//     its dx bit for bit; in bf16 s^-beta and s^-beta-1 as the
//     hardware's ex2 of a scaled lg2 s (~2 ulp each, one log a step);
//     the powers of kBatch steps are taken before any of their
//     divisions (`Norm::pow`, then `Norm::ut`): the f32 division
//     branches to a slow path, and code is not moved across a branch,
//     so step by step each log / exp chain would wait on the last;
//     offsets are 32-bit inside one sample's C*H*W slab (the host
//     refuses a slab of 2^31 elements);
//   * d_bias: each thread puts its stored dx of a stage's channels in a
//     shared buffer (double-buffered); after the stage sixteen threads a
//     channel sum the tile's 128 values in a fixed order into
//     `partial[c][n * tiles + tile]`, and `sum_partials` sums each
//     channel's row in a fixed order: no atomics, the same bytes on
//     every call and under CUDA graph capture.
// Windows wider than the register rings (local_size > 11) take
// `bwd_wide`: the same blocks and d_bias reduction, the windows read
// from memory (O(local_size^2) reads, L1/L2 hits), the same operations
// in the same order.
// ---------------------------------------------------------------------------

namespace k4 {

constexpr int kTile = 128;    // spatial positions of a block, one a thread
constexpr int kStage = 8;     // channel rows (of x, of dy) a stage holds
constexpr int kStages = 3;    // stages in the ring: two in flight
constexpr int kBatch = 4;     // steps whose normalizers are taken together
static_assert(kStage % kBatch == 0, "a stage is whole batches");

template <typename T>
struct Row {  // a staged row: the 16-byte words that cover kTile elements
  static constexpr int kWords = kTile * (int)sizeof(T) / 16 + 1;
  static constexpr int kBytes = kWords * 16;
};

struct Args {
  const void* x;
  const float* bias;
  const void* dy;
  void* dx;
  float* partial;                  // (C, N * tiles) f32
  unsigned long long x_end, dy_end;  // one past each tensor's last byte
  int C, HW, tiles, run, runs, pad;
  long long parts;                 // N * tiles
  float coef, nbeta, nbeta1, k, coef2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// a 16-byte copy whose first `bytes` come from src (the rest are 0); the
// L2 fetches the whole 128-byte line, which the neighbouring words of the
// row (and the next tile) read next
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float from_smem(const unsigned char* p, float) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float from_smem(const unsigned char* p,
                                           __nv_bfloat16) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
// dx as stored, and the f32 value d_bias sums
__device__ __forceinline__ float store(float* p, float v) {
  *p = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 r = __float2bfloat16_rn(v);
  *p = r;
  return __bfloat162float(r);
}

// The normalizer's arithmetic: from the window sum `acc` of x'^2 at a
// channel j, with s = k + coef * acc, u = dy x' s^-beta / s and
// t = dy s^-beta; and dx from t, x'_c and the window sum of u.  In f32
// the plain version's (the TPU kernel's) operations in its order, as
// K2's kernel has them: s^-beta = expf(-beta logf s) and an IEEE
// division, so dx is the plain dx bit for bit (the conv2 weight gradient
// of AlexNet's fused step turns a change of 1e-7 in dx into 2e-3 of its
// max, and that step is held to 1e-4 of the plain step's).  bf16, whose
// dx is rounded to 8 bits, takes s^-beta and s^-beta-1 as the hardware's
// ex2 of a scaled lg2 s and a fused multiply-add: fewer instructions.
// What `Norm::pow` gives `Norm::ut`: f32 (s, s^-beta), bf16 (s^-beta-1,
// s^-beta).
struct Pow {
  float a, b;
};
template <bool EXACT>
struct Norm;
template <>
struct Norm<true> {
  static __device__ __forceinline__ Pow pow(float acc, float coef, float k,
                                            float nbeta, float) {
    const float s = __fadd_rn(k, __fmul_rn(coef, acc));
    return {s, expf(__fmul_rn(nbeta, logf(s)))};
  }
  static __device__ __forceinline__ void ut(Pow p, float d, float x,
                                            float& u, float& t) {
    u = __fdiv_rn(__fmul_rn(__fmul_rn(d, x), p.b), p.a);
    t = __fmul_rn(d, p.b);
  }
  static __device__ __forceinline__ float dx(float t, float coef2, float xc,
                                             float ws) {
    return __fsub_rn(t, __fmul_rn(__fmul_rn(coef2, xc), ws));
  }
};
template <>
struct Norm<false> {
  static __device__ __forceinline__ Pow pow(float acc, float coef, float k,
                                            float nbeta, float nbeta1) {
    const float l = lg2(__fmaf_rn(coef, acc, k));
    return {ex2(__fmul_rn(nbeta1, l)), ex2(__fmul_rn(nbeta, l))};
  }
  static __device__ __forceinline__ void ut(Pow p, float d, float x,
                                            float& u, float& t) {
    u = __fmul_rn(__fmul_rn(d, x), p.a);
    t = __fmul_rn(d, p.b);
  }
  static __device__ __forceinline__ float dx(float t, float coef2, float xc,
                                             float ws) {
    return __fmaf_rn(-__fmul_rn(coef2, xc), ws, t);
  }
};

// The block's place: sample n, tile, channel run [cs, ce).
struct Place {
  int n, tile, cs, ce, p0, len;
};
__device__ __forceinline__ Place place(const Args& a) {
  Place q;
  const int b = blockIdx.x;
  const int r = b % a.runs;
  const int nt = b / a.runs;
  q.tile = nt % a.tiles;
  q.n = nt / a.tiles;
  q.cs = r * a.run;
  q.ce = min(a.C, q.cs + a.run);
  q.p0 = q.tile * kTile;
  q.len = min(kTile, a.HW - q.p0);
  return q;
}

// The tile's sum of a stage's dx rows (`sums`: kStage rows of kTile
// values, 0 past the tile): thread t takes row t / 16, adds its eight
// values (two float4s) in a fixed order, then a butterfly over the 16
// threads of the row; the sum of channel c = c0 + s goes to
// partial[c][n * tiles + tile] when c is in [cs, ce).
static_assert(kStage * 16 == kTile, "16 threads a row of the reduction");
__device__ __forceinline__ void reduce_rows(const Args& a, const Place& q,
                                            const float (*sums)[kTile],
                                            int c0) {
  const int s = threadIdx.x >> 4, l = threadIdx.x & 15;
  const float4 u = reinterpret_cast<const float4*>(sums[s])[l];
  const float4 w = reinterpret_cast<const float4*>(sums[s])[l + 16];
  float v = __fadd_rn(__fadd_rn(__fadd_rn(u.x, u.y), __fadd_rn(u.z, u.w)),
                      __fadd_rn(__fadd_rn(w.x, w.y), __fadd_rn(w.z, w.w)));
#pragma unroll
  for (int m = 8; m; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  const int c = c0 + s;
  if (l == 0 && c >= q.cs && c < q.ce)
    a.partial[c * a.parts + (long long)q.n * a.tiles + q.tile] = v;
}

// db[c]: the sum of partial[c][0 .. parts) in a fixed order (a strided
// sum a thread, then a tree over the block), one block a channel.
__global__ void __launch_bounds__(256)
sum_partials(const float* __restrict__ partial, float* __restrict__ db,
             long long parts) {
  __shared__ float t[256];
  const float* row = partial + blockIdx.x * parts;
  float v = 0.f;
  for (long long i = threadIdx.x; i < parts; i += 256)
    v = __fadd_rn(v, row[i]);
  t[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int m = 128; m; m >>= 1) {
    if (threadIdx.x < m)
      t[threadIdx.x] = __fadd_rn(t[threadIdx.x], t[threadIdx.x + m]);
    __syncthreads();
  }
  if (threadIdx.x == 0) db[blockIdx.x] = t[0];
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <typename T, int PAD, bool DB>
__global__ void __launch_bounds__(kTile) bwd(const Args a) {
  constexpr int W = 2 * PAD + 1;
  constexpr int RB = Row<T>::kBytes;
  constexpr int RW = Row<T>::kWords;
  constexpr int kRows = 2 * kStage;          // a stage: x rows, then dy rows
  constexpr int kGroup = kTile / kRows;      // threads that copy one row
  constexpr int kCopies = (RW + kGroup - 1) / kGroup;
  __shared__ __align__(16) unsigned char rows[kStages][kRows][RB];
  __shared__ float bs[kStages][kStage];
  __shared__ __align__(16) float sums[DB ? 2 : 1][kStage][kTile];

  const Place q = place(a);
  const int tid = threadIdx.x;
  const int C = a.C, HW = a.HW;
  const long long slab = (long long)C * HW;
  const T* xn = static_cast<const T*>(a.x) + q.n * slab;
  const T* dyn = static_cast<const T*>(a.dy) + q.n * slab;
  const int i_begin = q.cs - 2 * PAD;  // x channel of the first step
  const int i_end = q.ce + 2 * PAD;    // past the last x channel needed
  const int n_st = (i_end - i_begin + kStage - 1) / kStage;

  // The copy.  Stage st holds x rows of channels i0 .. i0 + 7 (i0 =
  // i_begin + 8 st) and dy rows of i0 - PAD .. (dy_j is used at step
  // i = j + PAD).  Thread tid copies words g, g + kGroup, ... of row r
  // in every stage; a row's channel advances by kStage a stage and its
  // address by a multiple of 16 bytes (H*W * sizeof(T) is even), so the
  // offset of its first element in its first word is the same in every
  // stage.
  const int r = tid / kGroup, g = tid % kGroup;
  const bool r_x = r < kStage;
  int ch = i_begin + (r_x ? r : r - kStage - PAD);
  const int lo = r_x ? 0 : max(0, q.cs - PAD);
  const int hi = r_x ? min(C, i_end) : min(C, q.ce + PAD);
  const unsigned long long addr0 = (unsigned long long)(
      (r_x ? xn : dyn) + (long long)ch * HW + q.p0);
  const int nw = ((int)(addr0 & 15) + q.len * (int)sizeof(T) + 15) >> 4;
  const unsigned long long step =
      (unsigned long long)kStage * HW * sizeof(T);
  unsigned long long src = (addr0 & ~15ull) + 16ull * g;
  const unsigned long long end = r_x ? a.x_end : a.dy_end;
  const unsigned long long blank = (unsigned long long)(r_x ? a.x : a.dy);
  int bch = i_begin + tid;             // the bias entry of threads 0 .. 7

  auto issue = [&](int st) {  // called once a stage, in order
    unsigned char* dst = &rows[st % kStages][r][16 * g];
    const bool live = ch >= lo && ch < hi;
    const long long room = (long long)(end - src);
    const unsigned long long from = live ? src : blank;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int w = g + k * kGroup;
      if (k == kCopies - 1 && w >= RW) break;
      int bytes = live && w < nw ? 16 : 0;
      if (room < 16LL * RW)  // the tensor's last row: no byte past its end
        bytes = (int)min((long long)bytes,
                         max(0LL, room - 16LL * kGroup * k));
      cp16(dst + 16 * kGroup * k,
           (const void*)(from + 16ull * kGroup * k), bytes);
    }
    if (tid < kStage) {
      const bool b_live = bch >= 0 && bch < C && bch < i_end;
      cp4(&bs[st % kStages][tid], b_live ? a.bias + bch : a.bias,
          b_live ? 4 : 0);
    }
    ch += kStage;
    bch += kStage;
    src += step;
  };

  // The compute.  ox[s] / oy[s]: the byte offset of this thread's element
  // in the x / dy row of step s of a stage (the same in every stage).
  int ox[kStage], oy[kStage];
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const unsigned lx = (unsigned)(unsigned long long)(
        xn + (long long)(i_begin + s) * HW + q.p0) & 15;
    const unsigned ly = (unsigned)(unsigned long long)(
        dyn + (long long)(i_begin + s - PAD) * HW + q.p0) & 15;
    ox[s] = s * RB + (int)lx + tid * (int)sizeof(T);
    oy[s] = (kStage + s) * RB + (int)ly + tid * (int)sizeof(T);
  }
  const bool live_p = tid < q.len;
  const float coef = a.coef, k = a.k, nbeta = a.nbeta, nbeta1 = a.nbeta1,
              coef2 = a.coef2;
  float xr[W], sr[W], ur[W], tr[PAD + 1];
#pragma unroll
  for (int j = 0; j < W; ++j) xr[j] = sr[j] = ur[j] = 0.f;
#pragma unroll
  for (int j = 0; j <= PAD; ++j) tr[j] = 0.f;
  // dx of channel c = i - 2 PAD at step i: this thread's element
  T* dxp = static_cast<T*>(a.dx) + q.n * slab +
           (long long)(i_begin - 2 * PAD) * HW + q.p0 + tid;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) issue(st);
    commit();
  }
  for (int st = 0; st < n_st; ++st) {
    wait_pending<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < n_st) issue(st + kStages - 1);
    commit();
    if (DB && st > 0)
      reduce_rows(a, q, sums[(st - 1) & 1],
                  i_begin + (st - 1) * kStage - 2 * PAD);
    const unsigned char* sb = &rows[st % kStages][0][0];
    const float* bias_s = bs[st % kStages];
    float* sum_s = &sums[DB ? st & 1 : 0][0][tid];
    const int c0 = i_begin + st * kStage - 2 * PAD;
    // every step of the stage writes a dx of this block's run
    const bool whole = live_p && c0 >= q.cs && c0 + kStage <= q.ce;
    auto steps = [&](auto checked) {
      constexpr bool CHECK = decltype(checked)::value;
#pragma unroll
      for (int h = 0; h < kStage; h += kBatch) {
        // kBatch steps' normalizers first: their log / exp chains do not
        // depend on one another and overlap; then their divisions (in
        // f32 each a branch to the slow path) and dx
        Pow pw[kBatch];
        float xj[kBatch], xc[kBatch], dd[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = h + b;
          const float xv = from_smem(sb + ox[s], T());
          dd[b] = from_smem(sb + oy[s], T());
#pragma unroll
          for (int j = 0; j < W - 1; ++j) {
            xr[j] = xr[j + 1];
            sr[j] = sr[j + 1];
          }
          const float xp = fmaxf(__fadd_rn(xv, bias_s[s]), 0.f);
          xr[W - 1] = xp;
          sr[W - 1] = __fmul_rn(xp, xp);
          // step j = i - PAD: s_j from x'^2 over j +- PAD
          float acc = sr[PAD];
#pragma unroll
          for (int off = 1; off <= PAD; ++off) {
            acc = __fadd_rn(acc, sr[PAD - off]);
            acc = __fadd_rn(acc, sr[PAD + off]);
          }
          pw[b] = Norm<sizeof(T) == 4>::pow(acc, coef, k, nbeta, nbeta1);
          xj[b] = xr[PAD];
          xc[b] = xr[0];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = h + b;
#pragma unroll
          for (int j = 0; j < W - 1; ++j) ur[j] = ur[j + 1];
#pragma unroll
          for (int j = 0; j < PAD; ++j) tr[j] = tr[j + 1];
          Norm<sizeof(T) == 4>::ut(pw[b], dd[b], xj[b], ur[W - 1], tr[PAD]);
          // dx_c, c = i - 2 PAD: u over c +- PAD is the whole u ring
          float ws = ur[PAD];
#pragma unroll
          for (int off = 1; off <= PAD; ++off) {
            ws = __fadd_rn(ws, ur[PAD - off]);
            ws = __fadd_rn(ws, ur[PAD + off]);
          }
          float dxv = Norm<sizeof(T) == 4>::dx(tr[0], coef2, xc[b], ws);
          if (!(xc[b] > 0.f)) dxv = 0.f;
          float kept = 0.f;
          if (!CHECK || (live_p && c0 + s >= q.cs && c0 + s < q.ce))
            kept = store(dxp, dxv);
          if (DB) sum_s[s * kTile] = kept;
          dxp += HW;
        }
      }
    };
    if (whole)
      steps(Flag<false>());
    else
      steps(Flag<true>());
  }
  if (DB) {
    __syncthreads();
    reduce_rows(a, q, sums[(n_st - 1) & 1],
                i_begin + (n_st - 1) * kStage - 2 * PAD);
  }
}

// local_size > 11: each thread recomputes the windows it needs from
// memory, channel by channel, with the ring kernel's operations in its
// order; d_bias through the same shared rows, kStage channels at a time.
template <typename T, bool DB>
__global__ void __launch_bounds__(kTile) bwd_wide(const Args a) {
  __shared__ __align__(16) float sums[kStage][kTile];
  const Place q = place(a);
  const int tid = threadIdx.x;
  const int C = a.C, HW = a.HW, pad = a.pad;
  const long long slab = (long long)C * HW;
  const bool live_p = tid < q.len;
  const int p = q.p0 + (live_p ? tid : 0);
  const T* xp = static_cast<const T*>(a.x) + q.n * slab + p;
  const T* dyp = static_cast<const T*>(a.dy) + q.n * slab + p;
  T* dxp = static_cast<T*>(a.dx) + q.n * slab + p;
  auto xprime = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    return fmaxf(__fadd_rn(load_f32(xp + ch * HW), __ldg(a.bias + ch)),
                 0.f);
  };
  auto u_t = [&](int j, float& u, float& t) {
    u = t = 0.f;
    if (j < 0 || j >= C) return;
    const float xj = xprime(j);
    float acc = __fmul_rn(xj, xj);
    for (int off = 1; off <= pad; ++off) {
      const float lo = xprime(j - off), hi = xprime(j + off);
      acc = __fadd_rn(acc, __fmul_rn(lo, lo));
      acc = __fadd_rn(acc, __fmul_rn(hi, hi));
    }
    Norm<sizeof(T) == 4>::ut(
        Norm<sizeof(T) == 4>::pow(acc, a.coef, a.k, a.nbeta, a.nbeta1),
        load_f32(dyp + j * HW), xj, u, t);
  };
  for (int c0 = q.cs; c0 < q.ce; c0 += kStage) {
    for (int s = 0; s < kStage; ++s) {
      const int c = c0 + s;
      float kept = 0.f;
      if (live_p && c < q.ce) {
        float ws, tc, u, unused;
        u_t(c, ws, tc);
        for (int off = 1; off <= pad; ++off) {
          u_t(c - off, u, unused);
          ws = __fadd_rn(ws, u);
          u_t(c + off, u, unused);
          ws = __fadd_rn(ws, u);
        }
        const float xc = xprime(c);
        float dxv = Norm<sizeof(T) == 4>::dx(tc, a.coef2, xc, ws);
        if (!(xc > 0.f)) dxv = 0.f;
        kept = store(dxp + c * HW, dxv);
      }
      if (DB) sums[s][tid] = kept;
    }
    if (DB) {
      __syncthreads();
      reduce_rows(a, q, sums, c0);
      __syncthreads();
    }
  }
}

template <typename T, bool DB>
const void* kernel_of(int pad) {
  switch (pad) {
    case 0: return (const void*)bwd<T, 0, DB>;
    case 1: return (const void*)bwd<T, 1, DB>;
    case 2: return (const void*)bwd<T, 2, DB>;
    case 3: return (const void*)bwd<T, 3, DB>;
    case 4: return (const void*)bwd<T, 4, DB>;
    case 5: return (const void*)bwd<T, 5, DB>;
    default: return (const void*)bwd_wide<T, DB>;
  }
}
const void* kernel(int pad, int dtype, bool db) {
  if (dtype == 0)
    return db ? kernel_of<float, true>(pad) : kernel_of<float, false>(pad);
  return db ? kernel_of<__nv_bfloat16, true>(pad)
            : kernel_of<__nv_bfloat16, false>(pad);
}

}  // namespace k4

// ---------------------------------------------------------------------------
// K1, K3 (the forward) and K2 (the backward): the staged kernels
//
// K1 and K3 compute y = x' s^-beta, K2 the backward formulas of the
// section above with x' = x or relu(x) and, with a fused ReLU, the ReLU
// mask.
//
// What bounds them on the H100: memory, or the normalizer's arithmetic.
// The forward reads each element once and writes it once (8 bytes in
// f32, 4 in bf16), the backward reads x and dy and writes dx (12 in f32,
// 6 in bf16), for about 2 operations a byte against the card's ~20.  But
// the normalizer is kept exact: the forward's y is the plain version's
// bit for bit in both dtypes (y feeds every later layer, and in a bf16
// net a change of its rounding spreads through the layers after it), K2's
// f32 dx too (K2 shares its formula with K4, and the fused AlexNet step
// is held to 1e-4 of the plain step's).  The precise logf / expf, and in
// the backward the IEEE division, cost some forty instructions an
// element: in f32 about as long as the copies, in bf16 longer.
//
// What the design does about it:
//   * K4's staging: a block owns one sample n, a tile of TILE positions
//     (one a thread) and a run of channels [cs, ce), planned on the host
//     (ops/kernels.py `lrn_plan`: the tile 64, 96 or 128 wide, so that few
//     of a plane's positions are padding (13x13 = 169 takes two tiles of
//     96, 12 % of the slots idle, where 128 would leave 34 %); the runs
//     cut from the card's SM count and the kernel's occupancy, read once a
//     variant); the rows of the kStage channels a stage walks (the
//     forward's x rows, the backward's x and dy rows) reach shared memory
//     through a cp.async ring of 16-byte words (K4's `cp16`), three stages
//     in flight in the forward's ring of four, two in the backward's of
//     three, so the bytes in flight do not depend on the dtype or on how
//     many warps fit on an SM;
//   * a row may start anywhere: H*W is odd at 55x55, 27x27 and 13x13, and
//     a tensor may be a view (a Slice top, a Concat's gradient) that
//     starts at any element.  A row is copied as the 16-byte words that
//     cover it and read back at its offset in the first word; the offset
//     is the same in every stage (a stage moves a row by 8 H*W elements,
//     a multiple of 16 bytes).  No byte outside a tensor is read: the word
//     that would pass its end copies only the bytes inside it (cp.async's
//     src-size), and the one word that would start before its first byte
//     (a view off 16 bytes) is copied element by element.  Channels
//     outside [0, C) are zero-filled rows (K3's bias entries there are 0),
//     so the steps check no channel bound, and a stage whose outputs all
//     lie in the run stores unchecked;
//   * the steps walk the staged x channels i in order with register rings
//     and take window sums centre first, then -1/+1, -2/+2, ..., as the
//     TPU kernel's `_window_sum`.  The forward keeps x'^2 of i - 2 pad .. i
//     and x' of i - pad .. i and writes y_c for c = i - pad; the backward
//     is K4's body (x', x'^2, u and t = dy s^-beta rings, dx_c for
//     c = i - 2 pad, `k4::Norm`) without the bias and d_bias, and with a
//     whole stage's normalizers before its divisions (kBatch 8, where K4
//     takes 4: 1-2.5 % faster here, scripts/lrn_variants.py);
//   * the forward's normalizer: in f32 the plain version's operations
//     (`lrn_y`).  In bf16 the hardware's lg2 / ex2 (`lrn_y_fast`), which
//     round to the same bf16 value as `lrn_y` except within a few dozen
//     f32 ulps of a bf16 rounding midpoint: a y within four times the two
//     paths' error bound of one (about one y in 500), or whose s or power
//     lies outside the range that bound covers, parks its window sum and
//     x' in shared memory and is stored again with `lrn_y`'s y after the
//     stage, so y is still the plain y bit for bit, and the steps carry
//     no branch to the exact path;
//   * K2 takes no normalizer for the first 2 pad steps of a run, which
//     only fill the x' rings;
//   * offsets are 64-bit: any C*H*W; the plan keeps N x tiles x runs
//     under 2^31 blocks (a 1-D grid: any N).
// Windows wider than the register rings (local_size > 11) take
// `fwd_wide` / `bwd_wide`: the same blocks, the windows read from memory
// (L1/L2 hits), the same operations in the same order.
// ---------------------------------------------------------------------------

namespace staged {

using k4::commit;
using k4::cp16;
using k4::cp4;
using k4::ex2;
using k4::Flag;
using k4::from_smem;
using k4::lg2;
using k4::Norm;
using k4::Pow;
using k4::store;
using k4::wait_pending;

constexpr int kStage = 8;       // channels a stage walks
constexpr int kFwdStages = 4;   // the forward's ring: three stages in flight
constexpr int kBwdStages = 3;   // the backward's (x and dy rows): two
constexpr int kBatch = 8;       // backward steps whose normalizers go first
static_assert(kStage % kBatch == 0, "a stage is whole batches");

template <typename T, int TILE>
struct Row {  // a staged row: the 16-byte words that cover TILE elements
  static constexpr int kWords = TILE * (int)sizeof(T) / 16 + 1;
  static constexpr int kBytes = kWords * 16;
};

struct Args {
  unsigned long long x, x_end;     // first byte, one past the last
  unsigned long long dy, dy_end;   // K2's (0 for K1, K3)
  const float* bias;               // K3's (null for K1, K2)
  void* out;                       // y (K1, K3) or dx (K2)
  int C, HW, tiles, run, runs, pad;
  float coef, nbeta, nbeta1, k, coef2;
};

// The block's place: sample n, tile, channel run [cs, ce).
struct Place {
  int n, tile, cs, ce, p0, len;
};
template <int TILE>
__device__ __forceinline__ Place place(const Args& a) {
  Place q;
  const int b = blockIdx.x;
  const int r = b % a.runs;
  const int nt = b / a.runs;
  q.tile = nt % a.tiles;
  q.n = nt / a.tiles;
  q.cs = r * a.run;
  q.ce = min(a.C, q.cs + a.run);
  q.p0 = q.tile * TILE;
  q.len = min(TILE, a.HW - q.p0);
  return q;
}

// the address of element `off` (signed, in elements) of a tensor at `base`
template <typename T>
__device__ __forceinline__ unsigned long long at_elem(unsigned long long base,
                                                      long long off) {
  return base + (unsigned long long)(off * (long long)sizeof(T));
}

// One thread's part of the ring's copy.  A stage holds ROWS rows of TILE
// elements; kGroup = TILE / ROWS threads copy a row, thread g of the group
// words g, g + kGroup, ...  Channels outside [lo, hi) are zero-filled (a
// copy of 0 bytes from the aligned word at or below the tensor's start).
template <typename T, int TILE, int ROWS>
struct RowCopy {
  static constexpr int kWords = Row<T, TILE>::kWords;
  static constexpr int kGroup = TILE / ROWS;
  static constexpr int kCopies = (kWords + kGroup - 1) / kGroup;
  static_assert(TILE % ROWS == 0, "whole groups a row");
  unsigned long long src, begin, end, blank, step;
  int g, ch, lo, hi, nw;

  // `row`: the address of the row's first element in the first stage, of
  // channel `first`; [begin_, end_): the tensor's bytes
  __device__ __forceinline__ void init(unsigned long long row, int first,
                                       int lo_, int hi_, int len,
                                       unsigned long long begin_,
                                       unsigned long long end_, int g_,
                                       int HW) {
    nw = ((int)(row & 15) + len * (int)sizeof(T) + 15) >> 4;
    src = (row & ~15ull) + 16ull * g_;
    begin = begin_;
    end = end_;
    blank = begin_ & ~15ull;
    step = (unsigned long long)kStage * HW * sizeof(T);
    g = g_;
    ch = first;
    lo = lo_;
    hi = hi_;
  }
  // issue this thread's words of the next stage's row into `dst_row`
  __device__ __forceinline__ void issue(unsigned char* dst_row) {
    const bool live = ch >= lo && ch < hi;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) {
      const int w = g + c * kGroup;
      if (c == kCopies - 1 && w >= kWords) break;
      unsigned char* dst = dst_row + 16 * w;
      const unsigned long long at = src + 16ull * kGroup * c;
      const bool used = live && w < nw;  // a word of the row: at < end
      if (used && at < begin) {
        // the tensor's first word starts before its first byte (a view
        // off 16 bytes): its elements one by one (the bytes before the
        // tensor are never read back)
        for (unsigned long long b = begin; b < at + 16 && b < end;
             b += sizeof(T))
          *reinterpret_cast<T*>(dst + (b - at)) =
              *reinterpret_cast<const T*>(b);
        continue;
      }
      const int bytes = used ? (int)min(16ull, end - at) : 0;
      cp16(dst, (const void*)(used ? at : blank), bytes);
    }
    ch += kStage;
    src += step;
  }
};

// y = x' s^-beta, s = k + coef * acc, with the plain version's (the TPU
// kernel's) operations in its order, s^-beta = expf(-beta logf s): its
// f32 y bit for bit.
__device__ __forceinline__ float lrn_y(float acc, float x, float coef,
                                      float k, float nbeta) {
  const float s = __fadd_rn(k, __fmul_rn(coef, acc));
  return __fmul_rn(x, expf(__fmul_rn(nbeta, logf(s))));
}

// lrn_y for a bf16 output from the hardware's lg2 / ex2, and whether it
// rounds to the same bf16 value as lrn_y's (`sure`).  Their errors (lg2:
// 2^-22 absolute on [0.5, 2], 2 ulp elsewhere; ex2: 2 ulp), with logf's
// (1 ulp), expf's (2 ulp) and the roundings of both paths, keep this y
// within 10 + 2.8 beta + 4.8 |p| f32 ulps of lrn_y's, p = log2 s^-beta,
// for s normal and y finite.  `sure` holds where |p| < 1 (which fails
// for an s that is not normal: lg2 of 0, a subnormal, a negative or an
// infinite s is not finite), y is finite, and y lies more than
// `margin` = 4 x (15 + 2.8 beta) ulps, four times that bound, from a
// bf16 rounding midpoint (the low 16 bits 0x8000): all but about one y
// in 400.  With d = low - 0x8000, |d| > margin is (unsigned)(d + margin)
// > 2 margin.
__device__ __forceinline__ float lrn_y_fast(float acc, float x, float coef,
                                           float k, float nbeta, int margin,
                                           bool& sure) {
  const float s = __fadd_rn(k, __fmul_rn(coef, acc));
  const float p = __fmul_rn(nbeta, lg2(s));
  const float y = __fmul_rn(x, ex2(p));
  const unsigned d = (__float_as_uint(y) & 0xffffu) + (unsigned)(margin -
                                                                0x8000);
  sure = fabsf(p) < 1.f && fabsf(y) <= 3.0e38f && d > 2u * (unsigned)margin;
  return y;
}

// K1 (x' = x, or relu(x) with RELU) and K3 (x' = relu(x + bias), BIAS).
// A stage holds the x rows of channels i0 .. i0 + 7 of its steps i.
template <typename T, int TILE, int PAD, bool RELU, bool BIAS>
__global__ void __launch_bounds__(TILE) fwd(const Args a) {
  static_assert(!BIAS || RELU, "K3 fuses its ReLU");
  constexpr int W = 2 * PAD + 1;
  constexpr int RB = Row<T, TILE>::kBytes;
  using Copy = RowCopy<T, TILE, kStage>;
  __shared__ __align__(16) unsigned char rows[kFwdStages][kStage][RB];
  __shared__ float bs[kFwdStages][kStage];

  const Place q = place<TILE>(a);
  const int tid = threadIdx.x;
  const int C = a.C, HW = a.HW;
  const long long sample = (long long)q.n * C * HW + q.p0;
  const int i_begin = q.cs - PAD;  // x channel of the first step
  const int i_end = q.ce + PAD;    // past the last x channel needed
  const int n_st = (i_end - i_begin + kStage - 1) / kStage;

  const int r = tid / Copy::kGroup;
  Copy cp;
  cp.init(at_elem<T>(a.x, sample + (long long)(i_begin + r) * HW),
          i_begin + r, 0, min(C, i_end), q.len, a.x, a.x_end,
          tid % Copy::kGroup, HW);
  int bch = i_begin + tid;  // the bias entry threads 0 .. 7 copy (K3)
  auto issue = [&](int st) {  // called once a stage, in order
    cp.issue(&rows[st % kFwdStages][r][0]);
    if constexpr (BIAS) {
      if (tid < kStage) {
        const bool live = bch >= 0 && bch < C && bch < i_end;
        cp4(&bs[st % kFwdStages][tid], live ? a.bias + bch : a.bias,
            live ? 4 : 0);
      }
      bch += kStage;
    }
  };

  // ox[s]: the byte offset of this thread's element in row s of a stage
  // (the same in every stage)
  int ox[kStage];
#pragma unroll
  for (int s = 0; s < kStage; ++s)
    ox[s] = s * RB +
            (int)(at_elem<T>(a.x, sample + (long long)(i_begin + s) * HW) &
                  15) +
            tid * (int)sizeof(T);
  const bool live_p = tid < q.len;
  const float coef = a.coef, k = a.k, nbeta = a.nbeta;
  // bf16: a step whose fast y is not `sure` parks its window sum and x'
  // here and takes lrn_y's y after the stage, out of the steps' way
  __shared__ float fix[sizeof(T) == 2 ? kStage : 1][2][TILE];
  const int margin = 60 + (int)ceilf(11.2f * fabsf(nbeta));
  unsigned unsure = 0;
  float sr[W], xr[PAD + 1];
#pragma unroll
  for (int j = 0; j < W; ++j) sr[j] = 0.f;
#pragma unroll
  for (int j = 0; j <= PAD; ++j) xr[j] = 0.f;
  // y of channel c = i - PAD at step i: this thread's element
  T* yp = static_cast<T*>(a.out) + sample + (long long)(i_begin - PAD) * HW +
          tid;

#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < n_st) issue(st);
    commit();
  }
  for (int st = 0; st < n_st; ++st) {
    wait_pending<kFwdStages - 2>();
    __syncthreads();
    if (st + kFwdStages - 1 < n_st) issue(st + kFwdStages - 1);
    commit();
    const unsigned char* sb = &rows[st % kFwdStages][0][0];
    const float* bias_s = bs[st % kFwdStages];
    const int c0 = i_begin + st * kStage - PAD;  // y channel of step 0
    // every step of the stage writes a y of this block's run
    const bool whole = live_p && c0 >= q.cs && c0 + kStage <= q.ce;
    auto steps = [&](auto checked) {
      constexpr bool CHECK = decltype(checked)::value;
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        float v = from_smem(sb + ox[s], T());
        if constexpr (BIAS)
          v = fmaxf(__fadd_rn(v, bias_s[s]), 0.f);
        else if constexpr (RELU)
          v = fmaxf(v, 0.f);
#pragma unroll
        for (int j = 0; j < W - 1; ++j) sr[j] = sr[j + 1];
#pragma unroll
        for (int j = 0; j < PAD; ++j) xr[j] = xr[j + 1];
        sr[W - 1] = __fmul_rn(v, v);
        xr[PAD] = v;
        // y_c, c = i - PAD: x'^2 over c +- PAD is the whole ring (the
        // run's first 2 PAD steps only fill the rings)
        if (!CHECK || (live_p && c0 + s >= q.cs && c0 + s < q.ce)) {
          float acc = sr[PAD];
#pragma unroll
          for (int off = 1; off <= PAD; ++off) {
            acc = __fadd_rn(acc, sr[PAD - off]);
            acc = __fadd_rn(acc, sr[PAD + off]);
          }
          if constexpr (sizeof(T) == 4) {
            store(yp + (long long)s * HW, lrn_y(acc, xr[0], coef, k, nbeta));
          } else {
            bool sure;
            store(yp + (long long)s * HW,
                  lrn_y_fast(acc, xr[0], coef, k, nbeta, margin, sure));
            if (!sure) {
              fix[s][0][tid] = acc;
              fix[s][1][tid] = xr[0];
              unsure |= 1u << s;
            }
          }
        }
      }
    };
    if (whole)
      steps(Flag<false>());
    else
      steps(Flag<true>());
    if constexpr (sizeof(T) == 2) {
      if (unsure) {  // rare: y near a bf16 rounding midpoint
#pragma unroll
        for (int s = 0; s < kStage; ++s)
          if (unsure >> s & 1u)
            store(yp + (long long)s * HW,
                  lrn_y(fix[s][0][tid], fix[s][1][tid], coef, k, nbeta));
        unsure = 0;
      }
    }
    yp += (long long)kStage * HW;
  }
}

// K1 / K3 for local_size > 11: each thread sums each channel's window
// from memory, with the ring kernel's operations in its order.
template <typename T, int TILE, bool RELU, bool BIAS>
__global__ void __launch_bounds__(TILE) fwd_wide(const Args a) {
  const Place q = place<TILE>(a);
  const int tid = threadIdx.x;
  if (tid >= q.len) return;
  const int C = a.C, HW = a.HW, pad = a.pad;
  const long long off = (long long)q.n * C * HW + q.p0 + tid;
  const T* xp = reinterpret_cast<const T*>(a.x) + off;
  T* yp = static_cast<T*>(a.out) + off;
  auto xprime = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    float t = load_f32(xp + (long long)ch * HW);
    if constexpr (BIAS) t = __fadd_rn(t, __ldg(a.bias + ch));
    if constexpr (RELU) t = fmaxf(t, 0.f);
    return t;
  };
  for (int c = q.cs; c < q.ce; ++c) {
    const float xc = xprime(c);
    float acc = __fmul_rn(xc, xc);
    for (int o = 1; o <= pad; ++o) {
      const float lo = xprime(c - o), hi = xprime(c + o);
      acc = __fadd_rn(acc, __fmul_rn(lo, lo));
      acc = __fadd_rn(acc, __fmul_rn(hi, hi));
    }
    store(yp + (long long)c * HW, lrn_y(acc, xc, a.coef, a.k, a.nbeta));
  }
}

// K2.  A stage holds the x rows of channels i0 .. i0 + 7 and the dy rows
// of i0 - PAD .. i0 + 7 - PAD (dy_j is used at step i = j + PAD).
template <typename T, int TILE, int PAD, bool RELU>
__global__ void __launch_bounds__(TILE) bwd(const Args a) {
  constexpr int W = 2 * PAD + 1;
  constexpr int RB = Row<T, TILE>::kBytes;
  constexpr int kRows = 2 * kStage;  // a stage: x rows, then dy rows
  using Copy = RowCopy<T, TILE, kRows>;
  __shared__ __align__(16) unsigned char rows[kBwdStages][kRows][RB];

  const Place q = place<TILE>(a);
  const int tid = threadIdx.x;
  const int C = a.C, HW = a.HW;
  const long long sample = (long long)q.n * C * HW + q.p0;
  const int i_begin = q.cs - 2 * PAD;  // x channel of the first step
  const int i_end = q.ce + 2 * PAD;    // past the last x channel needed
  const int n_st = (i_end - i_begin + kStage - 1) / kStage;

  const int r = tid / Copy::kGroup;
  const bool r_x = r < kStage;
  Copy cp;
  {
    const int ch = i_begin + (r_x ? r : r - kStage - PAD);
    const unsigned long long base = r_x ? a.x : a.dy;
    cp.init(at_elem<T>(base, sample + (long long)ch * HW), ch,
            r_x ? 0 : max(0, q.cs - PAD),
            r_x ? min(C, i_end) : min(C, q.ce + PAD), q.len, base,
            r_x ? a.x_end : a.dy_end, tid % Copy::kGroup, HW);
  }

  // ox[s] / oy[s]: the byte offset of this thread's element in the x / dy
  // row of step s of a stage (the same in every stage)
  int ox[kStage], oy[kStage];
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int lx = (int)(at_elem<T>(a.x, sample +
                                             (long long)(i_begin + s) * HW) &
                         15);
    const int ly = (int)(at_elem<T>(a.dy, sample + (long long)(i_begin + s -
                                                                PAD) * HW) &
                         15);
    ox[s] = s * RB + lx + tid * (int)sizeof(T);
    oy[s] = (kStage + s) * RB + ly + tid * (int)sizeof(T);
  }
  const bool live_p = tid < q.len;
  const float coef = a.coef, k = a.k, nbeta = a.nbeta, nbeta1 = a.nbeta1,
              coef2 = a.coef2;
  float xr[W], sr[W], ur[W], tr[PAD + 1];
#pragma unroll
  for (int j = 0; j < W; ++j) xr[j] = sr[j] = ur[j] = 0.f;
#pragma unroll
  for (int j = 0; j <= PAD; ++j) tr[j] = 0.f;
  // dx of channel c = i - 2 PAD at step i: this thread's element
  T* dxp = static_cast<T*>(a.out) + sample +
           (long long)(i_begin - 2 * PAD) * HW + tid;

#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) {
    if (st < n_st) cp.issue(&rows[st % kBwdStages][r][0]);
    commit();
  }
  for (int st = 0; st < n_st; ++st) {
    wait_pending<kBwdStages - 2>();
    __syncthreads();
    if (st + kBwdStages - 1 < n_st)
      cp.issue(&rows[(st + kBwdStages - 1) % kBwdStages][r][0]);
    commit();
    const unsigned char* sb = &rows[st % kBwdStages][0][0];
    const int c0 = i_begin + st * kStage - 2 * PAD;
    // every step of the stage writes a dx of this block's run
    const bool whole = live_p && c0 >= q.cs && c0 + kStage <= q.ce;
    auto steps = [&](auto checked) {
      constexpr bool CHECK = decltype(checked)::value;
#pragma unroll
      for (int h = 0; h < kStage; h += kBatch) {
        // kBatch steps' normalizers first: their log / exp chains do not
        // depend on one another and overlap; then their divisions (in
        // f32 each a branch to the slow path) and dx
        Pow pw[kBatch];
        float xj[kBatch], xc[kBatch], dd[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = h + b;
          float xp = from_smem(sb + ox[s], T());
          if constexpr (RELU) xp = fmaxf(xp, 0.f);
          dd[b] = from_smem(sb + oy[s], T());
#pragma unroll
          for (int j = 0; j < W - 1; ++j) {
            xr[j] = xr[j + 1];
            sr[j] = sr[j + 1];
          }
          xr[W - 1] = xp;
          sr[W - 1] = __fmul_rn(xp, xp);
          // step j = i - PAD: s_j from x'^2 over j +- PAD
          float acc = sr[PAD];
#pragma unroll
          for (int off = 1; off <= PAD; ++off) {
            acc = __fadd_rn(acc, sr[PAD - off]);
            acc = __fadd_rn(acc, sr[PAD + off]);
          }
          // the run's first 2 PAD steps only fill the x' rings: no dx
          // reads their u or t (j < cs - PAD)
          if (CHECK && st * kStage + s < 2 * PAD)
            pw[b] = Pow{1.f, 0.f};
          else
            pw[b] = Norm<sizeof(T) == 4>::pow(acc, coef, k, nbeta, nbeta1);
          xj[b] = xr[PAD];
          xc[b] = xr[0];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = h + b;
#pragma unroll
          for (int j = 0; j < W - 1; ++j) ur[j] = ur[j + 1];
#pragma unroll
          for (int j = 0; j < PAD; ++j) tr[j] = tr[j + 1];
          Norm<sizeof(T) == 4>::ut(pw[b], dd[b], xj[b], ur[W - 1], tr[PAD]);
          // u_j and t_j are 0 outside [0, C), the zero-padded window (the
          // zero rows give 0 there too, unless s = k is 0)
          const int j = c0 + s + PAD;
          if (j < 0 || j >= C) ur[W - 1] = tr[PAD] = 0.f;
          // dx_c, c = i - 2 PAD: u over c +- PAD is the whole u ring
          float ws = ur[PAD];
#pragma unroll
          for (int off = 1; off <= PAD; ++off) {
            ws = __fadd_rn(ws, ur[PAD - off]);
            ws = __fadd_rn(ws, ur[PAD + off]);
          }
          float d = Norm<sizeof(T) == 4>::dx(tr[0], coef2, xc[b], ws);
          if constexpr (RELU) {
            if (!(xc[b] > 0.f)) d = 0.f;
          }
          if (!CHECK || (live_p && c0 + s >= q.cs && c0 + s < q.ce))
            store(dxp, d);
          dxp += HW;
        }
      }
    };
    if (whole)
      steps(Flag<false>());
    else
      steps(Flag<true>());
  }
}

// K2 for local_size > 11: each thread recomputes the windows it needs
// from memory, channel by channel, with the ring kernel's operations in
// its order.
template <typename T, int TILE, bool RELU>
__global__ void __launch_bounds__(TILE) bwd_wide(const Args a) {
  const Place q = place<TILE>(a);
  const int tid = threadIdx.x;
  if (tid >= q.len) return;
  const int C = a.C, HW = a.HW, pad = a.pad;
  const long long off = (long long)q.n * C * HW + q.p0 + tid;
  const T* xp = reinterpret_cast<const T*>(a.x) + off;
  const T* dyp = reinterpret_cast<const T*>(a.dy) + off;
  T* dxp = static_cast<T*>(a.out) + off;
  auto xprime = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    const float t = load_f32(xp + (long long)ch * HW);
    return RELU ? fmaxf(t, 0.f) : t;
  };
  auto u_t = [&](int j, float& u, float& t) {
    u = t = 0.f;
    if (j < 0 || j >= C) return;
    const float xj = xprime(j);
    float acc = __fmul_rn(xj, xj);
    for (int o = 1; o <= pad; ++o) {
      const float lo = xprime(j - o), hi = xprime(j + o);
      acc = __fadd_rn(acc, __fmul_rn(lo, lo));
      acc = __fadd_rn(acc, __fmul_rn(hi, hi));
    }
    Norm<sizeof(T) == 4>::ut(
        Norm<sizeof(T) == 4>::pow(acc, a.coef, a.k, a.nbeta, a.nbeta1),
        load_f32(dyp + (long long)j * HW), xj, u, t);
  };
  for (int c = q.cs; c < q.ce; ++c) {
    float ws, tc, u, unused;
    u_t(c, ws, tc);
    for (int o = 1; o <= pad; ++o) {
      u_t(c - o, u, unused);
      ws = __fadd_rn(ws, u);
      u_t(c + o, u, unused);
      ws = __fadd_rn(ws, u);
    }
    const float xc = xprime(c);
    float d = Norm<sizeof(T) == 4>::dx(tc, a.coef2, xc, ws);
    if (RELU && !(xc > 0.f)) d = 0.f;
    store(dxp + (long long)c * HW, d);
  }
}

// The kernels by window: the register rings up to pad 5, the
// runtime-window kernels above.
template <typename T, int TILE, bool RELU, bool BIAS>
const void* fwd_of(int pad) {
  switch (pad) {
    case 0: return (const void*)fwd<T, TILE, 0, RELU, BIAS>;
    case 1: return (const void*)fwd<T, TILE, 1, RELU, BIAS>;
    case 2: return (const void*)fwd<T, TILE, 2, RELU, BIAS>;
    case 3: return (const void*)fwd<T, TILE, 3, RELU, BIAS>;
    case 4: return (const void*)fwd<T, TILE, 4, RELU, BIAS>;
    case 5: return (const void*)fwd<T, TILE, 5, RELU, BIAS>;
    default: return (const void*)fwd_wide<T, TILE, RELU, BIAS>;
  }
}
template <typename T, int TILE, bool RELU>
const void* bwd_of(int pad) {
  switch (pad) {
    case 0: return (const void*)bwd<T, TILE, 0, RELU>;
    case 1: return (const void*)bwd<T, TILE, 1, RELU>;
    case 2: return (const void*)bwd<T, TILE, 2, RELU>;
    case 3: return (const void*)bwd<T, TILE, 3, RELU>;
    case 4: return (const void*)bwd<T, TILE, 4, RELU>;
    case 5: return (const void*)bwd<T, TILE, 5, RELU>;
    default: return (const void*)bwd_wide<T, TILE, RELU>;
  }
}
// which: 1 = K1, 2 = K2, 3 = K3
template <typename T, int TILE>
const void* of_tile(int which, int pad, bool relu) {
  switch (which) {
    case 1: return relu ? fwd_of<T, TILE, true, false>(pad)
                        : fwd_of<T, TILE, false, false>(pad);
    case 2: return relu ? bwd_of<T, TILE, true>(pad)
                        : bwd_of<T, TILE, false>(pad);
    case 3: return fwd_of<T, TILE, true, true>(pad);
    default: return nullptr;
  }
}
template <typename T>
const void* of_dtype(int which, int pad, int tile, bool relu) {
  switch (tile) {
    case 64: return of_tile<T, 64>(which, pad, relu);
    case 96: return of_tile<T, 96>(which, pad, relu);
    case 128: return of_tile<T, 128>(which, pad, relu);
    default: return nullptr;
  }
}
// null for an unknown kernel, tile or dtype
const void* kernel(int which, int local_size, int tile, int dtype,
                   bool relu) {
  if (local_size <= 0) return nullptr;
  if (dtype == 0) return of_dtype<float>(which, local_size / 2, tile, relu);
  if (dtype == 1)
    return of_dtype<__nv_bfloat16>(which, local_size / 2, tile, relu);
  return nullptr;
}

// One launch on the host's plan (`tile` positions and `run` channels a
// block).
int launch(int which, const void* x, const float* bias, const void* dy,
           void* out, int N, int C, int HW, int local_size, float coef,
           float nbeta, float nbeta1, float k, float coef2, int relu,
           int tile, int run, int dtype, void* stream) {
  const void* fn = kernel(which, local_size, tile, dtype, relu != 0);
  const unsigned long long size = dtype == 0 ? 4 : 2;
  const unsigned long long xa = (unsigned long long)x,
                           dya = (unsigned long long)dy;
  if (fn == nullptr || x == nullptr || out == nullptr ||
      (which == 2) != (dy != nullptr) || (which == 3) != (bias != nullptr) ||
      N <= 0 || C <= 0 || HW <= 0 || run <= 0 || run > C ||
      ((xa | dya | (unsigned long long)out) & (size - 1)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (HW + tile - 1) / tile;
  const long long runs = (C + run - 1) / run;
  const long long blocks = (long long)N * tiles * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned long long bytes = (unsigned long long)N * C * HW * size;
  Args a{xa, xa + bytes, dya, dy ? dya + bytes : 0ull, bias, out,
         C, HW, (int)tiles, run, (int)runs, local_size / 2,
         coef, nbeta, nbeta1, k, coef2};
  void* params[] = {&a};
  cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(tile), params, 0,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace staged

}  // namespace

// K1: y = lrn(x) (or lrn(relu(x)) with fuse_relu) on the host's plan:
// `tile` positions a block (64, 96 or 128) and `run` channels a block
// (ops/kernels.py `lrn_plan`).  x and y may start at any element.  coef
// is alpha / local_size, nbeta -beta (rounded from the host's double, as
// the plain version's scalar is); dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() of the launch (0 on success) or
// cudaErrorInvalidValue for refused arguments.
extern "C" int cos_lrn_fwd(const void* x, void* y, int N, int C, int HW,
                           int local_size, float coef, float nbeta, float k,
                           int fuse_relu, int tile, int run, int dtype,
                           void* stream) {
  return staged::launch(1, x, nullptr, nullptr, y, N, C, HW, local_size,
                        coef, nbeta, 0.f, k, 0.f, fuse_relu, tile, run,
                        dtype, stream);
}

// K3: y = lrn(relu(x + bias)), the bias an f32 column of C; the plan and
// the rest as for cos_lrn_fwd.
extern "C" int cos_bias_relu_lrn_fwd(const void* x, const float* bias, void* y,
                                     int N, int C, int HW, int local_size,
                                     float coef, float nbeta, float k,
                                     int tile, int run, int dtype,
                                     void* stream) {
  return staged::launch(3, x, bias, nullptr, y, N, C, HW, local_size, coef,
                        nbeta, 0.f, k, 0.f, 1, tile, run, dtype, stream);
}

// K2: dx of the across-channel LRN (optionally of lrn(relu(x))) for the
// upstream gradient dy, on the host's plan as for cos_lrn_fwd; x, dy and
// dx may start at any element.  coef2 is 2 * alpha * beta / local_size,
// nbeta1 -beta - 1 (bf16 uses it; f32 uses nbeta alone); the rest as for
// cos_lrn_fwd.
extern "C" int cos_lrn_bwd(const void* x, const void* dy, void* dx, int N,
                           int C, int HW, int local_size, float coef,
                           float nbeta, float nbeta1, float k, float coef2,
                           int fuse_relu, int tile, int run, int dtype,
                           void* stream) {
  if (dy == nullptr) return (int)cudaErrorInvalidValue;
  return staged::launch(2, x, nullptr, dy, dx, N, C, HW, local_size, coef,
                        nbeta, nbeta1, k, coef2, fuse_relu, tile, run, dtype,
                        stream);
}

// Blocks of K1 (`kernel` 1), K2 (2) or K3 (3) for `local_size`, `tile`,
// `dtype` and `fuse_relu` that fit on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the host's launch
// plan; a negative cudaError on failure.
extern "C" int cos_lrn_occupancy(int kernel, int local_size, int tile,
                                 int dtype, int fuse_relu) {
  const void* fn =
      staged::kernel(kernel, local_size, tile, dtype, fuse_relu != 0);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, tile, 0);
  return e != cudaSuccess ? -(int)e : blocks;
}

// Blocks of the K4 kernel for `local_size` and `dtype` (with d_bias's
// sums when `db` is 1) that fit on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the host's launch
// plan; a negative cudaError on failure.
extern "C" int cos_bias_relu_lrn_bwd_occupancy(int local_size, int dtype,
                                               int db) {
  if (local_size <= 0 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  const void* fn = k4::kernel(local_size / 2, dtype, db != 0);
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, k4::kTile, 0);
  return e != cudaSuccess ? -(int)e : blocks;
}

// K4: dx of lrn(relu(x + bias)) with respect to x (and to x + bias), and
// db, its f32 sum over (n, h, w).  `partial` is (C, N * tiles) f32
// scratch: partial[c][n * tiles + t] is the sum of dx[n, c] over the
// t-th tile of k4::kTile positions, summed into db by a second kernel.
// With `partial` and `db` both null the kernel writes dx alone, without
// d_bias's sums: the dx-only cost that chip_smoke.py and
// scripts/k4_variants.py time the fusion against (the port's wrapper
// always passes both).  The launch plan (tiles, run: channels a block)
// comes from the host; x and dy must be 16-byte aligned and a sample's
// C*H*W below 2^31 elements.  nbeta and nbeta1 are -beta and -beta - 1
// (rounded from the host's doubles, as the plain version's scalars are;
// f32 uses nbeta alone); coef, coef2 and the return value as for
// cos_lrn_bwd.
extern "C" int cos_bias_relu_lrn_bwd(const void* x, const float* bias,
                                     const void* dy, void* dx,
                                     float* partial, float* db, int N,
                                     int C, int HW,
                                     int local_size, float coef,
                                     float nbeta, float nbeta1, float k,
                                     float coef2, int tiles, int run,
                                     int dtype, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || local_size <= 0 || run <= 0 ||
      run > C || (long long)C * HW > 0x7fffffffLL ||
      tiles != (HW + k4::kTile - 1) / k4::kTile ||
      ((unsigned long long)x | (unsigned long long)dy) & 15 ||
      (partial == nullptr) != (db == nullptr) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int runs = (C + run - 1) / run;
  const long long blocks = (long long)N * tiles * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned long long bytes =
      (unsigned long long)N * C * HW * (dtype == 0 ? 4 : 2);
  k4::Args a{x, bias, dy, dx, partial,
             (unsigned long long)x + bytes, (unsigned long long)dy + bytes,
             C, HW, tiles, run, runs, local_size / 2, (long long)N * tiles,
             coef, nbeta, nbeta1, k, coef2};
  const bool with_db = partial != nullptr;
  const void* fn = k4::kernel(a.pad, dtype, with_db);
  void* params[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(k4::kTile), params, 0,
                   s);
  const int err = (int)cudaGetLastError();
  if (err || !with_db) return err;
  k4::sum_partials<<<C, 256, 0, s>>>(partial, db, a.parts);
  return (int)cudaGetLastError();
}
