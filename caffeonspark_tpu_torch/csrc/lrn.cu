// Caffe across-channel LRN, forward and backward, for Hopper (sm_90a),
// NCHW layout.
//
// Replaces (caffeonspark_tpu/ops/pallas_kernels.py):
//   * `_lrn_fwd_call` (public `lrn_across_channels`, optional fuse_relu)
//     -> entry point `cos_lrn_fwd`;
//   * `_bias_lrn_fwd_call` (public `bias_relu_lrn_across_channels`, the
//     conv-stem epilogue lrn(relu(x + bias))) -> `cos_bias_relu_lrn_fwd`;
//   * `_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel`) -> `cos_lrn_bwd`;
//   * `_bias_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel_bias`, and the
//     channel sum of its dx that XLA reduces after it)
//     -> `cos_bias_relu_lrn_bwd`: dx and d_bias in one pass (its own
//     design, in the last section below).
//
//   y[n,c,p] = x'[n,c,p] * exp(-beta * log(k + alpha/n * S[n,c,p]))
//   S[n,c,p] = sum over |j - c| <= local_size/2 of x'[n,j,p]^2
//   x' = x, relu(x) or relu(x + bias[c]) (compile-time variants).
//
// Forward (the backward section further down has its own notes).
// What bounds it on the H100: memory.  Each element is read once and
// written once (8 bytes in f32, 4 in bf16) for ~15 f32 operations, about
// 2 operations per byte against the card's ~20 f32 operations per byte
// of HBM bandwidth.  At B=64 the CaffeNet norm1 pass moves 35.8 MB:
// about 10.7 us at 3.35 TB/s.
//
// What the design does about it:
//   * one thread owns one (n, h*w) position and walks a run of channels,
//     so a warp's loads and stores of one channel plane are 32
//     neighbouring addresses (coalesced along H*W in NCHW);
//   * the 2*pad+1 window of x' values lives in a register ring shifted by
//     one channel per step: inside its run a thread loads each element
//     once and writes only y;
//   * grid.x walks (n, block of h*w) pairs, so any N fits (no 65,535
//     cap of grid.y); the channel axis is cut into runs (grid.y) so that
//     layers with a small H*W (norm2: 13x13) still launch enough blocks
//     to cover the SMs; a run re-reads only its 2*pad halo channels,
//     which the neighbouring run also reads (an L2 hit in the common
//     case);
//   * windows up to local_size 11 are compile-time variants with the
//     register ring; wider ones take one runtime-window variant that
//     reads each window from memory, with the same operations in the
//     same order (any local_size, as the Pallas LRN takes);
//   * the window sum is taken directly from the ring in the order of the
//     TPU kernel's `_window_sum` (centre, then -1/+1, -2/+2, ...) rather
//     than as a running add/subtract, which would drift from it;
//   * channels are loaded kUnroll at a time ahead of their use, so each
//     thread keeps several independent loads in flight;
//   * math is f32 for f32 and bf16 I/O alike (an f32 normalizer for
//     bf16, as the TPU kernel does); mul/add use the _rn intrinsics so
//     nvcc does not contract them into FMAs that the plain PyTorch
//     version does not perform.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int PAD, bool RELU, bool BIAS>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
               T* __restrict__ y, int C, int HW, int hwb, int run,
               float coef, float neg_beta, float k) {
  const int n = blockIdx.x / hwb;
  const int p = (blockIdx.x - n * hwb) * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t plane = (int64_t)HW;
  const T* xp = x + (int64_t)n * C * plane + p;
  T* yp = y + (int64_t)n * C * plane + p;
  const int cs = blockIdx.y * run;
  const int ce = min(C, cs + run);
  constexpr int W = 2 * PAD + 1;

  // x' of channel ch (0 outside [0, C): the zero-padded channel window)
  auto load = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    float t = load_f32(xp + ch * plane);
    if (BIAS) t = __fadd_rn(t, __ldg(bias + ch));
    if (RELU) t = fmaxf(t, 0.f);
    return t;
  };

  // ring[j] holds x' of channel c - PAD + j for j < W - 1; the value of
  // channel c + PAD arrives from the prefetched block `nx`
  float ring[W];
#pragma unroll
  for (int j = 0; j < W - 1; ++j) ring[j] = load(cs + j - PAD);

  for (int c0 = cs; c0 < ce; c0 += kUnroll) {
    float nx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) nx[u] = load(c0 + u + PAD);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ring[W - 1] = nx[u];
      const int c = c0 + u;
      if (c < ce) {
        float acc = __fmul_rn(ring[PAD], ring[PAD]);
#pragma unroll
        for (int off = 1; off <= PAD; ++off) {
          acc = __fadd_rn(acc, __fmul_rn(ring[PAD - off], ring[PAD - off]));
          acc = __fadd_rn(acc, __fmul_rn(ring[PAD + off], ring[PAD + off]));
        }
        const float scale = __fadd_rn(k, __fmul_rn(coef, acc));
        const float f = expf(__fmul_rn(neg_beta, logf(scale)));
        store_f32(yp + c * plane, __fmul_rn(ring[PAD], f));
      }
#pragma unroll
      for (int j = 0; j < W - 1; ++j) ring[j] = ring[j + 1];
    }
  }
}

// Channel run length: the whole C when the (HW, N) grid alone already
// has about four blocks per SM, else the shortest run (a multiple of
// kUnroll, at least 4 * pad so the halo stays a minor share) that gets
// there.
int channel_run(int N, int C, int HW, int pad) {
  int sms = 132, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (int64_t)((HW + kThreads - 1) / kThreads) * N;
  const int64_t want = 4LL * sms;
  if (blocks >= want) return C;
  const int64_t runs = (want + blocks - 1) / blocks;
  int run = (int)((C + runs - 1) / runs);
  run = max(run, max(kUnroll, 4 * pad));
  run = (run + kUnroll - 1) / kUnroll * kUnroll;
  return min(run, C);
}

template <typename T, int PAD, bool RELU, bool BIAS>
int launch(const void* x, const float* bias, void* y, int N, int C, int HW,
           float coef, float neg_beta, float k, cudaStream_t s) {
  const int run = channel_run(N, C, HW, PAD);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_fwd_kernel<T, PAD, RELU, BIAS><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<T*>(y), C, HW, hwb, run,
      coef, neg_beta, k);
  return (int)cudaGetLastError();
}

// Windows wider than the register ring's (local_size > 11): a thread
// sums each channel's window straight from memory (2 pad + 1 reads of
// its column, neighbours' reads L1/L2 hits), in the same order and with
// the same operations as the ring, so the two agree bit for bit.
template <typename T, bool RELU, bool BIAS>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    T* __restrict__ y, int C, int HW, int hwb, int run,
                    int pad, float coef, float neg_beta, float k) {
  const int n = blockIdx.x / hwb;
  const int p = (blockIdx.x - n * hwb) * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t plane = (int64_t)HW;
  const T* xp = x + (int64_t)n * C * plane + p;
  T* yp = y + (int64_t)n * C * plane + p;
  const int cs = blockIdx.y * run;
  const int ce = min(C, cs + run);
  auto load = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    float t = load_f32(xp + ch * plane);
    if (BIAS) t = __fadd_rn(t, __ldg(bias + ch));
    if (RELU) t = fmaxf(t, 0.f);
    return t;
  };
  for (int c = cs; c < ce; ++c) {
    const float xc = load(c);
    float acc = __fmul_rn(xc, xc);
    for (int off = 1; off <= pad; ++off) {
      const float a = load(c - off), b = load(c + off);
      acc = __fadd_rn(acc, __fmul_rn(a, a));
      acc = __fadd_rn(acc, __fmul_rn(b, b));
    }
    const float scale = __fadd_rn(k, __fmul_rn(coef, acc));
    const float f = expf(__fmul_rn(neg_beta, logf(scale)));
    store_f32(yp + c * plane, __fmul_rn(xc, f));
  }
}

template <typename T, bool RELU, bool BIAS>
int launch_wide(int pad, const void* x, const float* bias, void* y, int N,
                int C, int HW, float coef, float neg_beta, float k,
                cudaStream_t s) {
  const int run = channel_run(N, C, HW, pad);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_fwd_wide_kernel<T, RELU, BIAS><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<T*>(y), C, HW, hwb, run,
      pad, coef, neg_beta, k);
  return (int)cudaGetLastError();
}

template <typename T, bool RELU, bool BIAS>
int dispatch_pad(int pad, const void* x, const float* bias, void* y, int N,
                 int C, int HW, float coef, float neg_beta, float k,
                 cudaStream_t s) {
  switch (pad) {
    case 0: return launch<T, 0, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    case 1: return launch<T, 1, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    case 2: return launch<T, 2, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    case 3: return launch<T, 3, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    case 4: return launch<T, 4, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    case 5: return launch<T, 5, RELU, BIAS>(x, bias, y, N, C, HW, coef, neg_beta, k, s);
    default: return launch_wide<T, RELU, BIAS>(pad, x, bias, y, N, C, HW, coef, neg_beta, k, s);
  }
}

int check_args(int N, int C, int HW, int local_size) {
  if (N <= 0 || C <= 0 || HW <= 0 || local_size <= 0 ||
      (int64_t)((HW + kThreads - 1) / kThreads) * N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------------------------------
// Backward (K2)
//
//   s_j  = k + alpha/n * S_j                   (recomputed from x', as the
//                                               TPU kernel recomputes it)
//   u_j  = dy_j * x'_j * s_j^-beta / s_j
//   dx_c = dy_c * s_c^-beta - (2 alpha beta / n) * x'_c * sum_W(u)_c
//   dx_c = 0 where x'_c <= 0 when a ReLU is fused.
//
// What bounds it on the H100: memory.  It reads x and dy and writes dx,
// 12 bytes per element in f32, for about 2 * local_size + 20 f32
// operations: ~2.5 operations per byte against ~20 the card can do per
// byte of HBM bandwidth.
//
// What the design does about it: the forward's thread-per-(n, h*w)
// walk over a channel run, with the window sums taken in the TPU
// kernel's order.  dx_c needs u over c +- pad, and each u_j needs x'
// over j +- pad, so a thread reads x' 2 * pad channels ahead of the dx
// it writes.  It keeps three register rings, shifted by one channel per
// step j:
//   xr: x' of channels j - pad .. j + pad (for S_j; xr[0] is x'_{j-pad})
//   ur: u  of channels j - 2 pad .. j     (the window of dx_{j-pad})
//   tr: dy * s^-beta of channels j - pad .. j
// and writes dx_c for c = j - pad.  A channel run [cs, ce) therefore
// steps j over [cs - pad, ce + pad) and reads a halo of 2 * pad
// channels of x (pad of dy) on each side; u and t are 0 outside [0, C),
// as the zero-padded window of the TPU kernel has them.  mul/add/div
// use the _rn intrinsics, so nvcc contracts nothing into an FMA that
// the plain PyTorch version does not perform.
// ---------------------------------------------------------------------------

template <typename T, int PAD, bool RELU>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x,
               const T* __restrict__ dy, T* __restrict__ dx, int C, int HW,
               int hwb, int run, float coef, float neg_beta, float k,
               float coef2) {
  const int n = blockIdx.x / hwb;
  const int p = (blockIdx.x - n * hwb) * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t plane = (int64_t)HW;
  const int64_t base = (int64_t)n * C * plane + p;
  const T* xp = x + base;
  const T* dyp = dy + base;
  T* dxp = dx + base;
  const int cs = blockIdx.y * run;
  const int ce = min(C, cs + run);
  constexpr int W = 2 * PAD + 1;

  auto load_x = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    float t = load_f32(xp + ch * plane);
    if (RELU) t = fmaxf(t, 0.f);
    return t;
  };
  auto load_dy = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    return load_f32(dyp + ch * plane);
  };

  const int j_begin = cs - PAD;
  const int j_end = ce + PAD;
  float xr[W], ur[W], tr[PAD + 1];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) xr[i] = load_x(j_begin - PAD + i);
#pragma unroll
  for (int i = 0; i < W; ++i) ur[i] = 0.f;
#pragma unroll
  for (int i = 0; i <= PAD; ++i) tr[i] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kUnroll) {
    float nx[kUnroll], ndy[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      nx[u] = load_x(j0 + u + PAD);
      ndy[u] = load_dy(j0 + u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      xr[W - 1] = nx[u];
      float uj = 0.f, tj = 0.f;
      if (j >= 0 && j < C) {
        float acc = __fmul_rn(xr[PAD], xr[PAD]);
#pragma unroll
        for (int off = 1; off <= PAD; ++off) {
          acc = __fadd_rn(acc, __fmul_rn(xr[PAD - off], xr[PAD - off]));
          acc = __fadd_rn(acc, __fmul_rn(xr[PAD + off], xr[PAD + off]));
        }
        const float s = __fadd_rn(k, __fmul_rn(coef, acc));
        const float snb = expf(__fmul_rn(neg_beta, logf(s)));
        uj = __fdiv_rn(__fmul_rn(__fmul_rn(ndy[u], xr[PAD]), snb), s);
        tj = __fmul_rn(ndy[u], snb);
      }
      ur[W - 1] = uj;
      tr[PAD] = tj;
      const int c = j - PAD;
      if (c >= cs && c < ce) {
        float ws = ur[PAD];
#pragma unroll
        for (int off = 1; off <= PAD; ++off) {
          ws = __fadd_rn(ws, ur[PAD - off]);
          ws = __fadd_rn(ws, ur[PAD + off]);
        }
        const float xc = xr[0];
        float d = __fsub_rn(tr[0], __fmul_rn(__fmul_rn(coef2, xc), ws));
        if (RELU && !(xc > 0.f)) d = 0.f;
        store_f32(dxp + c * plane, d);
      }
#pragma unroll
      for (int i = 0; i < W - 1; ++i) {
        xr[i] = xr[i + 1];
        ur[i] = ur[i + 1];
      }
#pragma unroll
      for (int i = 0; i < PAD; ++i) tr[i] = tr[i + 1];
    }
  }
}

template <typename T, int PAD, bool RELU>
int launch_bwd(const void* x, const void* dy, void* dx,
               int N, int C, int HW, float coef, float neg_beta, float k,
               float coef2, cudaStream_t s) {
  const int run = channel_run(N, C, HW, PAD);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_bwd_kernel<T, PAD, RELU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), C, HW, hwb, run, coef, neg_beta, k, coef2);
  return (int)cudaGetLastError();
}

// The backward for windows wider than the ring's: dx_c from u_j and t_j
// of the channels j in c's window, each recomputed from its own window
// of x' (O(local_size^2) reads, L1/L2 hits), with the ring's operations
// in the ring's order.
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_wide_kernel(const T* __restrict__ x,
                    const T* __restrict__ dy, T* __restrict__ dx, int C,
                    int HW, int hwb, int run, int pad, float coef,
                    float neg_beta, float k, float coef2) {
  const int n = blockIdx.x / hwb;
  const int p = (blockIdx.x - n * hwb) * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t plane = (int64_t)HW;
  const int64_t base = (int64_t)n * C * plane + p;
  const T* xp = x + base;
  const T* dyp = dy + base;
  T* dxp = dx + base;
  const int cs = blockIdx.y * run;
  const int ce = min(C, cs + run);
  auto load_x = [&](int ch) -> float {
    if (ch < 0 || ch >= C) return 0.f;
    float t = load_f32(xp + ch * plane);
    if (RELU) t = fmaxf(t, 0.f);
    return t;
  };
  // u_j and t_j = dy_j * s_j^-beta (both 0 outside [0, C))
  auto u_t = [&](int j, float& u, float& tj) {
    u = tj = 0.f;
    if (j < 0 || j >= C) return;
    const float xj = load_x(j);
    float acc = __fmul_rn(xj, xj);
    for (int off = 1; off <= pad; ++off) {
      const float a = load_x(j - off), b = load_x(j + off);
      acc = __fadd_rn(acc, __fmul_rn(a, a));
      acc = __fadd_rn(acc, __fmul_rn(b, b));
    }
    const float s = __fadd_rn(k, __fmul_rn(coef, acc));
    const float snb = expf(__fmul_rn(neg_beta, logf(s)));
    const float d = load_f32(dyp + j * plane);
    u = __fdiv_rn(__fmul_rn(__fmul_rn(d, xj), snb), s);
    tj = __fmul_rn(d, snb);
  };
  for (int c = cs; c < ce; ++c) {
    float ws, tc, u, unused;
    u_t(c, ws, tc);
    for (int off = 1; off <= pad; ++off) {
      u_t(c - off, u, unused);
      ws = __fadd_rn(ws, u);
      u_t(c + off, u, unused);
      ws = __fadd_rn(ws, u);
    }
    const float xc = load_x(c);
    float d = __fsub_rn(tc, __fmul_rn(__fmul_rn(coef2, xc), ws));
    if (RELU && !(xc > 0.f)) d = 0.f;
    store_f32(dxp + c * plane, d);
  }
}

template <typename T, bool RELU>
int launch_bwd_wide(int pad, const void* x, const void* dy,
                    void* dx, int N, int C, int HW, float coef,
                    float neg_beta, float k, float coef2, cudaStream_t s) {
  const int run = channel_run(N, C, HW, pad);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_bwd_wide_kernel<T, RELU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), C, HW, hwb, run, pad, coef, neg_beta, k, coef2);
  return (int)cudaGetLastError();
}

template <typename T, bool RELU>
int dispatch_pad_bwd(int pad, const void* x,
                     const void* dy, void* dx, int N, int C, int HW,
                     float coef, float neg_beta, float k, float coef2,
                     cudaStream_t s) {
  switch (pad) {
    case 0: return launch_bwd<T, 0, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 1: return launch_bwd<T, 1, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 2: return launch_bwd<T, 2, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 3: return launch_bwd<T, 3, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 4: return launch_bwd<T, 4, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 5: return launch_bwd<T, 5, RELU>(x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    default: return launch_bwd_wide<T, RELU>(pad, x, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
  }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the
// launch (0 on success) or cudaErrorInvalidValue for refused arguments.
extern "C" int cos_lrn_fwd(const void* x, void* y, int N, int C, int HW,
                           int local_size, float coef, float beta, float k,
                           int fuse_relu, int dtype, void* stream) {
  int err = check_args(N, C, HW, local_size);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pad = local_size / 2;
  if (dtype == 0) {
    return fuse_relu
        ? dispatch_pad<float, true, false>(pad, x, nullptr, y, N, C, HW, coef, -beta, k, s)
        : dispatch_pad<float, false, false>(pad, x, nullptr, y, N, C, HW, coef, -beta, k, s);
  }
  if (dtype == 1) {
    return fuse_relu
        ? dispatch_pad<__nv_bfloat16, true, false>(pad, x, nullptr, y, N, C, HW, coef, -beta, k, s)
        : dispatch_pad<__nv_bfloat16, false, false>(pad, x, nullptr, y, N, C, HW, coef, -beta, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int cos_bias_relu_lrn_fwd(const void* x, const float* bias, void* y,
                                     int N, int C, int HW, int local_size,
                                     float coef, float beta, float k,
                                     int dtype, void* stream) {
  int err = check_args(N, C, HW, local_size);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pad = local_size / 2;
  if (dtype == 0)
    return dispatch_pad<float, true, true>(pad, x, bias, y, N, C, HW, coef, -beta, k, s);
  if (dtype == 1)
    return dispatch_pad<__nv_bfloat16, true, true>(pad, x, bias, y, N, C, HW, coef, -beta, k, s);
  return (int)cudaErrorInvalidValue;
}

// dx of the across-channel LRN (optionally of lrn(relu(x))).  coef is
// alpha / local_size, coef2 is 2 * alpha * beta / local_size.  dtype and
// return value as for cos_lrn_fwd.
extern "C" int cos_lrn_bwd(const void* x, const void* dy, void* dx, int N,
                           int C, int HW, int local_size, float coef,
                           float beta, float k, float coef2, int fuse_relu,
                           int dtype, void* stream) {
  int err = check_args(N, C, HW, local_size);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pad = local_size / 2;
  if (dtype == 0) {
    return fuse_relu
        ? dispatch_pad_bwd<float, true>(pad, x, dy, dx, N, C, HW, coef, -beta, k, coef2, s)
        : dispatch_pad_bwd<float, false>(pad, x, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  }
  if (dtype == 1) {
    return fuse_relu
        ? dispatch_pad_bwd<__nv_bfloat16, true>(pad, x, dy, dx, N, C, HW, coef, -beta, k, coef2, s)
        : dispatch_pad_bwd<__nv_bfloat16, false>(pad, x, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  }
  return (int)cudaErrorInvalidValue;
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
