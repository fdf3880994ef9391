// Caffe across-channel LRN, forward and backward, for Hopper (sm_90a),
// NCHW layout.
//
// Replaces (caffeonspark_tpu/ops/pallas_kernels.py):
//   * `_lrn_fwd_call` (public `lrn_across_channels`, optional fuse_relu)
//     -> entry point `cos_lrn_fwd`;
//   * `_bias_lrn_fwd_call` (public `bias_relu_lrn_across_channels`, the
//     conv-stem epilogue lrn(relu(x + bias))) -> `cos_bias_relu_lrn_fwd`;
//   * `_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel`) -> `cos_lrn_bwd`;
//   * `_bias_lrn_vjp_bwd` (kernel `_lrn_bwd_kernel_bias`)
//     -> `cos_bias_relu_lrn_bwd` (dx only; d_bias is its channel sum,
//     reduced by the caller as the TPU version reduces it in XLA).
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
// Backward (K2, K4)
//
//   s_j  = k + alpha/n * S_j                   (recomputed from x', as the
//                                               TPU kernel recomputes it)
//   u_j  = dy_j * x'_j * s_j^-beta / s_j
//   dx_c = dy_c * s_c^-beta - (2 alpha beta / n) * x'_c * sum_W(u)_c
//   dx_c = 0 where x'_c <= 0 when a ReLU (or bias + ReLU) is fused.
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

template <typename T, int PAD, bool RELU, bool BIAS>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
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
    if (BIAS) t = __fadd_rn(t, __ldg(bias + ch));
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

template <typename T, int PAD, bool RELU, bool BIAS>
int launch_bwd(const void* x, const float* bias, const void* dy, void* dx,
               int N, int C, int HW, float coef, float neg_beta, float k,
               float coef2, cudaStream_t s) {
  const int run = channel_run(N, C, HW, PAD);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_bwd_kernel<T, PAD, RELU, BIAS><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(dy),
      static_cast<T*>(dx), C, HW, hwb, run, coef, neg_beta, k, coef2);
  return (int)cudaGetLastError();
}

// The backward for windows wider than the ring's: dx_c from u_j and t_j
// of the channels j in c's window, each recomputed from its own window
// of x' (O(local_size^2) reads, L1/L2 hits), with the ring's operations
// in the ring's order.
template <typename T, bool RELU, bool BIAS>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ bias,
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
    if (BIAS) t = __fadd_rn(t, __ldg(bias + ch));
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

template <typename T, bool RELU, bool BIAS>
int launch_bwd_wide(int pad, const void* x, const float* bias, const void* dy,
                    void* dx, int N, int C, int HW, float coef,
                    float neg_beta, float k, float coef2, cudaStream_t s) {
  const int run = channel_run(N, C, HW, pad);
  const int hwb = (HW + kThreads - 1) / kThreads;
  dim3 grid(hwb * N, (C + run - 1) / run);
  lrn_bwd_wide_kernel<T, RELU, BIAS><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(dy),
      static_cast<T*>(dx), C, HW, hwb, run, pad, coef, neg_beta, k, coef2);
  return (int)cudaGetLastError();
}

template <typename T, bool RELU, bool BIAS>
int dispatch_pad_bwd(int pad, const void* x, const float* bias,
                     const void* dy, void* dx, int N, int C, int HW,
                     float coef, float neg_beta, float k, float coef2,
                     cudaStream_t s) {
  switch (pad) {
    case 0: return launch_bwd<T, 0, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 1: return launch_bwd<T, 1, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 2: return launch_bwd<T, 2, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 3: return launch_bwd<T, 3, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 4: return launch_bwd<T, 4, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    case 5: return launch_bwd<T, 5, RELU, BIAS>(x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
    default: return launch_bwd_wide<T, RELU, BIAS>(pad, x, bias, dy, dx, N, C, HW, coef, neg_beta, k, coef2, s);
  }
}

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
        ? dispatch_pad_bwd<float, true, false>(pad, x, nullptr, dy, dx, N, C, HW, coef, -beta, k, coef2, s)
        : dispatch_pad_bwd<float, false, false>(pad, x, nullptr, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  }
  if (dtype == 1) {
    return fuse_relu
        ? dispatch_pad_bwd<__nv_bfloat16, true, false>(pad, x, nullptr, dy, dx, N, C, HW, coef, -beta, k, coef2, s)
        : dispatch_pad_bwd<__nv_bfloat16, false, false>(pad, x, nullptr, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dx of lrn(relu(x + bias)) with respect to x (and to x + bias).
extern "C" int cos_bias_relu_lrn_bwd(const void* x, const float* bias,
                                     const void* dy, void* dx, int N, int C,
                                     int HW, int local_size, float coef,
                                     float beta, float k, float coef2,
                                     int dtype, void* stream) {
  int err = check_args(N, C, HW, local_size);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pad = local_size / 2;
  if (dtype == 0)
    return dispatch_pad_bwd<float, true, true>(pad, x, bias, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  if (dtype == 1)
    return dispatch_pad_bwd<__nv_bfloat16, true, true>(pad, x, bias, dy, dx, N, C, HW, coef, -beta, k, coef2, s);
  return (int)cudaErrorInvalidValue;
}
