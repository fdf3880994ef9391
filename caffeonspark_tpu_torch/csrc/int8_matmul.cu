// int8 x int8 -> int32 matrix product for Hopper (sm_90a):
//   C[m, n] = sum_k A[m, k] * B[n, k]   (A: (M, K), B: (N, K), row-major)
//
// Replaces: caffeonspark_tpu/ops/pallas_kernels.py `int8_matmul` (the
// `_int8_matmul_kernel` pallas_call under `int8_inner_product`, the
// quantized serving InnerProduct).  Unlike the TPU kernel there is no
// fallback shape: ragged M, N and K are masked here, so fc8's N=1000 and
// the batch buckets 1, 2 and 4 go through this kernel too.
//
// What bounds it on the H100: the weight read.  Serving batches are
// small (M <= 64), so e.g. fc6 at M=64 reads 37.7 MB of int8 weights
// (about 11.3 us at 3.35 TB/s) for 4.8 GOP (about 2.4 us at 1,979
// TOP/s): the kernel is bound by bytes, not by the tensor cores.
//
// What the design does about it:
//   * 64x64 output tiles, K walked in 64-byte slabs staged through
//     shared memory with 16-byte coalesced loads; the next slab is
//     loaded into registers while the current one is multiplied, so a
//     block keeps its loads in flight during the tensor-core work;
//   * mma.sync m16n8k32 s8*s8+s32 (4 warps, each a 32x32 sub-tile): A
//     and B fragments are 4-byte words of row-major A and B, read from
//     shared memory rows padded to 80 bytes (conflict-free);
//   * split-K across grid.z so that even N=1000 or M=1 launches several
//     blocks per SM and the whole card streams the weights; partial
//     sums meet in int32 atomics, which are exact and order-free, so the
//     result is bit-identical to a single-pass sum;
//   * rows past M/N and bytes past K are loaded as zeros (masking).
// wgmma/TMA pipelines are left for a later, faster version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;  // BK in int8 elements (bytes)
constexpr int LDS = BK + 16;              // padded shared-memory row stride
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 16-byte chunk (row `r`, bytes [k, k+16)) of a (rows, K) matrix,
// zero-filled past `rows` and past K.
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ g,
                                           int r, int rows, int k, int K) {
  int4 v = make_int4(0, 0, 0, 0);
  if (r >= rows || k >= K) return v;
  const int8_t* src = g + (int64_t)r * K + k;
  if (VEC) {  // K % 16 == 0 and 16-byte aligned base: whole chunk in range
    v = __ldg(reinterpret_cast<const int4*>(src));
  } else {
    int8_t* b = reinterpret_cast<int8_t*>(&v);
    const int n = min(16, K - k);
    for (int i = 0; i < n; ++i) b[i] = src[i];
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int32_t* __restrict__ C, int M, int N, int K,
               int ktiles_per_split, int atomic) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread-in-group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(ktiles, kt0 + ktiles_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // each tile is 64 rows x 4 chunks of 16 bytes: 2 chunks per thread
  int4 ra[2], rb[2];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads, r = q >> 2, kc = (q & 3) * 16;
      ra[i] = load_chunk<VEC>(A, m0 + r, M, kt * BK + kc, K);
      rb[i] = load_chunk<VEC>(B, n0 + r, N, kt * BK + kc, K);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  if (kt0 < kt1) fetch(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads, r = q >> 2, kc = (q & 3) * 16;
      *reinterpret_cast<int4*>(&As[r * LDS + kc]) = ra[i];
      *reinterpret_cast<int4*>(&Bs[r * LDS + kc]) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < kt1) fetch(kt + 1);  // next slab in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = &As[(wm + mi * 16 + g) * LDS + ks + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &Bs[(wn + ni * 8 + g) * LDS + ks + t * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                 b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + h * 8;
        const int c = n0 + wn + ni * 8 + t * 2;
        if (r >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= N) continue;
          int32_t* dst = C + (int64_t)r * N + c + e;
          if (atomic)
            atomicAdd(dst, acc[mi][ni][h * 2 + e]);
          else
            *dst = acc[mi][ni][h * 2 + e];
        }
      }
}

}  // namespace

// A: (M, K) int8, B: (N, K) int8, C: (M, N) int32, all row-major and
// contiguous.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cos_int8_matmul(const void* A, const void* B, void* C, int M,
                               int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int mblocks = (M + BM - 1) / BM, nblocks = (N + BN - 1) / BN;
  const int ktiles = (K + BK - 1) / BK;
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  // split K until about four blocks per SM stream the weights, keeping
  // at least two K slabs per split
  const int64_t mn = (int64_t)mblocks * nblocks;
  int splits = (int)((4LL * sms + mn - 1) / mn);
  splits = max(1, min(splits, ktiles / 2));
  const int per = (ktiles + splits - 1) / splits;
  splits = (ktiles + per - 1) / per;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = (K % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  dim3 grid(nblocks, mblocks, splits);
  if (vec)
    int8_mm_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
        static_cast<int32_t*>(C), M, N, K, per, splits > 1);
  else
    int8_mm_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
        static_cast<int32_t*>(C), M, N, K, per, splits > 1);
  return (int)cudaGetLastError();
}
