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
//   * a block owns an output tile of 128 or 256 columns (4 or 8 warps,
//     each 32 columns), every row of an M block (64, or 16 for M <= 16:
//     four or one 16-row m-tiles) and a range of K.  The weight tile
//     (128 or 256 rows x 128 bytes) and A's slab (the M block's rows x
//     128 bytes) of each K step stream through a ring of 6 (128
//     columns) or 3 (256 columns) stages in shared memory, filled by
//     16-byte `cp.async.cg` copies (no registers held) issued as many
//     steps ahead as the ring allows: 80 or 64 KB of weights in flight a
//     block, one block an SM, above the ~25-30 KB an SM that Little's
//     law asks at 3.35 TB/s;
//   * A is read once per K step of a block, from L2: a 256-column tile
//     reads 64 bytes of A for every 256 bytes of weights at M = 64.  A's
//     rows are not kept resident over several output tiles: at the
//     serving shapes (fc6-fc8) every block has one output tile, and the
//     shared memory goes to the ring;
//   * the product is `mma.sync.m16n8k32.s32.s8.s8` with `ldmatrix`
//     fragment loads (an int8 A or B fragment of m16n8k32 is the b16
//     fragment of an 8 x 16-byte matrix).  At M <= 64 the tensor cores
//     are busy a fifth of the time the weight stream takes, so
//     `mma.sync` does not hold the kernel back (`wgmma` would take the
//     products off the warps, and needs swizzled shared layouts);
//   * K is split over the z blocks of a thread-block cluster (at most 8)
//     so that a small N still spreads the weights over the whole card.
//     The split sums meet in distributed shared memory: each block of the
//     cluster leaves its int32 partial tile in its own shared memory,
//     the cluster synchronizes, and block q adds the q-th 1/S of the
//     tile from all S blocks' shared memory and writes it to C.  No
//     memset launch, no workspace, no atomics, no counters; int32 sums
//     are exact and their order is fixed, so C is bit-identical to a
//     single-pass sum;
//   * `plan` picks the tile width and the split for this card: the
//     fewest waves of the clusters that fit (cudaOccupancyMaxActive-
//     Clusters) times the bytes a block streams, ties to the narrower
//     tile and fewer splits;
//   * rows past M/N and bytes past K are loaded as zeros (masking); a K
//     that is not a multiple of 16, or an unaligned base, takes
//     synchronous byte loads into the same ring.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;        // K bytes a stage
constexpr int LDS = BK + 16;   // padded row stride of a stage (bytes)
constexpr int MAX_SPLITS = 8;  // a portable cluster

// A block of BN output columns has BN / 32 warps; its ring holds 6
// stages at 128 columns, 3 at 256 (the fastest of the ring depths tried
// on an H100 at each width)
__host__ __device__ constexpr int stages_for(int bn) {
  return bn == 128 ? 6 : 3;
}

// shared memory of a block: the ring of (weight tile, A slab) stages
constexpr size_t smem_bytes(int mt, int bn) {
  return (size_t)stages_for(bn) * (bn + 16 * mt) * LDS;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lane l gives the row address of 8 x 16-byte matrix l / 8 and receives
// bytes 4 (l % 4) .. +3 of row l / 4 of each: the m16n8k32 s8 fragments
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte chunk: row r (of `rows`) of a (rows, K) matrix, bytes
// [k, k + 16), zero past `rows` and past K.  VEC: K % 16 == 0 and
// aligned bases, so a chunk is all in range or all out (asynchronous);
// otherwise a synchronous byte copy.
template <bool VEC>
__device__ __forceinline__ void chunk(int8_t* s, const int8_t* __restrict__ g,
                                      int r, int rows, int k, int K) {
  const bool ok = r < rows && k < K;
  if (VEC) {
    cp_async16(s, ok ? g + (int64_t)r * K + k : g, ok);
  } else {
    int4 v = make_int4(0, 0, 0, 0);
    if (ok) {
      int8_t* b = reinterpret_cast<int8_t*>(&v);
      const int8_t* src = g + (int64_t)r * K + k;
      const int n = min(16, K - k);
      for (int i = 0; i < n; ++i) b[i] = src[i];
    }
    *reinterpret_cast<int4*>(s) = v;
  }
}

// grid (output tiles, M blocks, K splits), BN threads a block; with
// splits > 1 the launch makes the splits of a tile one cluster (1, 1,
// splits).  kr: the K steps of a split.
template <int MT, bool VEC, int BN>
__global__ void __launch_bounds__(BN)
int8_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int32_t* __restrict__ C, int M, int N, int K, int kr) {
  constexpr int kThreads = BN;              // a warp per 32 columns
  constexpr int STAGES = stages_for(BN);
  constexpr int ROWS = 16 * MT;
  constexpr int STAGE = (BN + ROWS) * LDS;  // bytes: weights, then A
  constexpr int LDR = BN + 4;               // partial tile row (int32)
  extern __shared__ int4 smem4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ROWS;
  const int splits = gridDim.z;
  const int ktiles = (K + BK - 1) / BK;
  const int k0 = blockIdx.z * kr * BK;
  const int kn = min(kr, ktiles - (int)blockIdx.z * kr);  // K steps here
  const int mrows = min(ROWS, M - m0);                     // valid rows
  const int8_t* Ab = A + (int64_t)m0 * K;
  const int8_t* Bb = B + (int64_t)n0 * K;

  auto issue = [&](int i) {
    if (i < kn) {
      int8_t* w = ring + (i % STAGES) * STAGE;
      int8_t* a = w + BN * LDS;
      const int k = k0 + i * BK;
#pragma unroll
      for (int u = 0; u < BN * BK / 16 / kThreads; ++u) {
        const int q = tid + u * kThreads;
        const int r = q / (BK / 16), c = (q % (BK / 16)) * 16;
        chunk<VEC>(w + r * LDS + c, Bb, r, N - n0, k + c, K);
      }
      for (int q = tid; q < ROWS * BK / 16; q += kThreads) {
        const int r = q / (BK / 16), c = (q % (BK / 16)) * 16;
        chunk<VEC>(a + r * LDS + c, Ab, r, mrows, k + c, K);
      }
    }
    cp_async_commit();
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  const int wn = warp * 32;  // the warp's columns of the tile
  const int li = lane >> 3, lr = lane & 7;
  for (int i = 0; i < kn; ++i) {
    cp_async_wait<STAGES - 2>();  // stage i has landed
    __syncthreads();              // ... for every thread; i - 1 is free
    issue(i + STAGES - 1);
    const int8_t* w = ring + (i % STAGES) * STAGE;
    const int8_t* a = w + BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)  // rows r / r+8, bytes k / k+16
        ldsm4(af[mi], a + (16 * mi + (li & 1) * 8 + lr) * LDS + kk +
                          (li >> 1) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n-tiles 2np, 2np+1
        uint32_t r4[4];
        ldsm4(r4, w + (wn + 16 * np + (li >> 1) * 8 + lr) * LDS + kk +
                      (li & 1) * 16);
        bf[2 * np][0] = r4[0];
        bf[2 * np][1] = r4[1];
        bf[2 * np + 1][0] = r4[2];
        bf[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  if (splits == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mi + g + 8 * (e >> 1);
          const int c = n0 + wn + 8 * ni + 2 * t + (e & 1);
          if (r < mrows && c < N)
            C[(int64_t)(m0 + r) * N + c] = acc[mi][ni][e];
        }
    return;
  }

  // split K: the partial tile into this block's shared memory, then each
  // block of the cluster sums its part of the tile over all the partials
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done with the ring
  int32_t* part = reinterpret_cast<int32_t*>(ring);  // [ROWS][LDR]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(part + (16 * mi + g + 8 * h) * LDR + wn +
                                 8 * ni + 2 * t) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cluster.sync();
  const int units = mrows * (BN / 4);  // int4 units of the valid rows
  const int q = (int)cluster.block_rank();
  const int u0 = (int)((int64_t)units * q / splits);
  const int u1 = (int)((int64_t)units * (q + 1) / splits);
  const bool vec4 = (N % 4) == 0;
  for (int u = u0 + tid; u < u1; u += kThreads) {
    const int r = u / (BN / 4), c = (u % (BN / 4)) * 4;
    int4 src[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits)
        src[s] = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(part + r * LDR + c, s));
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits) {
        sum.x += src[s].x;
        sum.y += src[s].y;
        sum.z += src[s].z;
        sum.w += src[s].w;
      }
    const int col = n0 + c;
    int32_t* dst = C + (int64_t)(m0 + r) * N + col;
    if (vec4 && col + 3 < N) {
      *reinterpret_cast<int4*>(dst) = sum;
    } else {
      const int v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < N) dst[e] = v[e];
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// How many blocks of one kernel fit without a cluster, and how many
// clusters of s blocks (s = 2..MAX_SPLITS), at its shared memory.
// Filled at the first call on a device.
struct Capacity {
  bool ready = false;
  int sms = 0;
  int blocks = 0;
  int clusters[MAX_SPLITS + 1] = {};
};
std::mutex cap_lock;
Capacity caps[64][2][2];  // device, m-tiles 1 / 4, 128 / 256 columns

template <int MT, int BN>
cudaLaunchConfig_t launch_config(dim3 grid, int splits,
                                 cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BN);
  cfg.dynamicSmemBytes = smem_bytes(MT, BN);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cfg;
}

template <int MT, bool VEC, int BN>
int capacity(Capacity& cap) {
  auto kern = int8_mm_kernel<MT, VEC, BN>;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MT, BN));
  if (err || cap.ready) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&cap.sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, BN, smem_bytes(MT, BN));
  if (err) return err;
  cap.blocks = per_sm * cap.sms;
  for (int s = 2; s <= MAX_SPLITS; ++s) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        launch_config<MT, BN>(dim3(1, 1, s), s, &attr, nullptr);
    int n = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err) return err;
    cap.clusters[s] = n;
  }
  cap.ready = true;
  return 0;
}

struct Plan {
  double cost = 1e300;
  int bn = 128, splits = 1, kr = 1;
};

// Fold the choices of one tile width into `best`: the least (waves of
// the blocks or clusters that fit, or blocks an SM) x (the bytes a block
// streams: weights, A's rows at half weight (from L2), and about three
// 16 KB stages of fill, drain and the cluster's exchange); ties to the
// narrower tile and fewer splits.
void plan(const Capacity& cap, int bn, int M, int N, int K, int rows,
          Plan* best) {
  const long long tiles =
      (long long)((N + bn - 1) / bn) * ((M + rows - 1) / rows);
  const int ktiles = (K + BK - 1) / BK;
  const double me = M < rows ? M : rows;
  for (int s = 1; s <= MAX_SPLITS && s <= ktiles; ++s) {
    const int kr = (ktiles + s - 1) / s;
    if ((ktiles + kr - 1) / kr != s) continue;  // a smaller s's kr
    const long long fit =
        s == 1 ? cap.blocks : (long long)cap.clusters[s] * s;
    if (fit <= 0) continue;
    const long long blocks = tiles * s;
    const long long waves = (blocks + fit - 1) / fit;
    const long long per_sm = (blocks + cap.sms - 1) / cap.sms;
    const double bytes = (double)kr * BK * (bn + 0.5 * me) + 3.0 * 16384;
    const double cost = (double)(waves > per_sm ? waves : per_sm) * bytes;
    if (cost < best->cost * (1 - 1e-9)) {
      best->cost = cost;
      best->bn = bn;
      best->splits = s;
      best->kr = kr;
    }
  }
}

template <int MT, bool VEC, int BN>
int go(const Plan& p, const void* A, const void* B, void* C, int M, int N,
       int K, cudaStream_t stream) {
  const long long mblocks = (M + 16 * MT - 1) / (16 * MT);
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (unsigned)mblocks, p.splits);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<MT, BN>(grid, p.splits, &attr,
                                                 stream);
  return (int)cudaLaunchKernelEx(
      &cfg, int8_mm_kernel<MT, VEC, BN>, static_cast<const int8_t*>(A),
      static_cast<const int8_t*>(B), static_cast<int32_t*>(C), M, N, K,
      p.kr);
}

template <int MT, bool VEC>
int launch(const void* A, const void* B, void* C, int M, int N, int K,
           cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  Plan p;
  {
    std::lock_guard<std::mutex> hold(cap_lock);
    Capacity* cap = caps[dev][MT == 1 ? 0 : 1];
    int err = capacity<MT, VEC, 128>(cap[0]);
    if (!err) err = capacity<MT, VEC, 256>(cap[1]);
    if (err) return err;
    plan(cap[0], 128, M, N, K, 16 * MT, &p);
    plan(cap[1], 256, M, N, K, 16 * MT, &p);
  }
  return p.bn == 128 ? go<MT, VEC, 128>(p, A, B, C, M, N, K, stream)
                     : go<MT, VEC, 256>(p, A, B, C, M, N, K, stream);
}

}  // namespace

// A: (M, K) int8, B: (N, K) int8, C: (M, N) int32, all row-major and
// contiguous.  Returns the launch's error code (0 on success).
extern "C" int cos_int8_matmul(const void* A, const void* B, void* C, int M,
                               int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (K % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  if (M <= 16)
    return vec ? launch<1, true>(A, B, C, M, N, K, s)
               : launch<1, false>(A, B, C, M, N, K, s);
  return vec ? launch<4, true>(A, B, C, M, N, K, s)
             : launch<4, false>(A, B, C, M, N, K, s);
}
