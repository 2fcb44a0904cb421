// K1's decode route: the bf16 product of mode nt at M <= 16 rows,
//   y[M,N] = act(x[M,K] . w[N,K]^T + bias[N])
// written as f32 or bf16: every projection of a serving decode step (one
// row a slot) and of the quantized-serving baseline's bf16 model.
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit in mode "nt") at the M <= 16 that
// ops/gemm.py::plan routes here: f32 accumulation, the bf16 bias added in
// f32 after the last K step, then the none/relu/sigmoid epilogue, rounded
// once (to nearest even) where the output is bf16.
//
// What bounds it on the H100: bytes.  The product does 2 M FLOP per weight
// element read, at most 16 FLOP a byte against the ~295 at which the
// card's bf16 tensor cores and its 3.35 TB/s balance, so its bound is the
// weights over the memory rate (the serving model's (4e, e) projection: 8
// MB, 2.5 us).  To reach that rate every SM must keep tens of KB of loads
// in flight for the whole call, so at N = 1,024 (32 blocks of 32 weight
// rows) K must be split across blocks as well as warps.
// What the design does about that:
//   * swap A and B: the weight rows are the M side of mma.sync m16n8k16
//     (bf16 in, f32 accumulate) and the activations its N side (one n8
//     tile for M <= 8, two for M <= 16; rows past M read as zeros, no
//     load issued).  A thread loads 16 contiguous bytes of a weight row
//     straight into the registers of two A fragments: within a 32-deep K
//     step, fragment slot 2q + e of product h holds k = 8q + 4h + e and
//     slot 2q + 8 + e holds 8q + 4h + 2 + e, the same permutation for the
//     activations' B fragments, so the sum over K is unchanged.  No shared
//     memory or TMA stands between the loads and the tensor cores, and
//     each thread has its loads for two steps (128 bytes of weights) in
//     flight at once (four steps, or one block an SM, ran no faster at
//     M <= 8 and slower at M = 16: 87-96 registers a thread keep two
//     blocks an SM without spills);
//   * a block of 8 warps covers 32 weight rows (two m16 tiles a warp); its
//     warps take interleaved 32-deep K steps, so that each row is read as
//     one contiguous stream per block;
//   * K is split over a thread-block cluster of ``splits`` blocks (plan
//     picks it from the shape: the most, a power of two up to 8, that
//     leave each rank four steps a warp and the grid within two blocks an
//     SM): rank r takes the r-th run of K steps.  The partial sums meet in a fixed
//     order, so every call gives the same bits: the warps' in shared
//     memory in warp order, then the ranks', which each rank stores into
//     rank 0's shared memory (distributed shared memory, behind one
//     cluster barrier) and rank 0 sums in rank order, adds the bias,
//     applies the epilogue and writes y.  One launch, no workspace;
//   * ragged N and M are masked (zero loads, no store); K % 8 != 0 or an
//     operand off a 16-byte boundary takes element loads (the VEC = false
//     instantiation), masked past K.  Nothing is padded in device memory.
// wgmma was not taken: it wants 64 weight rows a warpgroup and its A or B
// in shared memory, so at N = 1,024 the 16 row tiles would need K split
// 8 ways before the grid covered the card, behind a TMA ring for data
// that is read once; the tensor cores are idle at M <= 16 either way.
#include "common.cuh"
#include "hopper.cuh"

namespace taper {

namespace {

using hopper::cluster_arrive;
using hopper::cluster_rank;
using hopper::cluster_wait;
using hopper::mma16816;
using hopper::smem_u32;
using hopper::st_cluster_f32;

constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kRows = 32;     // weight rows (output columns) a block
constexpr int kStep = 32;     // K a warp takes per step: two k16 products
constexpr int kUnroll = 2;    // steps whose loads a warp keeps in flight
constexpr int kMaxSplits = 8; // the largest portable cluster

// The 8 bf16 of row ``row`` of a row-major [rows, K] matrix from column
// ``col`` as 4 registers (the lower column in each register's low half);
// zeros past ``rows`` and past K.  VEC: K % 8 == 0 and a 16-byte aligned
// base, so the 8 are all in or all out and one 16-byte load reads them.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p,
                                       int row, int rows, int col, int K) {
  if (row >= rows || col >= K) return make_uint4(0, 0, 0, 0);
  const size_t at = (size_t)row * K + col;
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p + at));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p) + at;
    uint32_t r[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < K) r[i / 2] |= (uint32_t)s[i] << (16 * (i & 1));
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Block x: weight rows [32 (x / splits), + 32), cluster rank x % splits,
// which takes K steps [rank * per, (rank + 1) * per) of ceil(K / 32).
// NT: n8 tiles of activation rows (1: M <= 8, 2: M <= 16).
template <int NT, bool VEC, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_decode_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       OutT* __restrict__ y, int M, int N, int K, int act,
                       int splits) {
  // each warp's partial [16 M, 32 rows]; in rank 0, every rank's block sum
  __shared__ float red[kWarps][16][kRows];
  __shared__ float gather[kMaxSplits][16 * kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int rank = splits > 1 ? (int)cluster_rank() : 0;
  // the cluster's first phase: every block has started (rank 0's shared
  // memory is there to be written); waited for after the products
  if (splits > 1) cluster_arrive<false>();
  const int n0 = blockIdx.x / splits * kRows;
  const int steps = (K + kStep - 1) / kStep;
  const int per = (steps + splits - 1) / splits;
  const int lo = rank * per, hi = min(steps, lo + per);

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;

  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * kUnroll) {
    // the loads of up to kUnroll steps first, then their products
    uint4 wv[kUnroll][2][2], xv[kUnroll][NT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      const int col = s < hi ? s * kStep + 8 * q : K;  // K: nothing
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wv[u][t][r] = load8<VEC>(w, n0 + 16 * t + 8 * r + g, N, col, K);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        xv[u][j] = load8<VEC>(x, 8 * j + g, M, col, K);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma16816(acc[t][j], word(wv[u][t][0], 2 * h),
                     word(wv[u][t][1], 2 * h), word(wv[u][t][0], 2 * h + 1),
                     word(wv[u][t][1], 2 * h + 1), word(xv[u][j], 2 * h),
                     word(xv[u][j], 2 * h + 1));
  }

  // the warp's partial: d0, d1 at (weight row g, activation rows 2q, 2q +
  // 1) of each m16 x n8 tile, d2, d3 at weight row g + 8
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][8 * j + 2 * q + (e & 1)][16 * t + g + 8 * (e >> 1)] =
            acc[t][j][e];
  __syncthreads();

  // the block's sum in warp order (entry i: activation row i / 32, weight
  // row i % 32), then the cluster's in rank order by rank 0
  constexpr int kEntries = 8 * NT * kRows;
  float v[kEntries / kThreads];
#pragma unroll
  for (int i = 0; i < kEntries / kThreads; ++i) {
    const int at = threadIdx.x + i * kThreads;
    float sum = red[0][at / kRows][at % kRows];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) sum += red[wp][at / kRows][at % kRows];
    v[i] = sum;
  }
  if (splits > 1) {
    cluster_wait();
    if (rank != 0) {
      // into rank 0's gather[rank]; the release below publishes them
#pragma unroll
      for (int i = 0; i < kEntries / kThreads; ++i)
        st_cluster_f32(smem_u32(&gather[rank][threadIdx.x + i * kThreads]),
                       0, v[i]);
      cluster_arrive<true>();
      return;
    }
    cluster_arrive<true>();
    cluster_wait();  // every rank's sum is in gather
#pragma unroll
    for (int i = 0; i < kEntries / kThreads; ++i)
      for (int r = 1; r < splits; ++r)
        v[i] += gather[r][threadIdx.x + i * kThreads];
  }
#pragma unroll
  for (int i = 0; i < kEntries / kThreads; ++i) {
    const int at = threadIdx.x + i * kThreads;
    const int m = at / kRows, n = n0 + at % kRows;
    if (m < M && n < N) {
      float out = v[i];
      if (bias != nullptr) out += __bfloat162float(bias[n]);
      y[(size_t)m * N + n] = from_f32<OutT>(epilogue(out, act));
    }
  }
}

template <int NT, bool VEC, typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, int M,
           int N, int K, int act, int splits, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kRows - 1) / kRows * splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one block: no cluster
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, gemm_decode_kernel<NT, VEC, OutT>,
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<OutT*>(y), M, N,
      K, act, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename OutT>
int by_shape(const void* x, const void* w, const void* bias, void* y, int M,
             int N, int K, int act, int splits, cudaStream_t s) {
  const bool vec = K % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (M <= 8)
    return vec ? launch<1, true, OutT>(x, w, bias, y, M, N, K, act, splits,
                                       s)
               : launch<1, false, OutT>(x, w, bias, y, M, N, K, act, splits,
                                        s);
  return vec ? launch<2, true, OutT>(x, w, bias, y, M, N, K, act, splits, s)
             : launch<2, false, OutT>(x, w, bias, y, M, N, K, act, splits,
                                      s);
}

}  // namespace

int gemm_decode(const void* x, const void* w, const void* bias, void* y,
                int M, int N, int K, int out_dtype, int act, int splits,
                cudaStream_t s) {
  if (M > 16 || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (out_dtype == kBFloat16)
    return by_shape<__nv_bfloat16>(x, w, bias, y, M, N, K, act, splits, s);
  return by_shape<float>(x, w, bias, y, M, N, K, act, splits, s);
}

}  // namespace taper
