// K1: GEMM in the three contraction modes of the TPU kernel:
//   nt  y[M,N] = act(a[M,K] . b[N,K]^T + bias[N])   (linear forward)
//   nn  y[M,N] = a[M,K] . b[K,N]                    (linear backward dX)
//   tn  y[M,N] = a[K,M]^T . b[K,N]                  (linear backward dW)
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit in modes "nt", "nn" and "tn"): f32 accumulation,
// bias added in f32 after the last K step, then the none/relu/sigmoid
// epilogue, written as f32 (as _gemm_jit) or, on request, rounded once to
// bf16.  As in _MODES (gemm.py:76-80), every operand is read in its
// natural layout: no transpose is materialised.  Bias and epilogue apply
// in mode nt only.
//
// One C entry point, taper_gemm, runs the kernel that ops/gemm.py::plan
// chose (its route) with its K split:
//   * wgmma (bf16, M > 16, TMA-aligned): csrc/gemm_sm90.cu;
//   * decode (bf16 nt at M <= 16): csrc/gemm_decode.cu, its K split over a
//     thread-block cluster;
//   * wmma (other bf16): the WMMA tile kernel below, 16x16x16 fragments
//     out of a cp.async ring, 128x128 (8 warps) where that gives two waves
//     of blocks, 64x64 below;
//   * f32: the FMA tile kernel below.  The port keeps TF32 off, so f32
//     stays on the CUDA cores; its path shapes are latency bound, not
//     FLOP bound: a long-K product with a small output (the sort task's
//     dW [128, 128] over K = 8,192, ResNet-8's patch-GEMM dW [32..64,
//     16..288] over K = 16,384..65,536) covers a few of the 132 SMs.  So
//     plan splits K over blocks, each a run of whole 16-deep K tiles with
//     its f32 partial in a workspace, and splitk_reduce sums the splits in
//     order.  The tile (64x64, 4x4 outputs a thread) loads each operand
//     along its contiguous axis in 16-byte vectors where the shape and
//     address allow, double-buffered through registers (one barrier a K
//     step).
// Ragged M/N/K edges are masked in the kernels (zero-filled loads); nothing
// is padded in device memory.  Split-K sums in a fixed order and uses no
// atomics, so each call gives the same bits.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace taper {

// csrc/gemm_sm90.cu
int gemm_wgmma(const void* a, const void* b, const void* bias, void* y,
               void* ws, int M, int N, int K, int mode, int out_dtype,
               int act, int splits, cudaStream_t s);

// csrc/gemm_decode.cu
int gemm_decode(const void* x, const void* w, const void* bias, void* y,
                int M, int N, int K, int out_dtype, int act, int splits,
                cudaStream_t s);

// The split-K reduce (below): y = act(sum of the splits + bias)
int splitk_reduce(const float* ws, const void* bias, int bias_dtype, void* y,
                  int out_dtype, int M, int N, int splits, int act,
                  cudaStream_t s);

// route codes shared with ROUTES in taper_tpu_torch/ops/gemm.py
enum Route : int { kWgmma = 0, kWmma = 1, kDecode = 2, kF32 = 3 };

// ---------------------------------------------------------------------------
// bf16 tensor-core tile kernel, all three modes
// ---------------------------------------------------------------------------

// Starts loading the [ROWS, COLS] tile at (r0, c0) of a row-major
// [rows, cols] bf16 matrix into shared memory (leading dimension LD),
// zero-filling past the ragged edges.  `vec` (cols % 8 == 0, 16-byte
// aligned base) copies asynchronously in 16-byte chunks, each all in or
// all out; otherwise element by element.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* sm, const __nv_bfloat16* g, int r0, int rows, int c0,
    int cols, bool vec) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks per tile row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    int r = c / CPR, cc = (c % CPR) * 8;
    int gr = r0 + r, gc = c0 + cc;
    __nv_bfloat16* dst = sm + r * LD + cc;
    if (vec) {
      bool in = gr < rows && gc < cols;
      cp_async16(dst, in ? g + (size_t)gr * cols + gc : g, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bool in = gr < rows && gc + e < cols;
        dst[e] = in ? g[(size_t)gr * cols + gc + e] : __float2bfloat16(0.0f);
      }
    }
  }
}

// Shared-memory layout of one pipeline stage: the A tile then the B tile,
// each in its operand's own layout.  A_MK: a is [M, K] (modes nt, nn),
// else [K, M] (tn).  B_NK: b is [N, K] (nt), else [K, N] (nn, tn).
template <int BM, int BN, int BK, bool A_MK, bool B_NK>
struct GemmTiles {
  static constexpr int A_ROWS = A_MK ? BM : BK, A_COLS = A_MK ? BK : BM;
  static constexpr int B_ROWS = B_NK ? BN : BK, B_COLS = B_NK ? BK : BN;
  // +8 bf16 per row keeps WMMA's 32-byte rule and spreads the banks
  static constexpr int LDA = A_COLS + 8, LDB = B_COLS + 8;
  static constexpr int A_ELEMS = A_ROWS * LDA;
  static constexpr int STAGE = A_ELEMS + B_ROWS * LDB;  // bf16 elements
  static constexpr int LDC = BN + 4;                    // f32 output tile
};

template <int BM, int BN, int BK, int STAGES, bool A_MK, bool B_NK>
constexpr size_t gemm_smem_bytes() {
  using L = GemmTiles<BM, BN, BK, A_MK, B_NK>;
  size_t pipe = (size_t)STAGES * L::STAGE * 2;
  size_t out = (size_t)BM * L::LDC * 4;
  return pipe > out ? pipe : out;
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool A_MK, bool B_NK, typename OutT>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ bias,
                     OutT* __restrict__ y, int M, int N, int K, int act,
                     bool vec_a, bool vec_b) {
  using L = GemmTiles<BM, BN, BK, A_MK, B_NK>;
  using LayoutA =
      typename std::conditional<A_MK, wmma::row_major, wmma::col_major>::type;
  using LayoutB =
      typename std::conditional<B_NK, wmma::col_major, wmma::row_major>::type;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  // the pipeline's stages, reused for the f32 output tile at the end
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(gemm_smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    __nv_bfloat16* As = smem + (kt % STAGES) * L::STAGE;
    __nv_bfloat16* Bs = As + L::A_ELEMS;
    const int k0 = kt * BK;
    if constexpr (A_MK)
      load_tile_bf16<BM, BK, L::LDA, NT>(As, a, m0, M, k0, K, vec_a);
    else
      load_tile_bf16<BK, BM, L::LDA, NT>(As, a, k0, K, m0, M, vec_a);
    if constexpr (B_NK)
      load_tile_bf16<BN, BK, L::LDB, NT>(Bs, b, n0, N, k0, K, vec_b);
    else
      load_tile_bf16<BK, BN, L::LDB, NT>(Bs, b, k0, K, n0, N, vec_b);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();  // one group per stage, empty ones included
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage kt-1 free
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % STAGES) * L::STAGE;
    const __nv_bfloat16* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int row = wm * WM + i * 16;  // M index within the tile
        wmma::load_matrix_sync(
            af[i], A_MK ? As + row * L::LDA + kk : As + kk * L::LDA + row,
            L::LDA);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int col = wn * WN + j * 16;  // N index within the tile
        // [N, K] row-major is the K x N operand in column-major
        wmma::load_matrix_sync(
            bf[j], B_NK ? Bs + col * L::LDB + kk : Bs + kk * L::LDB + col,
            L::LDB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  float* Cs = reinterpret_cast<float*>(gemm_smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * WM + i * 16) * L::LDC + wn * WN + j * 16, acc[i][j],
          L::LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    int r = e / BN, c = e % BN;
    int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * L::LDC + c];
      if (bias != nullptr) v += __bfloat162float(bias[gn]);
      y[(size_t)gm * N + gn] = from_f32<OutT>(epilogue(v, act));
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool A_MK, bool B_NK, typename OutT>
int launch_gemm_bf16(const void* a, const void* b, const void* bias, void* y,
                     int M, int N, int K, int act, cudaStream_t s) {
  constexpr size_t bytes =
      gemm_smem_bytes<BM, BN, BK, STAGES, A_MK, B_NK>();
  auto kernel = gemm_bf16_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, A_MK,
                                 B_NK, OutT>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte chunks need rows of whole chunks and an aligned base
  const int a_cols = A_MK ? K : M, b_cols = B_NK ? K : N;
  bool vec_a = a_cols % 8 == 0 && (uintptr_t)a % 16 == 0;
  bool vec_b = b_cols % 8 == 0 && (uintptr_t)b % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, WARPS_M * WARPS_N * 32, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(bias), static_cast<OutT*>(y), M, N,
      K, act, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// The WMMA tile for an M x N output (see the header).
template <bool A_MK, bool B_NK, typename OutT>
int gemm_bf16(const void* a, const void* b, const void* bias, void* y, int M,
              int N, int K, int act, cudaStream_t s) {
  const long long big_tiles =
      (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big_tiles >= 2 * 132)
    return launch_gemm_bf16<128, 128, 32, 2, 4, 4, A_MK, B_NK, OutT>(
        a, b, bias, y, M, N, K, act, s);
  return launch_gemm_bf16<64, 64, 32, 2, 2, 4, A_MK, B_NK, OutT>(
      a, b, bias, y, M, N, K, act, s);
}

template <typename OutT>
int gemm_wmma(const void* a, const void* b, const void* bias, void* y, int M,
              int N, int K, int mode, int act, cudaStream_t s) {
  if (mode == 0)
    return gemm_bf16<true, true, OutT>(a, b, bias, y, M, N, K, act, s);
  if (mode == 1)
    return gemm_bf16<true, false, OutT>(a, b, nullptr, y, M, N, K, kNone,
                                        s);
  return gemm_bf16<false, false, OutT>(a, b, nullptr, y, M, N, K, kNone,
                                       s);
}

// ---------------------------------------------------------------------------
// f32 FMA tile kernel (64x64 tile, 256 threads, 4x4 outputs each), all
// modes, with split-K
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16;
constexpr int F_LD = F_BM + 4;  // smem row: 16-byte aligned, fewer conflicts

// The four values this thread stages of an operand's K tile.  K_FAST: the
// operand is [MN, K] (K contiguous), else [K, MN] (MN contiguous).
// Consecutive threads walk the contiguous axis, four elements each: one
// 16-byte load when ``vec`` (a contiguous dimension that is a multiple of
// 4 and a 16-byte aligned base, so the four are all in or all out).
template <bool K_FAST>
__device__ __forceinline__ void f32_load(float (&r)[4],
                                         const float* __restrict__ g,
                                         int mn0, int MN, int k0, int K,
                                         bool vec) {
  const int t = threadIdx.x;
  const int row = K_FAST ? mn0 + t / 4 : k0 + t / 16;   // outer index
  const int col = K_FAST ? k0 + (t % 4) * 4 : mn0 + (t % 16) * 4;
  const int rows = K_FAST ? MN : K, cols = K_FAST ? K : MN;
  const float* p = g + (size_t)row * cols + col;
  if (vec && row < rows && col < cols) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = (row < rows && col + e < cols) ? p[e] : 0.0f;
  }
}

// Stores them into the tile S[k][mn] of shared memory.
template <bool K_FAST>
__device__ __forceinline__ void f32_stage(float (*S)[F_LD],
                                          const float (&r)[4]) {
  const int t = threadIdx.x;
  if (K_FAST) {
#pragma unroll
    for (int e = 0; e < 4; ++e) S[(t % 4) * 4 + e][t / 4] = r[e];
  } else {
    *reinterpret_cast<float4*>(&S[t / 16][(t % 16) * 4]) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

// A_MK: a is [M, K] (modes nt, nn), else [K, M] (tn).
// B_NK: b is [N, K] (mode nt), else [K, N] (nn, tn).
// Block z sums K tiles [z * k_per_split, (z + 1) * k_per_split); with
// ``part`` it writes its f32 partial to part[z] (no bias, no epilogue).
template <bool A_MK, bool B_NK>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ part, int M, int N, int K, int act,
                    int k_per_split, bool vec_a, bool vec_b) {
  __shared__ __align__(16) float As[2][F_BK][F_LD];  // As[.][k][m]
  __shared__ __align__(16) float Bs[2][F_BK][F_LD];  // Bs[.][k][n]
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k_tiles = (K + F_BK - 1) / F_BK;
  const int kt0 = blockIdx.z * k_per_split;
  const int nk = min(k_tiles, kt0 + k_per_split) - kt0;
  float ra[4], rb[4], acc[4][4] = {};

  f32_load<A_MK>(ra, a, m0, M, kt0 * F_BK, K, vec_a);
  f32_load<B_NK>(rb, b, n0, N, kt0 * F_BK, K, vec_b);
  f32_stage<A_MK>(As[0], ra);
  f32_stage<B_NK>(Bs[0], rb);
  __syncthreads();
  for (int i = 0; i < nk; ++i) {
    const int cur = i & 1;
    const bool next = i + 1 < nk;
    if (next) {  // the next tile's loads are in flight during the FMAs
      f32_load<A_MK>(ra, a, m0, M, (kt0 + i + 1) * F_BK, K, vec_a);
      f32_load<B_NK>(rb, b, n0, N, (kt0 + i + 1) * F_BK, K, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    if (next) {  // the other buffer: everyone left it at the last barrier
      f32_stage<A_MK>(As[cur ^ 1], ra);
      f32_stage<B_NK>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

  float* out = part != nullptr ? part + (size_t)blockIdx.z * M * N : y;
  const int gn = n0 + tx * 4;
  if (gn >= N) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = m0 + ty * 4 + r;
    if (gm >= M) continue;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = acc[r][c];
      if (part == nullptr && gn + c < N) {
        if (bias != nullptr) v[c] += bias[gn + c];
        v[c] = epilogue(v[c], act);
      }
    }
    float* dst = out + (size_t)gm * N + gn;
    if (N % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (gn + c < N) dst[c] = v[c];
    }
  }
}

template <bool A_MK, bool B_NK>
int gemm_f32(const void* a, const void* b, const void* bias, void* y,
             void* ws, int M, int N, int K, int act, int splits,
             cudaStream_t s) {
  const int k_tiles = (K + F_BK - 1) / F_BK;
  const int per = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per - 1) / per;
  const int a_cols = A_MK ? K : M, b_cols = B_NK ? K : N;
  const bool vec_a = a_cols % 4 == 0 && (uintptr_t)a % 16 == 0;
  const bool vec_b = b_cols % 4 == 0 && (uintptr_t)b % 16 == 0;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, splits);
  gemm_f32_kernel<A_MK, B_NK><<<grid, 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(y), part, M, N,
      K, act, per, vec_a, vec_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return splitk_reduce(part, bias, kFloat32, y, kFloat32, M, N, splits, act,
                       s);
}

// ---------------------------------------------------------------------------
// split-K reduce: y = act(sum over splits, in split order, + bias)
// ---------------------------------------------------------------------------

template <typename BiasT, typename OutT>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ ws,
                         const BiasT* __restrict__ bias,
                         OutT* __restrict__ y, int M, int N, int splits,
                         int act) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int sp = 1; sp < splits; ++sp) v += ws[(size_t)sp * total + i];
    if (bias != nullptr) v += to_f32(bias[i % N]);
    y[i] = from_f32<OutT>(epilogue(v, act));
  }
}

int splitk_reduce(const float* ws, const void* bias, int bias_dtype, void* y,
                  int out_dtype, int M, int N, int splits, int act,
                  cudaStream_t s) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 16);
  if (bias_dtype == kFloat32)
    splitk_reduce_kernel<float, float><<<blocks, 256, 0, s>>>(
        ws, static_cast<const float*>(bias), static_cast<float*>(y), M, N,
        splits, act);
  else if (out_dtype == kFloat32)
    splitk_reduce_kernel<__nv_bfloat16, float><<<blocks, 256, 0, s>>>(
        ws, static_cast<const __nv_bfloat16*>(bias), static_cast<float*>(y),
        M, N, splits, act);
  else
    splitk_reduce_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<blocks, 256, 0, s>>>(ws, static_cast<const __nv_bfloat16*>(bias),
                                static_cast<__nv_bfloat16*>(y), M, N, splits,
                                act);
  return (int)cudaGetLastError();
}

}  // namespace taper

using namespace taper;

// K1 in ``mode`` (0 nt, 1 nn, 2 tn; codes shared with MODES in
// taper_tpu_torch/ops/gemm.py) on the route ops/gemm.py::plan chose, split
// ``splits`` ways over K (``ws``: splits * M * N f32 of workspace when
// splits > 1, except on the decode route, whose splits are a cluster's
// blocks).  ``bias`` and ``act`` in mode nt only; ``out_dtype`` f32, or
// bf16 for bf16 operands.
extern "C" int taper_gemm(const void* a, const void* b, const void* bias,
                          void* y, void* ws, int M, int N, int K, int mode,
                          int dtype, int out_dtype, int act, int route,
                          int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || mode < 0 || mode > 2 || splits < 1 ||
      (splits > 1 && ws == nullptr && route != kDecode) ||
      (mode != 0 && (bias != nullptr || act != kNone)))
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    if (route != kF32 || out_dtype != kFloat32)
      return (int)cudaErrorInvalidValue;
    if (mode == 0)
      return gemm_f32<true, true>(a, b, bias, y, ws, M, N, K, act, splits,
                                  s);
    if (mode == 1)
      return gemm_f32<true, false>(a, b, nullptr, y, ws, M, N, K, kNone,
                                   splits, s);
    return gemm_f32<false, false>(a, b, nullptr, y, ws, M, N, K, kNone,
                                  splits, s);
  }
  if (dtype != kBFloat16 ||
      (out_dtype != kFloat32 && out_dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (route == kWgmma)
    return gemm_wgmma(a, b, bias, y, ws, M, N, K, mode, out_dtype, act,
                      splits, s);
  if (route == kDecode) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    return gemm_decode(a, b, bias, y, M, N, K, out_dtype, act, splits, s);
  }
  if (splits != 1 || route != kWmma) return (int)cudaErrorInvalidValue;
  if (out_dtype == kBFloat16)
    return gemm_wmma<__nv_bfloat16>(a, b, bias, y, M, N, K, mode, act, s);
  return gemm_wmma<float>(a, b, bias, y, M, N, K, mode, act, s);
}

extern "C" const char* taper_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
