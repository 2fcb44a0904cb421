// GEMM in the three contraction modes of the TPU kernel, f32 out:
//   nt  y[M,N] = act(a[M,K] . b[N,K]^T + bias[N])   (linear forward)
//   nn  y[M,N] = a[M,K] . b[K,N]                    (linear backward dX)
//   tn  y[M,N] = a[K,M]^T . b[K,N]                  (linear backward dW)
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit in modes "nt", "nn" and "tn"): f32 accumulation,
// bias added in f32 after the last K step, then the none/relu/sigmoid
// epilogue.  As in _MODES (gemm.py:76-80), every operand is read in its
// natural layout: no transpose is materialised.  Bias and epilogue apply
// in mode nt only.
//
// What bounds it on the H100:
//   * the transformer's training products (M = 16,384 tokens of a batch,
//     K and N of 1,024 to 4,096 in every mode; tn contracts over the 16,384
//     tokens): tensor-core bound, hundreds of FLOPs per byte;
//   * prefill (M = 512 rows of one padded prompt): tensor-core bound;
//   * decode (M = 16 slots): memory bound, every weight byte is read once
//     per step and reused 16 times only;
//   * the f32 training shapes (M = 256 rows of a batch, K and N of 10 to
//     784): tiny, so launch and latency bound, not FLOP bound.
// What the simple design does about that:
//   * bf16 operands, in all three modes, go through the tensor cores with
//     WMMA 16x16x16 tiles out of shared memory; each operand's tile is
//     copied in its own layout and handed to WMMA as row- or column-major,
//     so modes nn and tn cost no transpose either;
//   * f32 operands, in all three modes, take one plain FMA tile kernel
//     whose tile loads follow each operand's layout (consecutive threads
//     walk the contiguous axis) and whose inner loop is the same for every
//     mode;
//   * the bf16 tiles stream through a multi-stage cp.async pipeline, so the
//     loads of the next K steps are in flight while the current one is
//     multiplied;
//   * tile shapes by problem size: 128x128 (8 warps, 64x32 each) where that
//     still gives two waves of blocks on 132 SMs, 64x64 (4 warps) below,
//     and for decode (M <= 16, mode nt) BM=16, BN=32, BK=128: many small
//     blocks with long K steps, so that more weight bytes are in flight;
//   * ragged M/N/K edges are masked in the kernel (cp.async zero-fill);
//     nothing is padded in device memory (the TPU version pads to its
//     block grid).
// wgmma, TMA, split-K for the skinny decode shapes and for tn at small M x N,
// and TF32 tensor-core variants of the f32 modes are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace taper {

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
          bool A_MK, bool B_NK>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ bias,
                     float* __restrict__ y, int M, int N, int K, int act,
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
      y[(size_t)gm * N + gn] = epilogue(v, act);
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool A_MK, bool B_NK>
int launch_gemm_bf16(const void* a, const void* b, const void* bias, void* y,
                     int M, int N, int K, int act, cudaStream_t s) {
  constexpr size_t bytes =
      gemm_smem_bytes<BM, BN, BK, STAGES, A_MK, B_NK>();
  auto kernel =
      gemm_bf16_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, A_MK, B_NK>;
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
      static_cast<const __nv_bfloat16*>(bias), static_cast<float*>(y), M, N,
      K, act, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// Picks the tile shape for an M x N output (see the header).
template <bool A_MK, bool B_NK>
int gemm_bf16(const void* a, const void* b, const void* bias, void* y, int M,
              int N, int K, int act, cudaStream_t s) {
  const long long big_tiles =
      (long long)((M + 127) / 128) * ((N + 127) / 128);
  if constexpr (A_MK && B_NK) {
    if (M <= 16)
      return launch_gemm_bf16<16, 32, 128, 1, 2, 3, A_MK, B_NK>(
          a, b, bias, y, M, N, K, act, s);
  }
  if (big_tiles >= 2 * 132)
    return launch_gemm_bf16<128, 128, 32, 2, 4, 4, A_MK, B_NK>(
        a, b, bias, y, M, N, K, act, s);
  return launch_gemm_bf16<64, 64, 32, 2, 2, 4, A_MK, B_NK>(a, b, bias, y, M,
                                                           N, K, act, s);
}

// ---------------------------------------------------------------------------
// f32 FMA tile kernel (64x64 tile, 256 threads, 4x4 outputs each), all modes
// ---------------------------------------------------------------------------

// A_MK: a is [M, K] (modes nt, nn), else [K, M] (tn).
// B_NK: b is [N, K] (mode nt), else [K, N] (nn, tn).
template <bool A_MK, bool B_NK>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int M, int N, int K, int act) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 1];  // As[k][m]
  __shared__ float Bs[BK][BN + 1];  // Bs[k][n]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // BM * BK == BN * BK: one pass loads one element of each tile.
    for (int e = threadIdx.x; e < BM * BK; e += 256) {
      // Consecutive threads walk each operand's contiguous axis.
      if (A_MK) {
        int r = e / BK, kk = e % BK, gm = m0 + r, gk = k0 + kk;
        As[kk][r] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.0f;
      } else {
        int r = e % BM, kk = e / BM, gm = m0 + r, gk = k0 + kk;
        As[kk][r] = (gm < M && gk < K) ? a[(size_t)gk * M + gm] : 0.0f;
      }
      if (B_NK) {
        int c = e / BK, kk = e % BK, gn = n0 + c, gk = k0 + kk;
        Bs[kk][c] = (gn < N && gk < K) ? b[(size_t)gn * K + gk] : 0.0f;
      } else {
        int c = e % BN, kk = e / BN, gn = n0 + c, gk = k0 + kk;
        Bs[kk][c] = (gn < N && gk < K) ? b[(size_t)gk * N + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        float v = acc[i][j];
        if (bias != nullptr) v += bias[gn];
        y[(size_t)gm * N + gn] = epilogue(v, act);
      }
    }
}

}  // namespace taper

using namespace taper;

extern "C" int taper_linear(const void* x, const void* w, const void* bias,
                            void* y, int M, int N, int K, int dtype, int act,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return gemm_bf16<true, true>(x, w, bias, y, M, N, K, act, s);
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_f32_kernel<true, true><<<grid, 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, act);
  return (int)cudaGetLastError();
}

// Modes nn (1) and tn (2) of the contraction, no bias or epilogue; mode
// codes shared with MODES in taper_tpu_torch/ops/gemm.py.
extern "C" int taper_gemm(const void* a, const void* b, void* y, int M,
                          int N, int K, int mode, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (mode != 1 && mode != 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    if (mode == 1)
      return gemm_bf16<true, false>(a, b, nullptr, y, M, N, K, kNone, s);
    return gemm_bf16<false, false>(a, b, nullptr, y, M, N, K, kNone, s);
  }
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  auto ap = static_cast<const float*>(a);
  auto bp = static_cast<const float*>(b);
  auto yp = static_cast<float*>(y);
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  if (mode == 1)
    gemm_f32_kernel<true, false><<<grid, 256, 0, s>>>(ap, bp, nullptr, yp, M,
                                                      N, K, kNone);
  else
    gemm_f32_kernel<false, false><<<grid, 256, 0, s>>>(ap, bp, nullptr, yp,
                                                       M, N, K, kNone);
  return (int)cudaGetLastError();
}

extern "C" const char* taper_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
