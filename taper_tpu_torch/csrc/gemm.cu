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
//   * prefill (M = 512 rows of one padded prompt): tensor-core bound;
//   * decode (M = 16 slots): memory bound, every weight byte is read once
//     per step and reused 16 times only;
//   * the f32 training shapes (M = 256 rows of a batch, K and N of 10 to
//     784): tiny, so launch and latency bound, not FLOP bound.
// What the simple design does about that:
//   * bf16 operands (mode nt only) go through the tensor cores with WMMA
//     16x16x16 tiles out of shared memory; f32 operands, in all three
//     modes, take one plain FMA tile kernel whose tile loads follow each
//     operand's layout (consecutive threads walk the contiguous axis) and
//     whose inner loop is the same for every mode;
//   * the bf16 tiles stream through a multi-stage cp.async pipeline, so the
//     loads of the next K steps are in flight while the current one is
//     multiplied;
//   * decode gets its own tile shape (BM=16, BN=32, BK=128): many small
//     blocks with long K steps, so that more weight bytes are in flight.
//   * ragged M/N/K edges are masked in the kernel (cp.async zero-fill);
//     nothing is padded in device memory (the TPU version pads to its
//     block grid).
// wgmma, TMA, split-K for the skinny decode shapes, and bf16 or TF32
// tensor-core variants of modes nn/tn are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace taper {

// ---------------------------------------------------------------------------
// bf16 tensor-core tile kernel
// ---------------------------------------------------------------------------

// 16-byte global->shared copy that zero-fills when `in` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts loading a [ROWS, BK] tile of a row-major [rows, K] bf16 matrix
// into shared memory (leading dimension LD), zero-filling past the ragged
// edges.  `vec` (K % 8 == 0, 16-byte aligned rows) copies asynchronously
// in 16-byte chunks, each all in or all out; otherwise element by element.
template <int ROWS, int BK, int LD, int NT>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* sm, const __nv_bfloat16* g, int row0, int rows, int k0,
    int K, bool vec) {
  constexpr int CPR = BK / 8;  // 16-byte chunks per tile row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    int r = c / CPR, kc = (c % CPR) * 8;
    int gr = row0 + r, gk = k0 + kc;
    __nv_bfloat16* dst = sm + r * LD + kc;
    if (vec) {
      bool in = gr < rows && gk < K;
      cp_async16(dst, in ? g + (size_t)gr * K + gk : g, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bool in = gr < rows && gk + e < K;
        dst[e] = in ? g[(size_t)gr * K + gk + e] : __float2bfloat16(0.0f);
      }
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       float* __restrict__ y, int M, int N, int K, int act,
                       bool vec) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDA = BK + 8;  // bf16 elements; keeps WMMA's 32-byte rule
  constexpr int LDC = BN + 4;  // f32 elements
  constexpr int STAGE = (BM + BN) * LDA;  // bf16 elements per stage
  static_assert(BM * LDC * 4 <= STAGES * STAGE * 2, "epilogue tile fits");
  // the pipeline's stages, reused for the f32 output tile at the end
  __shared__ __align__(128) __nv_bfloat16 smem[STAGES * STAGE];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    __nv_bfloat16* As = smem + (kt % STAGES) * STAGE;
    load_tile_bf16<BM, BK, LDA, NT>(As, x, m0, M, kt * BK, K, vec);
    load_tile_bf16<BN, BK, LDA, NT>(As + BM * LDA, w, n0, N, kt * BK, K,
                                    vec);
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
    const __nv_bfloat16* As = smem + (kt % STAGES) * STAGE;
    const __nv_bfloat16* Bs = As + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * WM + i * 16) * LDA + kk,
                               LDA);
      // w is [N, K] row-major, i.e. the K x N operand in column-major
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wn * WN + j * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
          wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    int r = e / BN, c = e % BN;
    int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * LDC + c];
      if (bias != nullptr) v += __bfloat162float(bias[gn]);
      y[(size_t)gm * N + gn] = epilogue(v, act);
    }
  }
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
  if (dtype == kBFloat16) {
    auto xp = static_cast<const __nv_bfloat16*>(x);
    auto wp = static_cast<const __nv_bfloat16*>(w);
    auto bp = static_cast<const __nv_bfloat16*>(bias);
    bool vec = (K % 8 == 0) && ((uintptr_t)x % 16 == 0) &&
               ((uintptr_t)w % 16 == 0);
    if (M <= 16) {  // decode: skinny M, stream the weights in long K steps
      constexpr int BM = 16, BN = 32, BK = 128;
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      linear_bf16_kernel<BM, BN, BK, 1, 2, 3><<<grid, 64, 0, s>>>(
          xp, wp, bp, static_cast<float*>(y), M, N, K, act, vec);
    } else {
      constexpr int BM = 64, BN = 64, BK = 32;
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      linear_bf16_kernel<BM, BN, BK, 2, 2, 4><<<grid, 128, 0, s>>>(
          xp, wp, bp, static_cast<float*>(y), M, N, K, act, vec);
    }
  } else if (dtype == kFloat32) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_f32_kernel<true, true><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, act);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Modes nn (1) and tn (2) of the contraction, f32 operands, no bias or
// epilogue; mode codes shared with MODES in taper_tpu_torch/ops/gemm.py.
extern "C" int taper_gemm(const void* a, const void* b, void* y, int M,
                          int N, int K, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  auto ap = static_cast<const float*>(a);
  auto bp = static_cast<const float*>(b);
  auto yp = static_cast<float*>(y);
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  if (mode == 1) {
    gemm_f32_kernel<true, false><<<grid, 256, 0, s>>>(ap, bp, nullptr, yp, M,
                                                      N, K, kNone);
  } else if (mode == 2) {
    gemm_f32_kernel<false, false><<<grid, 256, 0, s>>>(ap, bp, nullptr, yp,
                                                       M, N, K, kNone);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* taper_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
