// Quantized matrix products: the four kernels of
// taper_tpu/ops/pallas/quant.py.
//
// K12 linear_q8 (replaces _q8_kernel, quant.py:41, launched by
// _linear_q8_jit) and K13 linear_q4 (_q4_kernel, quant.py:159): int8 codes
// q[N, K] or int4 codes packed two to a byte [N, K/2] (the even element in
// the low nibble), f32 out:
//   y[m,n] = scale[n] * sum_k bf16(x[m,k]) q[n,k]
//            - xsum[m] * (scale[n] zp[n])  (+ bias[n]) (+ relu | sigmoid)
// with xsum[m] = sum_k x[m,k] over the unrounded f32 activations.  The
// activations are rounded to bf16 before the product, as the TPU kernel
// does (quant.py:53); int8 and int4 codes are exact in bf16, so the
// products are exact in f32 and only the summation order differs from
// the plain version.  JAX permutes the activation's columns into the
// kernel's planar nibble order, a TPU lane trick; here each packed byte
// is unpacked in its natural interleaved order, so nothing is permuted.
// Their kernels live in quant_sm90.cu and quant_decode.cu; the entry point
// below dispatches on the route.
//
// K14 quantize_rows (_rowquant_kernel, quant.py:460): per row of x[M, K]
// (f32 or bf16), s = max(absmax, 1e-8) / 127 (a multiply by the f32
// reciprocal, as XLA runs the TPU kernel), xq = rint(x / s) as int8,
// sx = s and xsum = sum xq, the same f32 operations as the plain version,
// so codes, scales and sums are exact.  Every shape runs here: JAX's XLA
// fallback for shapes no VMEM block fits (quant.py:492-498) is not needed.
//
// K15a matmul_int8_scaled / K15b matmul_int8 (_i8mm_scaled_kernel,
// quant.py:324; _i8mm_kernel, :292): xq[M, K] int8 . q[N, K]^T int8 on the
// int8 tensor cores with int32 accumulators.  K15b writes the exact int32
// product; K15a the W8A8 epilogue in the TPU kernel's order,
//   y = (sx[m] sw[n]) (float(acc) - zw[n] corr[m]) (+ bias[n]) (+ relu),
// in f32 or bf16, through the _rn intrinsics so that nvcc contracts
// nothing into an FMA (the plain version rounds every step).
//
// What bounds them on the H100:
//   * K12/K13 at decode (M = 8 rows, weights of 1-16 MB): memory bound,
//     every weight byte read once a step (int8: 1 byte a weight, int4
//     half); at M = 2,000-4,096 rows: tensor-core bound (bf16 rate);
//   * K14: memory bound, x read once, the int8 codes written once;
//   * K15 at the W8A8 prefill (M = 4,096, N and K 2,048-8,192): int8
//     tensor-core bound, 1,979 TOP/s.
// What the designs do about that:
//   * K12 and K13 have three routes (ops/quant.py::plan_q): "wgmma"
//     (quant_sm90.cu: a row pass writes bf16 x and the row sums, then bf16
//     wgmma on a TMA ring, the codes widened to bf16 in shared memory, for
//     M > 16 where TMA reads both operands and stores y), "decode"
//     (quant_decode.cu: M <= 16 with the codes' rows whole 16-byte units
//     from aligned bases; swap-AB mma.sync with the codes widened in
//     registers, K split over a cluster) and "mma", the same mma.sync
//     kernel for every other shape (ragged K, misaligned bases, N % 4 != 0
//     at M > 16): loads as wide as the rows allow, the ragged last unit
//     zero-filled, activation rows in groups of 8 or 16 a block;
//   * K14 is one block per row: an absmax pass, then a quantize pass that
//     re-reads the row (from L1/L2), 16-byte vectors where aligned;
//   * K15 has two routes (ops/quant.py::plan): "wgmma" (quant_sm90.cu:
//     int8 wgmma fed by TMA, persistent, for K % 16 == 0 from 16-byte
//     aligned operands, every path's shapes) and "mma", the kernel below,
//     for the rest: mma.sync m16n8k32 s8 on 128x128x64 tiles (8 warps of
//     64x32) fed by a 3-stage cp.async pipeline (byte loads where the rows
//     are not whole 16-byte chunks from aligned bases), the epilogue
//     applied to the int32 accumulators in registers.  (WMMA's s8
//     fragments need 32-byte aligned addresses, which 16-byte K steps of
//     int8 cannot give; the PTX fragments load 4 bytes a register.)
#include "common.cuh"

namespace taper {

// ---------------------------------------------------------------------------
// K14: per-row activation quantization
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* p);
template <>
__device__ __forceinline__ void load8<float>(float (&v)[8], const float* p) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(
    float (&v)[8], const __nv_bfloat16* p) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, s)));  // rint
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, float* __restrict__ xsum,
                         int K, bool vec) {
  __shared__ float red_max[kRowThreads / 32];
  __shared__ int red_sum[kRowThreads / 32];
  __shared__ float row_scale;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * K;

  float a = 0.0f;
  if (vec) {
    for (int k = tid * 8; k < K; k += kRowThreads * 8) {
      float v[8];
      load8(v, xr + k);
#pragma unroll
      for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(v[e]));
    }
  } else {
    for (int k = tid; k < K; k += kRowThreads)
      a = fmaxf(a, fabsf(to_f32(xr[k])));
  }
  a = warp_max(a);
  if (lane == 0) red_max[warp] = a;
  __syncthreads();
  if (tid == 0) {
    float m = red_max[0];
    for (int w = 1; w < kRowThreads / 32; ++w) m = fmaxf(m, red_max[w]);
    // / 127 as XLA runs the TPU kernel's division by the constant: a
    // multiply by its f32 reciprocal
    row_scale = __fmul_rn(fmaxf(m, 1e-8f), 1.0f / 127.0f);
  }
  __syncthreads();
  const float s = row_scale;

  int sum = 0;  // exact: at most 127 K
  if (vec) {
    for (int k = tid * 8; k < K; k += kRowThreads * 8) {
      float v[8];
      load8(v, xr + k);
      __align__(8) int8_t c[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = quantize_one(v[e], s);
        sum += c[e];
      }
      *reinterpret_cast<uint2*>(qr + k) = *reinterpret_cast<uint2*>(c);
    }
  } else {
    for (int k = tid; k < K; k += kRowThreads) {
      int8_t c = quantize_one(to_f32(xr[k]), s);
      qr[k] = c;
      sum += c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kRowThreads / 32; ++w) total += red_sum[w];
    sx[blockIdx.x] = s;
    xsum[blockIdx.x] = static_cast<float>(total);
  }
}

// ---------------------------------------------------------------------------
// K15a / K15b: int8 x int8 -> int32 on the tensor cores
// ---------------------------------------------------------------------------

enum I8Out : int { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };

constexpr int I8_BM = 128, I8_BN = 128, I8_BK = 64, I8_STAGES = 3;
constexpr int I8_WARPS_M = 2, I8_WARPS_N = 4;
constexpr int I8_NT = I8_WARPS_M * I8_WARPS_N * 32;
constexpr int I8_LD = I8_BK + 16;  // bytes; a multiple of 16 for WMMA
constexpr int I8_STAGE = (I8_BM + I8_BN) * I8_LD;
constexpr size_t I8_SMEM = (size_t)I8_STAGES * I8_STAGE;

// Starts loading the [ROWS, I8_BK] int8 tile at (r0, k0) of a row-major
// [rows, K] matrix: 16-byte cp.async chunks zero-filled past the edges
// when `vec` (K % 16 == 0 and 16-byte aligned bases), else byte by byte.
template <int ROWS>
__device__ __forceinline__ void load_tile_i8(int8_t* sm, const int8_t* g,
                                             int r0, int rows, int k0, int K,
                                             bool vec) {
  constexpr int CPR = I8_BK / 16;
  for (int c = threadIdx.x; c < ROWS * CPR; c += I8_NT) {
    const int r = c / CPR, kc = (c % CPR) * 16;
    const int gr = r0 + r, gk = k0 + kc;
    int8_t* dst = sm + r * I8_LD + kc;
    if (vec) {
      const bool in = gr < rows && gk < K;
      cp_async16(dst, in ? g + (size_t)gr * K + gk : g, in);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (gr < rows && gk + e < K) ? g[(size_t)gr * K + gk + e] : 0;
    }
  }
}

// One m16n8k32 int8 tensor-core product, accumulated in place (PTX
// fragment layouts: a = A[g][4t..], A[g+8][4t..], A[g][16+4t..],
// A[g+8][16+4t..]; b = B[4t..][g], B[16+4t..][g]; c = C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1], with g = lane / 4 and t = lane % 4).
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int OUT>
__global__ void __launch_bounds__(I8_NT)
    matmul_int8_kernel(const int8_t* __restrict__ xq,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ sx,
                       const float* __restrict__ corr,
                       const float* __restrict__ sw,
                       const float* __restrict__ zw,
                       const float* __restrict__ bias, void* __restrict__ y,
                       int M, int N, int K, int relu, bool vec) {
  constexpr int WM = I8_BM / I8_WARPS_M, WN = I8_BN / I8_WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 8;  // m16n8k32 fragments a warp
  extern __shared__ __align__(128) unsigned char i8_smem[];
  int8_t* smem = reinterpret_cast<int8_t*>(i8_smem);

  const int m0 = blockIdx.y * I8_BM, n0 = blockIdx.x * I8_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / I8_WARPS_N, wn = warp % I8_WARPS_N;
  const int KT = (K + I8_BK - 1) / I8_BK;

  auto load_stage = [&](int kt) {
    int8_t* As = smem + (kt % I8_STAGES) * I8_STAGE;
    int8_t* Bs = As + I8_BM * I8_LD;
    load_tile_i8<I8_BM>(As, xq, m0, M, kt * I8_BK, K, vec);
    load_tile_i8<I8_BN>(Bs, q, n0, N, kt * I8_BK, K, vec);
  };

  int acc[FM][FN][4] = {};
#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();  // one group per stage, empty ones included
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<I8_STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread; kt-1 is free
    if (kt + I8_STAGES - 1 < KT) load_stage(kt + I8_STAGES - 1);
    cp_async_commit();
    const int8_t* As = smem + (kt % I8_STAGES) * I8_STAGE;
    const int8_t* Bs = As + I8_BM * I8_LD;
#pragma unroll
    for (int kk = 0; kk < I8_BK; kk += 32) {
      unsigned a[FM][4], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int8_t* p = As + (wm * WM + i * 16 + g) * I8_LD + kk + 4 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * I8_LD);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * I8_LD + 16);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // the [N, K] row-major tile is B = q^T in column-major
        const int8_t* p = Bs + (wn * WN + j * 8 + g) * I8_LD + kk + 4 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm * WM + i * 16 + g + (r >> 1) * 8;
        const int gn = n0 + wn * WN + j * 8 + 2 * t + (r & 1);
        if (gm >= M || gn >= N) continue;
        const size_t o = (size_t)gm * N + gn;
        if constexpr (OUT == kOutI32) {
          static_cast<int*>(y)[o] = acc[i][j][r];
        } else {
          float v = __fmul_rn(__fmul_rn(sx[gm], sw[gn]),
                              __fsub_rn(__int2float_rn(acc[i][j][r]),
                                        __fmul_rn(zw[gn], corr[gm])));
          if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
          if (relu) v = fmaxf(v, 0.0f);
          if constexpr (OUT == kOutBF16)
            static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
          else
            static_cast<float*>(y)[o] = v;
        }
      }
}

template <int OUT>
int launch_matmul_int8(const void* xq, const void* q, const void* sx,
                       const void* corr, const void* sw, const void* zw,
                       const void* bias, void* y, int M, int N, int K,
                       int relu, cudaStream_t s) {
  auto kernel = matmul_int8_kernel<OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)I8_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + I8_BN - 1) / I8_BN, (M + I8_BM - 1) / I8_BM);
  kernel<<<grid, I8_NT, I8_SMEM, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(q),
      static_cast<const float*>(sx), static_cast<const float*>(corr),
      static_cast<const float*>(sw), static_cast<const float*>(zw),
      static_cast<const float*>(bias), y, M, N, K, relu,
      K % 16 == 0 && (uintptr_t)xq % 16 == 0 && (uintptr_t)q % 16 == 0);
  return (int)cudaGetLastError();
}

// quant_sm90.cu: K15 on the wgmma route
int matmul_int8_wgmma(const void* xq, const void* q, const void* sx,
                      const void* corr, const void* sw, const void* zw,
                      const void* bias, void* y, int M, int N, int K,
                      int relu, int out, cudaStream_t s);

// K15's route codes, shared with I8_ROUTES in ops/quant.py
enum I8Route : int { kI8Wgmma = 0, kI8Mma = 1 };

// quant_sm90.cu: K12/K13 on the wgmma route
int linear_q_wgmma(const void* x, const void* q, const QTerms& qt,
                   const void* bias, void* y, void* ws, int M, int N, int K,
                   int bits, int act, cudaStream_t s);

// quant_decode.cu: K12/K13 on the mma.sync kernel (the decode and mma
// routes)
int linear_q_mma(const float* x, const uint8_t* q, const QTerms& qt,
                 const float* bias, float* y, int M, int N, int K, int bits,
                 int act, int splits, int rows, bool decode, cudaStream_t s);

// K12/K13's route codes, shared with Q8_ROUTES in ops/quant.py
enum Q8Route : int { kQ8Wgmma = 0, kQ8Mma = 1, kQ8Decode = 2 };

}  // namespace taper

using namespace taper;

// K12 (bits 8) and K13 (bits 4) on the route ops/quant.py::plan_q chose
// (Q8Route); act codes of ACTIVATIONS in ops/gemm.py; scale (f32) and zp
// (f32, or int32 where zp_int) read with strides scale_stride and
// zp_stride (0: one value, 1: [N]).  The wgmma route needs K % 16 == 0
// (int8) or K % 32 == 0 (int4), N % 4 == 0, 16-byte-aligned x, q and y,
// and ``ws`` (M K bf16 and M f32); the decode route M <= 16, K % 16 == 0
// (int8) or K % 32 == 0 (int4) and 16-byte-aligned x and q; the mma route
// any shape (K even for int4, x 4-byte aligned).  decode and mma take
// activation rows in groups of ``rows`` (8 or 16) and K split over a
// cluster of ``splits`` (1..8; 1 on the wgmma route).
extern "C" int taper_linear_q(const void* x, const void* q,
                              const void* scale, const void* zp,
                              const void* bias, void* y, void* ws, int M,
                              int N, int K, int bits, int act, int route,
                              void* stream, int splits, int rows,
                              int scale_stride, int zp_stride, int zp_int) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (bits != 8 && bits != 4) ||
      (bits == 4 && K % 2) || scale_stride < 0 || scale_stride > 1 ||
      zp_stride < 0 || zp_stride > 1)
    return (int)cudaErrorInvalidValue;
  const QTerms qt = {static_cast<const float*>(scale), zp, scale_stride,
                     zp_stride, zp_int != 0};
  if (route == kQ8Wgmma) {
    if (K % (bits == 8 ? 16 : 32) || N % 4 || (uintptr_t)x % 16 ||
        (uintptr_t)q % 16 || (uintptr_t)y % 16 || ws == nullptr)
      return (int)cudaErrorInvalidValue;
    return linear_q_wgmma(x, q, qt, bias, y, ws, M, N, K, bits, act, s);
  }
  if (route != kQ8Decode && route != kQ8Mma)
    return (int)cudaErrorInvalidValue;
  return linear_q_mma(static_cast<const float*>(x),
                      static_cast<const uint8_t*>(q), qt,
                      static_cast<const float*>(bias), static_cast<float*>(y),
                      M, N, K, bits, act, splits, rows, route == kQ8Decode,
                      s);
}

// K14; dtype codes of DTYPES in ops/_build.py.
extern "C" int taper_quantize_rows(const void* x, void* xq, void* sx,
                                   void* xsum, int M, int K, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = K % 8 == 0;  // 16-byte loads, 8-byte code stores
  auto q = static_cast<int8_t*>(xq);
  auto sp = static_cast<float*>(sx), xs = static_cast<float*>(xsum);
  if (dtype == kBFloat16)
    quantize_rows_kernel<__nv_bfloat16><<<M, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, sp, xs, K, vec);
  else if (dtype == kFloat32)
    quantize_rows_kernel<float><<<M, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), q, sp, xs, K, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K15a (out dtype f32 or bf16, with sx/corr/sw/zw) and K15b (out dtype
// int32, the vectors null) on the route ops/quant.py::plan chose (the
// wgmma route needs K % 16 == 0 and 16-byte aligned xq and q).
extern "C" int taper_matmul_int8(const void* xq, const void* q,
                                 const void* sx, const void* corr,
                                 const void* sw, const void* zw,
                                 const void* bias, void* y, int M, int N,
                                 int K, int relu, int out_dtype, int route,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || out_dtype < kOutF32 ||
      out_dtype > kOutI32 ||
      (out_dtype != kOutI32 &&
       (sx == nullptr || corr == nullptr || sw == nullptr || zw == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (route == kI8Wgmma) {
    if (K % 16 || (uintptr_t)xq % 16 || (uintptr_t)q % 16)
      return (int)cudaErrorInvalidValue;
    return matmul_int8_wgmma(xq, q, sx, corr, sw, zw, bias, y, M, N, K, relu,
                             out_dtype, s);
  }
  if (route != kI8Mma) return (int)cudaErrorInvalidValue;
  if (out_dtype == kOutI32)
    return launch_matmul_int8<kOutI32>(xq, q, sx, corr, sw, zw, bias, y, M,
                                       N, K, relu, s);
  if (out_dtype == kOutBF16)
    return launch_matmul_int8<kOutBF16>(xq, q, sx, corr, sw, zw, bias, y, M,
                                        N, K, relu, s);
  if (out_dtype == kOutF32)
    return launch_matmul_int8<kOutF32>(xq, q, sx, corr, sw, zw, bias, y, M,
                                       N, K, relu, s);
  return (int)cudaErrorInvalidValue;
}
