// Shared helpers for the hand-written Hopper kernels of taper_tpu_torch.
//
// Every C entry point in csrc/ takes raw device pointers and the caller's
// CUDA stream (PyTorch's current stream, passed in from Python through
// ctypes), launches on that stream without synchronising, and returns
// cudaGetLastError() so that a launch the runtime refused (too many
// threads, too much shared memory) is reported to the Python wrapper,
// which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace taper {

// dtype codes shared with taper_tpu_torch/ops/_build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte global->shared copy that zero-fills when `in` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// 4-byte global->shared copy that zero-fills when `in` is false (src must
// still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The card's SM count (the current device's, read once).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

constexpr float kLog2e = 1.4426950408889634f;

// Fused epilogues of the GEMM and convolution kernels; codes shared with
// ACTIVATIONS in taper_tpu_torch/ops/gemm.py.
enum Act : int { kNone = 0, kRelu = 1, kSigmoid = 2 };

__device__ __forceinline__ float epilogue(float acc, int act) {
  if (act == kRelu) return fmaxf(acc, 0.0f);
  if (act == kSigmoid) return 1.0f / (1.0f + __expf(-acc));
  return acc;
}

// K12/K13's affine step, scale . acc - xsum . (scale . zp), each product
// and the difference rounded on their own (no FMA contraction), as the
// plain version's separate operations are.
__device__ __forceinline__ float q_affine(float acc, float xs, float s,
                                          float z) {
  return __fsub_rn(__fmul_rn(acc, s), __fmul_rn(xs, __fmul_rn(s, z)));
}

// scale . acc - xsum . (scale . zp) (+ bias), each step rounded (no FMA
// contraction), then the none/relu/sigmoid epilogue.
__device__ __forceinline__ float q_epilogue(float acc, float xs, float s,
                                            float z, const float* bias,
                                            int n, int act) {
  float out = q_affine(acc, xs, s, z);
  if (bias != nullptr) out = __fadd_rn(out, bias[n]);
  return epilogue(out, act);
}

// K12/K13's scale and zero point as their kernels read them: one value
// for every channel (stride 0) or one a channel (stride 1); the zero point
// in f32 or, as PTQ stores it, in int32 (exact in f32 below 2^24), read
// where it lies, so that a call copies neither.
struct QTerms {
  const float* scale;
  const void* zp;
  int ss, zs;
  bool zp_int;
  __device__ __forceinline__ float s(int n) const { return scale[n * ss]; }
  __device__ __forceinline__ float z(int n) const {
    return zp_int ? (float)static_cast<const int*>(zp)[n * zs]
                  : static_cast<const float*>(zp)[n * zs];
  }
};

// Four int8 codes (the first in the low byte) as four bf16, two to a
// word: each byte, biased to unsigned, becomes the mantissa of 2^23 and
// the bias 2^23 + 128 is subtracted, exactly; the integer, of at most 8
// significant bits, is exact in bf16, whose bits are its f32's upper 16.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
        8388736.0f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

}  // namespace taper

extern "C" const char* taper_error_string(int code);
