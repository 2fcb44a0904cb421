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

}  // namespace taper

extern "C" const char* taper_error_string(int code);
