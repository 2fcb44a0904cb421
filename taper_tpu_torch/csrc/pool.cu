// Max and average pooling with stride == kernel and no padding, f32, over
// [planes, H, W] (planes = N*C of an NCHW tensor):
//   y[p, oy, ox] = max or mean over the kh x kw window at (oy*kh, ox*kw),
//   Ho = H / kh and Wo = W / kw (ragged tails are floored away).
//
// Replaces the TPU kernel taper_tpu/ops/pallas/pool.py::_pool_kernel
// (launched by _pool_pallas).  On the TPU, Mosaic has no strided vector
// slices, so the kernel pools rows on the VPU and selects columns with 0/1
// matmuls on the MXU, and only planes with Wo >= 8 ran it.  Here every
// thread indexes memory freely, and every such shape runs the kernel,
// including the 14->7 max pool and the 7x7 global average pool.
//
// What bounds it on the H100: pure data movement (about one read of the
// input and a quarter of it written for 2x2), a few MB per call for the
// reference CNN: memory bound, 3.35 TB/s.
// What the simple design does about that:
//   * small windows (kh*kw < 32): one thread per output element loops over
//     its window; consecutive threads take consecutive output columns, so
//     the warp's reads of each window row are contiguous;
//   * large windows (the global 7x7 average): one warp per output element,
//     lanes stride over the window and a shuffle reduction combines them,
//     so a 49-element plane is read by 32 lanes in two coalesced passes.
// The sum of an average is divided by kh*kw after the reduction, as the
// TPU kernel does.
#include "common.cuh"

namespace taper {
namespace {

enum PoolMode : int { kMax = 0, kAvg = 1 };

__global__ void pool_thread_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, int planes, int H,
                                   int W, int kh, int kw, int mode) {
  const int Ho = H / kh, Wo = W / kw;
  const long total = (long)planes * Ho * Wo;
  long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int ox = e % Wo;
  long r = e / Wo;
  int oy = r % Ho;
  long p = r / Ho;
  const float* win = x + ((size_t)p * H + (size_t)oy * kh) * W + ox * kw;
  float acc = mode == kMax ? -INFINITY : 0.0f;
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) {
      float v = win[i * W + j];
      acc = mode == kMax ? fmaxf(acc, v) : acc + v;
    }
  y[e] = mode == kMax ? acc : acc / (float)(kh * kw);
}

__global__ void pool_warp_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int planes, int H,
                                 int W, int kh, int kw, int mode) {
  const int Ho = H / kh, Wo = W / kw;
  const long total = (long)planes * Ho * Wo;
  long e = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (e >= total) return;  // whole warps leave together
  int ox = e % Wo;
  long r = e / Wo;
  int oy = r % Ho;
  long p = r / Ho;
  const float* win = x + ((size_t)p * H + (size_t)oy * kh) * W + ox * kw;
  float acc = mode == kMax ? -INFINITY : 0.0f;
  for (int t = lane; t < kh * kw; t += 32) {
    float v = win[(t / kw) * W + t % kw];
    acc = mode == kMax ? fmaxf(acc, v) : acc + v;
  }
  acc = mode == kMax ? warp_max(acc) : warp_sum(acc);
  if (lane == 0) y[e] = mode == kMax ? acc : acc / (float)(kh * kw);
}

}  // namespace
}  // namespace taper

using namespace taper;

// x: [planes, H, W]; y: [planes, H / kh, W / kw]; mode 0 max, 1 average
// (codes shared with POOL_MODES in taper_tpu_torch/ops/pool.py).
extern "C" int taper_pool(const void* x, void* y, int planes, int H, int W,
                          int kh, int kw, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || kh <= 0 || kw <= 0 || H < kh || W < kw ||
      (mode != kMax && mode != kAvg))
    return (int)cudaErrorInvalidValue;
  long total = (long)planes * (H / kh) * (W / kw);
  auto xp = static_cast<const float*>(x);
  auto yp = static_cast<float*>(y);
  if (kh * kw >= 32) {
    long blocks = (total * 32 + 255) / 256;
    pool_warp_kernel<<<(unsigned)blocks, 256, 0, s>>>(xp, yp, planes, H, W,
                                                      kh, kw, mode);
  } else {
    long blocks = (total + 255) / 256;
    pool_thread_kernel<<<(unsigned)blocks, 256, 0, s>>>(xp, yp, planes, H, W,
                                                        kh, kw, mode);
  }
  return (int)cudaGetLastError();
}
