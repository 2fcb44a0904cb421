// Fused optimizer updates over a list of f32 tensors, one launch per list
// (multi-tensor apply), in place:
//   Adam/AdamW (decoupled = 0/1), per element, in the JAX package's order
//   (taper_tpu/ops/pallas/optim_kernels.py:60-73):
//     g += wd * p                      (Adam with wd != 0: L2 decay)
//     m  = b1 * m + (1 - b1) * g
//     v  = b2 * v + (1 - b2) * g * g
//     p *= 1 - lr * wd                 (AdamW with wd != 0: decoupled)
//     p -= step_size * m / (sqrt(v) + eps)
//   SGD (:79-101): g += wd * p; m = momentum * m + g and p -= lr * m with
//   momentum, p -= lr * g without (m is then absent).
// lr and the bias-corrected step_size are launch arguments, computed on
// the host, so a schedule changes no code.  A null gradient pointer is a
// zero gradient (a parameter the loss did not reach; weight decay still
// moves it), so the caller allocates no zeros.
//
// Replaces the TPU kernels taper_tpu/ops/pallas/optim_kernels.py::
// _adam_kernel (launched by _adam_update_flat_jit) and _sgd_kernel
// (sgd_update_flat).  The TPU kernel streams ONE raveled vector of every
// parameter; the ravel/pad/unravel copies around it tripled the step's
// HBM traffic, which is why the JAX package keeps it opt-in
// (taper_tpu/optim.py:112-126).  Here no copy is made: one launch walks a
// table of the tensors themselves.  The table (pointers, sizes, the first
// block of each tensor) travels in the kernel's by-value parameters
// (__grid_constant__, up to 32 KB since CUDA 12.1), so a step makes no
// host-to-device copy of it; each block finds its tensor by a binary search
// over the first-block column and owns one chunk of kChunk elements.
// Lists longer than kMaxTensors go in several launches (the wrapper splits
// them).
//
// What bounds it on the H100: bytes.  Adam reads p, g, m, v and writes p, m,
// v: 7 f32 streams, 28 bytes a parameter (24 with a null gradient), ~10
// flops: memory bound at 3.35 TB/s (the 170M TinyGPT: 4.76 GB, ~1.42 ms).
// SGD with momentum moves 5 streams, without 3.  What the design does:
// 16-byte vector accesses (every tensor is 16-byte aligned, checked by the
// wrapper, and a chunk starts at a multiple of kChunk) with a scalar tail,
// and 32 elements a thread, so each thread keeps several loads in flight.
// sqrtf and '/' stay IEEE (no --use_fast_math); nvcc contracts a*b+c into
// FMAs, so results differ from the plain PyTorch version in the last bits.
#include "common.cuh"

namespace taper {
namespace {

// shared with TABLE and CHUNK in taper_tpu_torch/ops/optim_kernels.py
constexpr int kMaxTensors = 256;
constexpr int kChunk = 8192;       // elements per block
constexpr int kThreads = 256;

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];     // null: a zero gradient
  float* m[kMaxTensors];           // null: SGD without momentum
  float* v[kMaxTensors];           // Adam only
  int64_t n[kMaxTensors];
  int first_block[kMaxTensors + 1];
  int count;
};

struct Hyper {
  float lr, step_size, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  float momentum;
  int decoupled;
};

enum Alg : int { kAdam = 0, kSgd = 1 };

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const Hyper& h) {
  if (h.wd != 0.0f && !h.decoupled) g = g + h.wd * p;
  m = h.b1 * m + h.one_minus_b1 * g;
  v = h.b2 * v + h.one_minus_b2 * g * g;
  if (h.wd != 0.0f && h.decoupled) p = p * (1.0f - h.lr * h.wd);
  p = p - h.step_size * m / (sqrtf(v) + h.eps);
}

__device__ __forceinline__ void sgd_elem(float& p, float g, float& m,
                                         bool has_m, const Hyper& h) {
  if (h.wd != 0.0f) g = g + h.wd * p;
  if (has_m) {
    m = h.momentum * m + g;
    g = m;
  }
  p = p - h.lr * g;
}

template <int ALG>
__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, bool has_m,
                                        const Hyper& h) {
  if (ALG == kAdam) {
    adam_elem(p.x, g.x, m.x, v.x, h);
    adam_elem(p.y, g.y, m.y, v.y, h);
    adam_elem(p.z, g.z, m.z, v.z, h);
    adam_elem(p.w, g.w, m.w, v.w, h);
  } else {
    sgd_elem(p.x, g.x, m.x, has_m, h);
    sgd_elem(p.y, g.y, m.y, has_m, h);
    sgd_elem(p.z, g.z, m.z, has_m, h);
    sgd_elem(p.w, g.w, m.w, has_m, h);
  }
}

template <int ALG>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_kernel(const __grid_constant__ Table t, const Hyper h) {
  // the tensor whose chunk this block owns: the last with first_block <=
  // blockIdx.x
  int lo = 0, hi = t.count - 1;
  const int block = blockIdx.x;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= block) lo = mid; else hi = mid - 1;
  }
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  const bool has_m = m != nullptr;
  const int64_t n = t.n[lo];
  const int64_t start = (int64_t)(block - t.first_block[lo]) * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = start + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    if (i + 4 <= end) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 gv = g ? *reinterpret_cast<const float4*>(g + i) : zero4;
      float4 mv = has_m ? *reinterpret_cast<const float4*>(m + i) : zero4;
      float4 vv = ALG == kAdam ? *reinterpret_cast<const float4*>(v + i)
                               : zero4;
      update4<ALG>(pv, gv, mv, vv, has_m, h);
      *reinterpret_cast<float4*>(p + i) = pv;
      if (has_m) *reinterpret_cast<float4*>(m + i) = mv;
      if (ALG == kAdam) *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (int64_t j = i; j < end; ++j) {
        float pj = p[j], gj = g ? g[j] : 0.0f;
        float mj = has_m ? m[j] : 0.0f;
        float vj = ALG == kAdam ? v[j] : 0.0f;
        if (ALG == kAdam) adam_elem(pj, gj, mj, vj, h);
        else sgd_elem(pj, gj, mj, has_m, h);
        p[j] = pj;
        if (has_m) m[j] = mj;
        if (ALG == kAdam) v[j] = vj;
      }
    }
  }
}

// Fills the table from host arrays of count <= kMaxTensors entries and
// launches once.
template <int ALG>
int launch(const uint64_t* p, const uint64_t* g, const uint64_t* m,
           const uint64_t* v, const int64_t* n, int count, const Hyper& h,
           void* stream) {
  if (count <= 0 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || !p[i] || (ALG == kAdam && (!m[i] || !v[i])))
      return (int)cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.m[i] = m ? reinterpret_cast<float*>(m[i]) : nullptr;
    t.v[i] = ALG == kAdam ? reinterpret_cast<float*>(v[i]) : nullptr;
    t.n[i] = n[i];
    t.first_block[i] = blocks;
    int64_t chunks = (n[i] + kChunk - 1) / kChunk;
    if (blocks + chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    blocks += (int)chunks;
  }
  t.first_block[count] = blocks;
  t.count = count;
  multi_tensor_kernel<ALG><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(t, h);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace taper

using namespace taper;

// p, g, m, v: host arrays of count device pointers (g[i] may be 0); n: the
// element counts.  One launch; count <= 256.
extern "C" int taper_adam(const uint64_t* p, const uint64_t* g,
                          const uint64_t* m, const uint64_t* v,
                          const int64_t* n, int count, float lr,
                          float step_size, float b1, float one_minus_b1,
                          float b2, float one_minus_b2, float eps, float wd,
                          int decoupled, void* stream) {
  Hyper h{lr, step_size, b1, one_minus_b1, b2, one_minus_b2, eps, wd, 0.0f,
          decoupled};
  return launch<kAdam>(p, g, m, v, n, count, h, stream);
}

// p, g, m: as taper_adam; m is a null array without momentum.
extern "C" int taper_sgd(const uint64_t* p, const uint64_t* g,
                         const uint64_t* m, const int64_t* n, int count,
                         float lr, float momentum, float wd, void* stream) {
  Hyper h{lr, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, wd, momentum, 0};
  return launch<kSgd>(p, g, m, nullptr, n, count, h, stream);
}
