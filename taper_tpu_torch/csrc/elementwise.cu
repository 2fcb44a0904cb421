// Elementwise ops over flat contiguous operands of one shape and dtype
// (f32 or bf16, computed in f32, rounded once on the store):
//   relu   y = max(a, 0)          sigmoid y = 1 / (1 + exp(-a))
//   add    y = a + b              mul     y = a * b
//   sub    y = a - b              div     y = a / b
//   fma    y = a * b + c, rounded once (fmaf)
//
// Replaces the TPU kernels taper_tpu/ops/pallas/elementwise.py
// (_relu/_sigmoid/_add/_mul/_fma/_sub/_div_kernel, launched by _ew_call).
// On the TPU the operands are flattened and padded to [rows, 128] lane
// tiles, and each grid step streams a 512 x 128 block through VMEM.  The
// padding is a lane artefact: here the kernel walks the flat arrays and
// masks the tail instead, so nothing is copied.
//
// What bounds it on the H100: bytes.  Each element is read once per input
// and written once, with at most a few flops: memory bound at 3.35 TB/s
// (ResNet-8's stem relu, [256,16,32,32] f32, moves 33.5 MB: ~10 us).
// What the design does about that:
//   * 16-byte vector loads and stores (4 f32 or 8 bf16 per thread) when
//     every operand is 16-byte aligned, a scalar pass for the last
//     n % (16 / sizeof(T)) elements (or the whole array when a pointer is
//     not aligned);
//   * a grid-stride loop over enough blocks to fill the card, so a block
//     keeps several loads in flight, and one launch covers any size.
// sqrtf, expf and '/' stay IEEE (no --use_fast_math): sigmoid and div are
// within 2 ulp of PyTorch's, relu/add/sub/mul bit-equal.
#include <algorithm>

#include "common.cuh"

namespace taper {
namespace {

// op codes shared with OPS in taper_tpu_torch/ops/elementwise.py
enum EwOp : int {
  kEwRelu = 0, kEwSigmoid = 1, kEwAdd = 2, kEwMul = 3, kEwFma = 4,
  kEwSub = 5, kEwDiv = 6
};

template <int OP>
__device__ __forceinline__ float ew_apply(float a, float b, float c) {
  if (OP == kEwRelu) return a < 0.0f ? 0.0f : a;  // NaN passes, as max
  if (OP == kEwSigmoid) return 1.0f / (1.0f + expf(-a));
  if (OP == kEwAdd) return a + b;
  if (OP == kEwMul) return a * b;
  if (OP == kEwFma) return fmaf(a, b, c);
  if (OP == kEwSub) return a - b;
  return a / b;
}

template <int OP>
__host__ __device__ constexpr int ew_arity() {
  return OP == kEwRelu || OP == kEwSigmoid ? 1 : (OP == kEwFma ? 3 : 2);
}

template <typename T, int OP>
__global__ void __launch_bounds__(256)
    ew_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, T* __restrict__ y, int64_t n,
              int vectorized) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte access
  constexpr int NIN = ew_arity<OP>();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vectorized ? n / V : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    alignas(16) T va[V], vb[V], vc[V], vy[V];
    *reinterpret_cast<uint4*>(va) = reinterpret_cast<const uint4*>(a)[i];
    if (NIN > 1)
      *reinterpret_cast<uint4*>(vb) = reinterpret_cast<const uint4*>(b)[i];
    if (NIN > 2)
      *reinterpret_cast<uint4*>(vc) = reinterpret_cast<const uint4*>(c)[i];
#pragma unroll
    for (int j = 0; j < V; ++j)
      vy[j] = from_f32<T>(ew_apply<OP>(
          to_f32(va[j]), NIN > 1 ? to_f32(vb[j]) : 0.0f,
          NIN > 2 ? to_f32(vc[j]) : 0.0f));
    reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<uint4*>(vy);
  }
  // the tail past the last whole vector (or everything, unaligned)
  for (int64_t i = nvec * V + tid; i < n; i += stride)
    y[i] = from_f32<T>(ew_apply<OP>(to_f32(a[i]),
                                    NIN > 1 ? to_f32(b[i]) : 0.0f,
                                    NIN > 2 ? to_f32(c[i]) : 0.0f));
}

template <typename T>
cudaError_t ew_launch(const void* a, const void* b, const void* c, void* y,
                      int64_t n, int op, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)y) % 16 == 0;
  const int64_t work = aligned ? n / V + n % V : n;
  // enough 256-thread blocks to fill 132 SMs several times over; the
  // grid-stride loop covers the rest
  const unsigned blocks =
      (unsigned)std::min<int64_t>((work + 255) / 256, 132 * 16);
  auto pa = static_cast<const T*>(a);
  auto pb = static_cast<const T*>(b);
  auto pc = static_cast<const T*>(c);
  auto py = static_cast<T*>(y);
  const int vec = aligned ? 1 : 0;
  switch (op) {
#define TAPER_EW_CASE(OPCODE)                                               \
  case OPCODE:                                                              \
    ew_kernel<T, OPCODE><<<blocks, 256, 0, s>>>(pa, pb, pc, py, n, vec);    \
    break;
    TAPER_EW_CASE(kEwRelu)
    TAPER_EW_CASE(kEwSigmoid)
    TAPER_EW_CASE(kEwAdd)
    TAPER_EW_CASE(kEwMul)
    TAPER_EW_CASE(kEwFma)
    TAPER_EW_CASE(kEwSub)
    TAPER_EW_CASE(kEwDiv)
#undef TAPER_EW_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace taper

using namespace taper;

// a, b, c, y: n contiguous elements of one dtype (b and c may be null for
// the ops that do not read them); op: an EwOp code; dtype: 0 f32, 1 bf16.
extern "C" int taper_elementwise(const void* a, const void* b, const void* c,
                                 void* y, int64_t n, int op, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || op < kEwRelu || op > kEwDiv) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) return (int)ew_launch<float>(a, b, c, y, n, op, s);
  if (dtype == kBFloat16)
    return (int)ew_launch<__nv_bfloat16>(a, b, c, y, n, op, s);
  return (int)cudaErrorInvalidValue;
}
