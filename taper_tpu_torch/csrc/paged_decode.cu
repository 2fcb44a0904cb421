// Paged decode attention: one query token per slot against a KV pool
// addressed through per-slot block tables.
//
// Replaces the TPU kernel
// taper_tpu/ops/pallas/paged_attention.py::_make_paged_kernel (launched by
// _pallas_paged).  q [B, kvh, G, D] (GQA folds its G query heads per KV
// head into rows), pools [n_blocks, kvh, bs, D], tables [B, mb] int32,
// lengths [B] int32 -> o [B, kvh, G, D].  Slot b's position p lives in pool
// block tables[b, p / bs] at offset p % bs.
//
// What bounds it on the H100: device memory.  Each K/V row is read once
// and used for G dot products, far below the ~295 flop/byte the tensor
// cores need, so the kernel is a streaming read of the live K/V rows.
// What the simple design does about that:
//   * one block per (slot, KV head), eight warps; warp w takes positions
//     w, w + 8, ... of [0, length), each a contiguous D-element row, so a
//     warp's load is one coalesced row and no block past the length is
//     touched (the TPU kernel's clamped DMA skip, here by construction);
//   * the block ids come from the table inside the kernel (the TPU's
//     scalar prefetch becomes an in-kernel load);
//   * each warp keeps its own online softmax in f32 registers (base 2),
//     and the eight partial results are merged once through shared memory;
//   * four rows per warp are loaded before any is used, to keep more bytes
//     in flight.
//
// int8 pools (taper_paged_decode_int8; the TPU kernel's quant=True arm):
// pools hold int8 rows with one f32 scale per stored position,
// k_scales/v_scales [n_blocks, kvh, bs], indexed like the rows without
// their D.  q and o stay f32 or bf16.  A row of D = 128 int8 values is 128
// bytes, 4 a lane (one char4 load; D = 64: one char2), a quarter of an f32
// row and half a bf16 row, so the same warps stream the live positions in
// fewer bytes.  The int8 -> f32 convert happens in registers; the k scale
// multiplies the scalar score after warp_sum (s = q.k_int8 * scale *
// k_scale[pos]), and the v scale multiplies the softmax weight before it
// meets the row (acc += (p * v_scale[pos]) * v_int8), while the row sum l
// accumulates the unscaled p: the TPU kernel's order.  The scales are two
// 4-byte loads a position, broadcast to the warp.
// Split-K across blocks (flash-decoding) and cp.async are later work.
#include <type_traits>

#include "common.cuh"

namespace taper {

constexpr int kPdWarps = 8, kPdUnroll = 4;

template <typename T, int VPL>
struct RowVec;  // VPL consecutive T elements, one vector load
template <>
struct RowVec<__nv_bfloat16, 2> { using type = uint32_t; };
template <>
struct RowVec<__nv_bfloat16, 4> { using type = uint2; };
template <>
struct RowVec<float, 2> { using type = float2; };
template <>
struct RowVec<float, 4> { using type = float4; };
template <>
struct RowVec<int8_t, 2> { using type = char2; };
template <>
struct RowVec<int8_t, 4> { using type = char4; };

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T, int VPL>
__device__ __forceinline__ void load_row(float (&out)[VPL], const T* p) {
  using V = typename RowVec<T, VPL>::type;
  V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VPL; ++i) out[i] = to_f32(e[i]);
}

// T: q and o (f32 or bf16); P: the pools (T, or int8 with QUANT, where
// ks/vs are the per-position scales; null otherwise)
template <typename T, typename P, int D, int G, bool QUANT>
__global__ void __launch_bounds__(kPdWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                        const P* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int kvh, int bs, int mb, float scale_log2) {
  constexpr int VPL = D / 32;  // elements of a row per lane
  __shared__ float sm_m[kPdWarps][G], sm_l[kPdWarps][G];
  __shared__ float sm_acc[kPdWarps][G][D];

  const int b = blockIdx.x / kvh, h = blockIdx.x % kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // positions past the table's reach are never read (a frozen row may run
  // past its reservation; its extra tokens are discarded by the engine)
  const int len = min(lengths[b], mb * bs);
  const int* table = tables + (size_t)b * mb;

  float qr[G][VPL], acc[G][VPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, VPL>(qr[g],
                     q + ((size_t)(b * kvh + h) * G + g) * D + lane * VPL);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      qr[g][i] *= scale_log2;
      acc[g][i] = 0.0f;
    }
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }

  for (int p0 = warp * kPdUnroll; p0 < len;
       p0 += kPdWarps * kPdUnroll) {
    float kr[kPdUnroll][VPL], vr[kPdUnroll][VPL];
    float ksc[kPdUnroll], vsc[kPdUnroll];
#pragma unroll
    for (int u = 0; u < kPdUnroll; ++u) {
      int p = p0 + u;
      if (p < len) {
        size_t row = ((size_t)table[p / bs] * kvh + h) * bs + p % bs;
        load_row<P, VPL>(kr[u], kp + row * D + lane * VPL);
        load_row<P, VPL>(vr[u], vp + row * D + lane * VPL);
        if (QUANT) {
          ksc[u] = ks[row];
          vsc[u] = vs[row];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPdUnroll; ++u) {
      if (p0 + u >= len) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) s = fmaf(qr[g][i], kr[u][i], s);
        s = warp_sum(s);  // a valid position: s is finite
        if (QUANT) s *= ksc[u];
        float m_new = fmaxf(m[g], s);
        float corr = exp2f(m[g] - m_new);
        float pe = exp2f(s - m_new);
        l[g] = l[g] * corr + pe;  // the unscaled weight
        float pv = QUANT ? pe * vsc[u] : pe;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          acc[g][i] = fmaf(acc[g][i], corr, pv * vr[u][i]);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) sm_acc[warp][g][lane * VPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += kPdWarps * 32) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kPdWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.0f, den = 0.0f;
    if (mx != -INFINITY) {  // a warp with no positions weighs exp2(-inf) = 0
#pragma unroll
      for (int w = 0; w < kPdWarps; ++w) {
        float f = exp2f(sm_m[w][g] - mx);
        num = fmaf(sm_acc[w][g][d], f, num);
        den = fmaf(sm_l[w][g], f, den);
      }
    }
    float val = den > 0.0f ? num / den : 0.0f;
    o[((size_t)(b * kvh + h) * G + g) * D + d] = from_f32<T>(val);
  }
}

template <typename T, typename P, int D, bool QUANT>
int launch_paged_g(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* tables,
                   const int* lengths, void* o, int B, int kvh, int G, int bs,
                   int mb, float scale_log2, cudaStream_t s) {
  dim3 grid(B * kvh), block(kPdWarps * 32);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>(
        static_cast<const T*>(q), static_cast<const P*>(kp),
        static_cast<const P*>(vp), ks, vs, tables, lengths,
        static_cast<T*>(o), kvh, bs, mb, scale_log2);
  };
  switch (G) {
    case 1: args(paged_decode_kernel<T, P, D, 1, QUANT>); break;
    case 2: args(paged_decode_kernel<T, P, D, 2, QUANT>); break;
    case 4: args(paged_decode_kernel<T, P, D, 4, QUANT>); break;
    case 8: args(paged_decode_kernel<T, P, D, 8, QUANT>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int launch_paged_d(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* tables,
                   const int* lengths, void* o, int B, int kvh, int G, int D,
                   int bs, int mb, float scale_log2, cudaStream_t s) {
  using P = typename std::conditional<QUANT, int8_t, T>::type;
  if (D == 64)
    return launch_paged_g<T, P, 64, QUANT>(q, kp, vp, ks, vs, tables,
                                           lengths, o, B, kvh, G, bs, mb,
                                           scale_log2, s);
  if (D == 128)
    return launch_paged_g<T, P, 128, QUANT>(q, kp, vp, ks, vs, tables,
                                            lengths, o, B, kvh, G, bs, mb,
                                            scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// q of `dtype` (f32 or bf16); pools of the same type, or int8 with QUANT
template <bool QUANT>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const float* ks, const float* vs, const void* tables,
                 const void* lengths, void* o, int B, int kvh, int G, int D,
                 int bs, int mb, float scale, int dtype, void* stream) {
  if (B <= 0 || kvh <= 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  auto tb = static_cast<const int*>(tables);
  auto ln = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  float sl = scale * kLog2e;
  if (dtype == kBFloat16)
    return launch_paged_d<__nv_bfloat16, QUANT>(q, kp, vp, ks, vs, tb, ln, o,
                                                B, kvh, G, D, bs, mb, sl, s);
  if (dtype == kFloat32)
    return launch_paged_d<float, QUANT>(q, kp, vp, ks, vs, tb, ln, o, B, kvh,
                                        G, D, bs, mb, sl, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace taper

using namespace taper;

extern "C" int taper_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* lengths, void* o, int B,
                                  int kvh, int G, int D, int bs, int mb,
                                  float scale, int dtype, void* stream) {
  return launch_paged<false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                             lengths, o, B, kvh, G, D, bs, mb, scale, dtype,
                             stream);
}

// int8 pools: k_pool/v_pool int8 [n_blocks, kvh, bs, D], k_scales/v_scales
// f32 [n_blocks, kvh, bs]; q and o f32 or bf16 (dtype)
extern "C" int taper_paged_decode_int8(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* k_scales,
                                       const void* v_scales,
                                       const void* tables,
                                       const void* lengths, void* o, int B,
                                       int kvh, int G, int D, int bs, int mb,
                                       float scale, int dtype, void* stream) {
  return launch_paged<true>(q, k_pool, v_pool,
                            static_cast<const float*>(k_scales),
                            static_cast<const float*>(v_scales), tables,
                            lengths, o, B, kvh, G, D, bs, mb, scale, dtype,
                            stream);
}
