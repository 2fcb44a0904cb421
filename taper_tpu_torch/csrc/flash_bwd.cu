// Flash attention backward: dQ, dK and dV from q, k, v, the forward's
// output o and row logsumexp lse, and the output's cotangent do.
//
// Replaces the two TPU kernels of taper_tpu/ops/pallas/attention.py that
// _flash_bwd_impl launches in order on the default path:
//   * flash_dq_kernel (K6, _dq_kernel): one block per (batch * head, 64-row
//     query tile) loops over the KV tiles up to the diagonal.  It first
//     computes delta = rowsum(dO * O) for its rows and exports it (as
//     _dq_kernel does; JAX also subtracts an lse cotangent there, which
//     only its flash_attention_lse has), then per KV tile p = exp(s - lse),
//     ds = p * (dO V^T - delta), dQ += ds K, with ds cast to the input
//     dtype before its product; the scale is applied once at the end.
//   * flash_dkv_kernel (K7, _dkv_kernel): one block per (batch * KV head,
//     64-row KV tile) loops over the query tiles from the diagonal down,
//     and over the query heads of its GQA group in a fixed order.  It
//     works on transposed tiles, s^T = K Q^T, so that every product is a
//     plain one: dV += p^T dO with p cast to dO's dtype, dK += ds^T Q with
//     ds cast to Q's dtype, and dK is scaled once at the end.  The group's
//     query heads sum into the same f32 accumulators before the one cast:
//     no partials at query-head width, no atomics, and the result is the
//     same bits on every run (JAX sums per-head partials after its kernel).
// Both read the forward's strides (Layout), so the projections' [B, S, H*D]
// layout needs no copy in either direction.
//
// What bounds them on the H100: tensor-core work, 6 S^2 D (dQ: QK^T, dO V^T,
// dS K) and 8 S^2 D (dK/dV: KQ^T, VdO^T, P^T dO, dS^T Q) per head, halved
// by causality; at the training shape (B 8, H 8, S 2048, D 128, bf16) about
// 1.0e11 and 1.4e11 FLOP, ~100 and ~140 us at 989 TFLOP/s.  Device memory
// traffic is O(S * D) per head.
// What the simple design does about that:
//   * the products are WMMA 16x16x16 tensor-core tiles out of shared
//     memory for bf16 (FMA loops for f32), as in the forward;
//   * dQ (K6) and dK/dV (K7) stay in registers for the whole sweep, as WMMA
//     accumulator fragments, so they cost no shared-memory round trip per
//     tile; the scores and the weights go through shared memory, where
//     their elementwise step reads them row by row;
//   * causal tiles on the far side of the diagonal are skipped, the
//     longest query rows of K6 are scheduled first (K7's first KV tiles
//     are its longest), ragged S is masked in the kernel.
// A single fused sweep (K10), mma.sync/wgmma fragments with the softmax in
// registers, and TMA are later work.
#include "flash_common.cuh"

namespace taper {
namespace flash {

// Shared memory of both kernels: four [64, D] tiles, two f32 score tiles,
// one weight tile and two row vectors.
template <typename T, int D>
struct BwdSmem {
  using L = Tiles<T, D>;
  static constexpr size_t t0 = 0, t1 = L::tile, t2 = 2 * L::tile,
                          t3 = 3 * L::tile;
  static constexpr size_t s0 = 4 * L::tile;
  static constexpr size_t s1 = s0 + L::scores;
  static constexpr size_t w_off = s1 + L::scores;
  static constexpr size_t lse_off = w_off + L::weights;
  static constexpr size_t delta_off = lse_off + L::rows;
  static constexpr size_t bytes = delta_off + L::rows;
  // the f32 [64, D] staging of the results reuses two adjacent tiles
  static_assert(L::out <= 2 * L::tile, "staging fits two tiles");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq,
                    float* __restrict__ delta, Layout lay, int H, int Hkv,
                    int S, float scale, float scale_log2, int causal) {
  using L = Tiles<T, D>;
  using M = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + M::t0);
  T* dOs = reinterpret_cast<T*>(smem + M::t1);
  T* Ks = reinterpret_cast<T*>(smem + M::t2);
  T* Vs = reinterpret_cast<T*>(smem + M::t3);
  float* Ss = reinterpret_cast<float*>(smem + M::s0);
  float* dPs = reinterpret_cast<float*>(smem + M::s1);
  T* DSs = reinterpret_cast<T*>(smem + M::w_off);
  float* lse2_s = reinterpret_cast<float*>(smem + M::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + M::delta_off);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const long long qoff = b * lay.qb + h * lay.qh;
  const T* kg = k + b * lay.kb + hk * lay.kh;
  const T* vg = v + b * lay.kb + hk * lay.kh;

  load_rows<T, D, L::LDT>(Qs, q + qoff, lay.qs, q0, S);
  load_rows<T, D, L::LDT>(dOs, dout + qoff, lay.qs, q0, S);
  __syncthreads();
  // delta = rowsum(dO * O), once per row, exported for K7; lse in
  // base 2 (a fully masked row's -inf becomes a finite stand-in: its
  // weights are masked to 0 anyway)
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < S)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f32(dOs[r * L::LDT + d]),
                   to_f32(o[qoff + row * lay.qs + d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
      delta_s[r] = acc;
      lse2_s[r] = isfinite(l) ? l * kLog2e : 0.0f;
      if (row < S) delta[(size_t)bh * S + row] = acc;
    }
  }
  __syncwarp();

  WarpAcc<T, D> acc;
  acc.zero();
  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // previous K/V tiles fully consumed
    load_rows<T, D, L::LDT>(Ks, kg, lay.ks, kv0, S);
    load_rows<T, D, L::LDT>(Vs, vg, lay.ks, kv0, S);
    __syncthreads();
    warp_scores<T, D>(Qs + r0 * L::LDT, Ks, Ss + r0 * L::LDS);     // Q K^T
    warp_scores<T, D>(dOs + r0 * L::LDT, Vs, dPs + r0 * L::LDS);   // dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = kv0 + c;
        bool ok = row < S && col < S && (!causal || col <= row);
        float p = ok ? exp2f(Ss[r * L::LDS + c] * scale_log2 - lse2_s[r])
                     : 0.0f;
        DSs[r * L::LDP + c] =
            from_f32<T>(p * (dPs[r * L::LDS + c] - delta_s[r]));
      }
    }
    __syncwarp();
    acc.mma(DSs + r0 * L::LDP, Ks);  // dQ += dS K
  }
  __syncthreads();  // every warp is done with the K/V tiles
  float* Cs = reinterpret_cast<float*>(smem + M::t2);  // over K/V tiles
  acc.store(Cs + r0 * L::LDO);
  __syncwarp();
  write_rows<T, D>(dq + qoff, lay.qs, Cs + r0 * L::LDO, q0 + r0, S, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout lay, int H, int Hkv, int S,
                     float scale, float scale_log2, int causal) {
  using L = Tiles<T, D>;
  using M = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + M::t0);
  T* Vs = reinterpret_cast<T*>(smem + M::t1);
  T* Qs = reinterpret_cast<T*>(smem + M::t2);
  T* dOs = reinterpret_cast<T*>(smem + M::t3);
  float* St = reinterpret_cast<float*>(smem + M::s0);   // s^T, then p^T
  float* dPt = reinterpret_cast<float*>(smem + M::s1);  // dp^T
  T* Wt = reinterpret_cast<T*>(smem + M::w_off);        // p^T, then ds^T
  float* lse2_s = reinterpret_cast<float*>(smem + M::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + M::delta_off);

  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int group = H / Hkv;
  const int kv0 = blockIdx.x * kTile;  // under causality the first tiles
                                       // see the most query rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 KV rows in the tile
  const long long koff = b * lay.kb + hk * lay.kh;

  load_rows<T, D, L::LDT>(Ks, k + koff, lay.ks, kv0, S);
  load_rows<T, D, L::LDT>(Vs, v + koff, lay.ks, kv0, S);
  WarpAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  for (int g = 0; g < group; ++g) {  // the query heads of this KV head
    const int h = hk * group + g, bh = b * H + h;
    const long long qoff = b * lay.qb + h * lay.qh;
    for (int q0 = causal ? kv0 : 0; q0 < S; q0 += kTile) {
      __syncthreads();  // previous Q/dO tiles and row vectors consumed
      load_rows<T, D, L::LDT>(Qs, q + qoff, lay.qs, q0, S);
      load_rows<T, D, L::LDT>(dOs, dout + qoff, lay.qs, q0, S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
        lse2_s[threadIdx.x] = isfinite(l) ? l * kLog2e : 0.0f;
        delta_s[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.0f;
      }
      __syncthreads();
      warp_scores<T, D>(Ks + r0 * L::LDT, Qs, St + r0 * L::LDS);  // K Q^T
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int kv = kv0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j, qrow = q0 + c;
          bool ok = kv < S && qrow < S && (!causal || qrow >= kv);
          float p = ok ? exp2f(St[r * L::LDS + c] * scale_log2 - lse2_s[c])
                       : 0.0f;
          St[r * L::LDS + c] = p;
          Wt[r * L::LDP + c] = from_f32<T>(p);
        }
      }
      __syncwarp();
      dv_acc.mma(Wt + r0 * L::LDP, dOs);                             // p^T dO
      warp_scores<T, D>(Vs + r0 * L::LDT, dOs, dPt + r0 * L::LDS);  // V dO^T
      __syncwarp();  // the warp's p^T rows are read; ds^T goes over them
      for (int r = r0; r < r0 + 16; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          Wt[r * L::LDP + c] = from_f32<T>(
              St[r * L::LDS + c] * (dPt[r * L::LDS + c] - delta_s[c]));
        }
      }
      __syncwarp();
      dk_acc.mma(Wt + r0 * L::LDP, Qs);  // dK += ds^T Q
    }
  }
  __syncthreads();  // every warp is done with the Q/dO tiles
  float* Cs = reinterpret_cast<float*>(smem + M::t2);  // over Q/dO tiles
  dk_acc.store(Cs + r0 * L::LDO);
  __syncwarp();
  write_rows<T, D>(dk + koff, lay.ks, Cs + r0 * L::LDO, kv0 + r0, S, scale);
  __syncwarp();
  dv_acc.store(Cs + r0 * L::LDO);
  __syncwarp();
  write_rows<T, D>(dv + koff, lay.ks, Cs + r0 * L::LDO, kv0 + r0, S, 1.0f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, float* delta, int B, int H, int Hkv, int S,
              float scale, int causal, int layout, cudaStream_t s) {
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta,
      make_layout(layout, H, Hkv, S, D), H, Hkv, S, scale, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Hkv, int S, float scale, int causal,
               int layout, cudaStream_t s) {
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * Hkv);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv),
      make_layout(layout, H, Hkv, S, D), H, Hkv, S, scale, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace taper

using namespace taper;
using namespace taper::flash;

// K6.  lse, delta: [B*H, S] f32.
extern "C" int taper_flash_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq,
                              void* delta, int B, int H, int Hkv, int S,
                              int D, float scale, int causal, int layout,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto de = static_cast<float*>(delta);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    if (D == 64)
      return launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, l, dq, de, B,
                                          H, Hkv, S, scale, causal, layout,
                                          s);
    if (D == 128)
      return launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, l, dq, de,
                                           B, H, Hkv, S, scale, causal,
                                           layout, s);
  } else if (dtype == kFloat32) {
    if (D == 64)
      return launch_dq<float, 64>(q, k, v, o, dout, l, dq, de, B, H, Hkv,
                                  S, scale, causal, layout, s);
    if (D == 128)
      return launch_dq<float, 128>(q, k, v, o, dout, l, dq, de, B, H,
                                   Hkv, S, scale, causal, layout, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K7, after K6 on the same stream (it reads K6's delta).
extern "C" int taper_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int Hkv, int S, int D, float scale,
                               int causal, int layout, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto de = static_cast<const float*>(delta);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    if (D == 64)
      return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, de, dk, dv, B,
                                           H, Hkv, S, scale, causal, layout,
                                           s);
    if (D == 128)
      return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, de, dk, dv, B,
                                            H, Hkv, S, scale, causal, layout,
                                            s);
  } else if (dtype == kFloat32) {
    if (D == 64)
      return launch_dkv<float, 64>(q, k, v, dout, l, de, dk, dv, B, H, Hkv,
                                   S, scale, causal, layout, s);
    if (D == 128)
      return launch_dkv<float, 128>(q, k, v, dout, l, de, dk, dv, B, H, Hkv,
                                    S, scale, causal, layout, s);
  }
  return (int)cudaErrorInvalidValue;
}
