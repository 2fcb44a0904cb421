// Flash attention forward: o = softmax(scale * q k^T [+ causal mask]) v,
// and the row logsumexp lse (natural log, f32) that the backward reads.
//
// Replaces two TPU kernels of taper_tpu/ops/pallas/attention.py, both
// launched by _flash_fwd:
//   * _fwd_kernel (K5), the exact online softmax: f32 and non-causal inputs
//     (flash_fwd_kernel<T, D, false>);
//   * _fwd_kernel_bound (K8), the bound-max arm that JAX selects for bf16
//     causal inputs (flash_fwd_kernel<bf16, D, true>).  Softmax is
//     shift-invariant, so any per-row shift b >= max(s) gives the exact
//     ratio; the Cauchy-Schwarz bound b = |q_row| * scale * log2(e) *
//     max|k| (max over the KV head's positions) is known before the first
//     KV tile, so the max-reduce, the exp2 of the correction and the
//     rescale of the running output all go.  The exact arm is chosen per
//     launch by a predicate that lies in device memory (pred[0] != 0: the
//     bound arm), computed by the caller from max|q| * max|k| <= 60 in
//     base 2, which keeps every row's largest weight above 2^-120 and so
//     inside f32; reading it in the kernel costs no host sync.  The row
//     sum is clamped at 1e-37, not 1e-30, for the same envelope, as
//     _fwd_kernel_bound does.  A launch that takes the bound arm adds one
//     to bound_count (when given), so a run can read back how often it did.
// Layouts: [B, H, S, D] for q and o with [B, Hkv, S, D] for k and v, or the
// projections' [B, S, H*D] with [B, S, Hkv*D]; the kernel is given element
// strides, so neither layout is copied.  GQA is read natively (query head h
// uses KV head h / (H / Hkv)); K/V are never repeated in device memory.
//
// What bounds it on the H100: the two products are tensor-core work
// (4 S^2 D per head, halved by causality); the softmax between them runs
// on the CUDA cores and device memory traffic is O(S * D) per head.  At the
// training shape (B 8, H 8, S 2048, D 128, bf16) the products set the
// bound: 6.9e10 FLOP, ~69 us at 989 TFLOP/s.
// What the simple design does about that:
//   * one block per (batch * head, 64-row query tile), four warps of 16
//     query rows each, the longest causal rows scheduled first; the loop
//     over 64-row KV tiles runs inside the block, so nothing carries
//     between blocks (the TPU grid's sequential KV axis becomes this loop);
//   * bf16: both products use WMMA 16x16x16 tensor-core tiles out of
//     shared memory; f32: the same schedule with FMA loops;
//   * online softmax in f32 (base 2, log2(e) folded into the scale), the
//     running output kept in shared memory in f32 and rescaled row by row
//     (exact arm only);
//   * causal tiles above the diagonal are skipped; ragged S is masked, the
//     TPU's S % 128 rule does not apply; fully masked rows are guarded
//     with a finite stand-in for the running max and get lse = -inf, as
//     the TPU kernel does.
// mma.sync/wgmma register-resident accumulators, TMA and a pipelined KV
// loop are later work.
#include "flash_common.cuh"

namespace taper {
namespace flash {

template <typename T, int D>
struct FwdSmem {
  using L = Tiles<T, D>;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + L::tile;
  static constexpr size_t v_off = k_off + L::tile;
  static constexpr size_t s_off = v_off + L::tile;
  static constexpr size_t p_off = s_off + L::scores;
  static constexpr size_t o_off = p_off + L::weights;
  static constexpr size_t m_off = o_off + L::out;
  static constexpr size_t l_off = m_off + L::rows;
  static constexpr size_t c_off = l_off + L::rows;
  static constexpr size_t bytes = c_off + L::rows;
};

template <typename T, int D, bool BOUND>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ kn,
                     const int* __restrict__ pred, int* bound_count,
                     Layout lay, int H, int Hkv, int S, float scale_log2,
                     int causal) {
  using L = Tiles<T, D>;
  using M = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + M::q_off);
  T* Ks = reinterpret_cast<T*>(smem + M::k_off);
  T* Vs = reinterpret_cast<T*>(smem + M::v_off);
  float* Ss = reinterpret_cast<float*>(smem + M::s_off);
  T* Ps = reinterpret_cast<T*>(smem + M::p_off);
  float* Os = reinterpret_cast<float*>(smem + M::o_off);
  float* m_s = reinterpret_cast<float*>(smem + M::m_off);
  float* l_s = reinterpret_cast<float*>(smem + M::l_off);
  float* c_s = reinterpret_cast<float*>(smem + M::c_off);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 query rows in the tile
  const T* qg = q + b * lay.qb + h * lay.qh;
  const T* kg = k + b * lay.kb + hk * lay.kh;
  const T* vg = v + b * lay.kb + hk * lay.kh;
  // uniform over the grid: every block takes the same arm
  bool fast = false;
  if constexpr (BOUND) fast = pred[0] != 0;

  load_rows<T, D, L::LDT>(Qs, qg, lay.qs, q0, S);
  for (int e = threadIdx.x; e < kTile * L::LDO; e += kThreads) Os[e] = 0.0f;
  __syncthreads();
  // row statistics, each warp for its own rows: the running max starts at
  // -inf (exact arm) or at the row's bound (bound arm)
  for (int r = r0; r < r0 + 16; ++r) {
    float m0 = -INFINITY;
    if (fast) {
      float ss = 0.0f;
      for (int d = lane; d < D; d += 32) {
        float x = to_f32(Qs[r * L::LDT + d]);
        ss = fmaf(x, x, ss);
      }
      m0 = sqrtf(warp_sum(ss)) * scale_log2 * kn[b * Hkv + hk];
    }
    if (lane == 0) {
      m_s[r] = m0;
      l_s[r] = 0.0f;
    }
  }

  const int kv_end = causal ? min(S, q0 + kTile) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and Q/O/m/l ready)
    load_rows<T, D, L::LDT>(Ks, kg, lay.ks, kv0, S);
    load_rows<T, D, L::LDT>(Vs, vg, lay.ks, kv0, S);
    __syncthreads();

    // ---- scores for this warp's rows: S = Q K^T (raw, unscaled) ----
    warp_scores<T, D>(Qs + r0 * L::LDT, Ks, Ss + r0 * L::LDS);
    __syncwarp();

    // ---- softmax weights of this warp's rows ----
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int col = kv0 + lane + 32 * j;
        bool ok = col < S && (!causal || col <= row);
        s[j] = ok ? Ss[r * L::LDS + lane + 32 * j] * scale_log2 : -INFINITY;
      }
      float p0, p1;
      if (fast) {
        // the shift is the row's bound: no max, no correction
        p0 = exp2f(s[0] - m_s[r]);
        p1 = exp2f(s[1] - m_s[r]);
        float psum = warp_sum(p0 + p1);
        if (lane == 0) l_s[r] += psum;
      } else {
        float m_prev = m_s[r];
        float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
        // fully masked so far: exp2 against 0 keeps p = corr = 0, not NaN
        float m_safe = m_new == -INFINITY ? 0.0f : m_new;
        p0 = exp2f(s[0] - m_safe);
        p1 = exp2f(s[1] - m_safe);
        float corr = exp2f(m_prev - m_safe);
        float psum = warp_sum(p0 + p1);
        if (lane == 0) {
          l_s[r] = l_s[r] * corr + psum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
      Ps[r * L::LDP + lane] = from_f32<T>(p0);
      Ps[r * L::LDP + lane + 32] = from_f32<T>(p1);
    }
    __syncwarp();

    // ---- rescale the running output (exact arm), then O += P V ----
    if (!fast) {
      for (int e = lane; e < 16 * D; e += 32) {
        int r = r0 + e / D, d = e % D;
        Os[r * L::LDO + d] *= c_s[r];
      }
      __syncwarp();
    }
    if constexpr (L::kTC) {
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + r0 * L::LDO + n * 16, L::LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kTile; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bv;
          wmma::load_matrix_sync(a, Ps + r0 * L::LDP + kk, L::LDP);
          wmma::load_matrix_sync(bv, Vs + kk * L::LDT + n * 16, L::LDT);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(Os + r0 * L::LDO + n * 16, acc, L::LDO,
                                wmma::mem_row_major);
      }
    } else {
      // lane owns output columns lane + 32 * j for all 16 rows
      for (int j = 0; j < D / 32; ++j) {
        const int d = lane + 32 * j;
        float acc[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[r] = Os[(r0 + r) * L::LDO + d];
        for (int c = 0; c < kTile; ++c) {
          float vv = to_f32(Vs[c * L::LDT + d]);
#pragma unroll
          for (int r = 0; r < 16; ++r)
            acc[r] = fmaf(to_f32(Ps[(r0 + r) * L::LDP + c]), vv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) Os[(r0 + r) * L::LDO + d] = acc[r];
      }
    }
    __syncwarp();
  }
  __syncthreads();

  T* og = o + b * lay.qb + h * lay.qh;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    int r = e / D, d = e % D;
    if (q0 + r < S) {
      float l = l_s[r];
      float val = l > 0.0f ? Os[r * L::LDO + d] / fmaxf(l, 1e-37f) : 0.0f;
      og[(q0 + r) * lay.qs + d] = from_f32<T>(val);
    }
  }
  // natural-log lse: m is the base-2 running max or the row bound, the
  // shift either way
  if (threadIdx.x < kTile && q0 + threadIdx.x < S) {
    float l = l_s[threadIdx.x];
    lse[(size_t)bh * S + q0 + threadIdx.x] =
        l > 0.0f ? m_s[threadIdx.x] * kLn2 + logf(fmaxf(l, 1e-37f))
                 : -INFINITY;
  }
  if (BOUND && fast && bound_count != nullptr && threadIdx.x == 0 &&
      blockIdx.x == 0 && blockIdx.y == 0)
    atomicAdd(bound_count, 1);
}

template <typename T, int D, bool BOUND>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const float* kn, const int* pred,
               int* bound_count, int B, int H, int Hkv, int S, float scale,
               int causal, int layout, cudaStream_t stream) {
  constexpr size_t bytes = FwdSmem<T, D>::bytes;
  auto kernel = flash_fwd_kernel<T, D, BOUND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kn, pred,
      bound_count, make_layout(layout, H, Hkv, S, D), H, Hkv, S,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace taper

using namespace taper;
using namespace taper::flash;

// The exact kernel (K5).  lse: [B*H, S] f32.
extern "C" int taper_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int Hkv,
                               int S, int D, float scale, int causal,
                               int layout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    if (D == 64)
      return launch_fwd<__nv_bfloat16, 64, false>(
          q, k, v, o, l, nullptr, nullptr, nullptr, B, H, Hkv, S, scale,
          causal, layout, s);
    if (D == 128)
      return launch_fwd<__nv_bfloat16, 128, false>(
          q, k, v, o, l, nullptr, nullptr, nullptr, B, H, Hkv, S, scale,
          causal, layout, s);
  } else if (dtype == kFloat32) {
    if (D == 64)
      return launch_fwd<float, 64, false>(q, k, v, o, l, nullptr, nullptr,
                                          nullptr, B, H, Hkv, S, scale,
                                          causal, layout, s);
    if (D == 128)
      return launch_fwd<float, 128, false>(q, k, v, o, l, nullptr, nullptr,
                                           nullptr, B, H, Hkv, S, scale,
                                           causal, layout, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bound-max kernel (K8): bf16, causal.  kn: [B*Hkv] f32, max |k| per
// KV head; pred: one int32, the arm; bound_count: one int32 or null.
extern "C" int taper_flash_fwd_bound(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* kn, const void* pred,
                                     void* bound_count, int B, int H,
                                     int Hkv, int S, int D, float scale,
                                     int layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  auto knp = static_cast<const float*>(kn);
  auto pp = static_cast<const int*>(pred);
  auto cp = static_cast<int*>(bound_count);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_fwd<__nv_bfloat16, 64, true>(q, k, v, o, l, knp, pp, cp, B,
                                               H, Hkv, S, scale, 1, layout, s);
  if (D == 128)
    return launch_fwd<__nv_bfloat16, 128, true>(q, k, v, o, l, knp, pp, cp,
                                                B, H, Hkv, S, scale, 1,
                                                layout, s);
  return (int)cudaErrorInvalidValue;
}
