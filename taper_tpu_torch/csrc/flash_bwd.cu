// Flash attention backward: dQ, dK and dV from q, k, v, the forward's
// output o and row logsumexp lse, and the output's cotangent do, under a
// causal mask, a sliding window and segment ids (flash_common.cuh, Mask).
// This file holds the C entry points of the four backward kernels and the
// kernels that bf16 no longer runs on Hopper's wgmma: every f32 launch (the
// sort task) and K11.  bf16 K6 runs flash_bwd_sm90.cu's kernel, bf16 K7 and
// K10's bf16 sweep flash_sm90.cu's (ops/attention.py's plan_bwd names the
// route).
//
// Replaces the four backward TPU kernels of
// taper_tpu/ops/pallas/attention.py, launched by _flash_bwd_impl:
//   * flash_dq_kernel (K6 in f32, _dq_kernel): one block per (batch *
//     head, 64-row query tile) loops over the band of KV tiles the mask
//     leaves.  It first computes delta = rowsum(dO * O) for its rows and
//     exports it (as _dq_kernel does; JAX also subtracts an lse cotangent
//     there, which only its flash_attention_lse has), then per KV tile p =
//     exp(s - lse), ds = p * (dO V^T - delta), dQ += ds K; the scale is
//     applied once at the end.
//   * flash_dkv_kernel<.., false> (K7 in f32, _dkv_kernel): one block per
//     (batch * KV head, 64-row KV tile) loops over the band of query tiles
//     and over the query heads of its GQA group in a fixed order.  It works
//     on transposed tiles, s^T = K Q^T, so that every product is a plain
//     one: dV += p^T dO, dK += ds^T Q, and dK is scaled once at the end.
//     The group's query heads sum into the same f32 accumulators before the
//     one cast: no partials at query-head width, no atomics, and the result
//     is the same bits on every run (JAX sums per-head partials after its
//     kernel).
//   * flash_dkv_kernel<.., true> (K11, _dkv_kernel_t, opt-in under
//     TAPER_ATTN_DKV_T=1 for non-causal or windowed masks without segment
//     ids), in bf16 and f32: the same transposed tile pair, but one block
//     per (batch * QUERY head, KV tile), which writes the head's dK and dV
//     as f32 partials [B, H, S, D]; the caller sums them over each group
//     (JAX's kernel emits at query-head width too).  At GQA group G it puts
//     G times the blocks on the card for a partial buffer and a reduction;
//     at G = 1 it does K7's work.
//   * flash_fused_kernel (K10 in f32, _bwd_fused_kernel, opt-in under
//     TAPER_ATTN_FUSED_BWD=1 for plain causal attention): one sweep of the
//     band computes s, p and dp once per tile pair (5 products where K6 +
//     K7 do 7) and feeds all three gradients.  JAX keeps the whole (S, D)
//     f32 dQ in VMEM; at the 170M shape that is 1 MiB a head, far beyond
//     an SM's 228 KB, so dK and dV stay in registers as in K7 and each
//     pair's ds K is added into a zeroed f32 dQ buffer with atomics, after
//     a delta pre-pass (flash_delta_kernel, every dtype) and before an
//     epilogue that scales and casts dQ: three launches.  The atomics make
//     dQ's low bits depend on the order of the adds.
// All read the forward's strides (Layout), so the projections' [B, S, H*D]
// layout needs no copy in either direction.
//
// What bounds them on the H100: at the f32 sort task's shape (B 64, H 2,
// S 128, D 64) the FMA work, 6 S^2 D (dQ) and 8 S^2 D (dK/dV) a head,
// halved by causality, at 67 TFLOP/s; K11 in bf16 (windowed): tensor-core
// work over the band's S W pairs.  What the design here does about that:
//   * FMA loops in which a lane owns columns for f32, 16 x 16 WMMA tiles
//     out of shared memory for K11 in bf16;
//   * dQ (K6) and dK/dV (K7, K10, K11) stay in registers for the whole
//     sweep; the scores and the weights go through shared memory, where
//     their elementwise step reads them row by row;
//   * tiles outside the band (the far side of the diagonal, behind the
//     window) are skipped, the longest query rows of K6 are scheduled
//     first (K7's first KV tiles are its longest), ragged S is masked in
//     the kernel; masked pairs (another document) have p = 0 and add
//     nothing to dS, and a tile pair whose segment-id ranges cannot meet
//     is skipped whole.
#include "flash_common.cuh"

#include <algorithm>
#include <type_traits>

namespace taper {
namespace flash {

// Shared memory of the backward kernels: four [64, D] tiles, two f32 score
// tiles, one weight tile, two row vectors and the segment ids of the
// tile's rows and columns.
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
  static constexpr size_t sa_off = delta_off + L::rows;
  static constexpr size_t sb_off = sa_off + L::rows;
  static constexpr size_t bytes = sb_off + L::rows;
  // the f32 [64, D] staging of the results reuses two adjacent tiles, and
  // K10's staging of dQ's share the two score tiles
  static_assert(L::out <= 2 * L::tile, "staging fits two tiles");
  static_assert(L::out <= 2 * L::scores, "staging fits the score tiles");
};

template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta,
                    Layout lay, int causal, int window,
                    const int* __restrict__ seg, int H, int Hkv, int S,
                    float scale, float scale_log2) {
  const Mask mask{causal, window, seg};  // see Mask
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
  int* sq_s = reinterpret_cast<int*>(smem + M::sa_off);
  int* sk_s = reinterpret_cast<int*>(smem + M::sb_off);

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
  if (has_ids<MASKED>(mask)) load_ids(sq_s, mask, b, q0, S);
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
  const int kv_hi = kv_end(mask, q0, S);
  for (int kv0 = kv_begin<MASKED>(mask, q0); kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();  // previous K/V tiles fully consumed
    load_rows<T, D, L::LDT>(Ks, kg, lay.ks, kv0, S);
    load_rows<T, D, L::LDT>(Vs, vg, lay.ks, kv0, S);
    if (has_ids<MASKED>(mask)) load_ids(sk_s, mask, b, kv0, S);
    __syncthreads();
    if (has_ids<MASKED>(mask) && !ids_meet(sq_s, sk_s))
      continue;  // no shared document
    warp_scores<T, D>(Qs + r0 * L::LDT, Ks, Ss + r0 * L::LDS);     // Q K^T
    warp_scores<T, D>(dOs + r0 * L::LDT, Vs, dPs + r0 * L::LDS);   // dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = kv0 + c;
        // a masked pair (the far side of the diagonal or of the window,
        // another document) has p = 0, so it adds nothing to dS
        bool ok = row < S && col < S && keep<MASKED>(mask, row, col) &&
                  (!has_ids<MASKED>(mask) || sq_s[r] == sk_s[c]);
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

// One (KV tile, query tile) pair of the transposed backward, shared by
// K7, K11 and K10: s^T = K Q^T, p^T, dV += p^T dO, dp^T = V dO^T,
// ds^T = p^T (dp^T - delta), dK += ds^T Q.  Loads the query tile of head
// `bh` (its Q, dO, lse, delta and, with segments, ids); leaves ds^T in Wt
// for all 64 KV rows only after the caller's __syncthreads.  Returns
// false, having computed nothing, when the two tiles' segment ids cannot
// meet.
template <typename T, int D, bool MASKED>
__device__ __forceinline__ bool dkv_pair(
    const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    unsigned char* smem, const Layout& lay, const Mask& mask, int b, int bh,
    long long qoff, int kv0, int q0, int S, float scale_log2,
    WarpAcc<T, D>& dk_acc, WarpAcc<T, D>& dv_acc) {
  using L = Tiles<T, D>;
  using M = BwdSmem<T, D>;
  T* Ks = reinterpret_cast<T*>(smem + M::t0);
  T* Vs = reinterpret_cast<T*>(smem + M::t1);
  T* Qs = reinterpret_cast<T*>(smem + M::t2);
  T* dOs = reinterpret_cast<T*>(smem + M::t3);
  float* St = reinterpret_cast<float*>(smem + M::s0);   // s^T, then p^T
  float* dPt = reinterpret_cast<float*>(smem + M::s1);  // dp^T
  T* Wt = reinterpret_cast<T*>(smem + M::w_off);        // p^T, then ds^T
  float* lse2_s = reinterpret_cast<float*>(smem + M::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + M::delta_off);
  int* sk_s = reinterpret_cast<int*>(smem + M::sa_off);  // the KV rows'
  int* sq_s = reinterpret_cast<int*>(smem + M::sb_off);  // the q columns'
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 KV rows in the tile

  __syncthreads();  // previous Q/dO tiles, row vectors and ids consumed
  load_rows<T, D, L::LDT>(Qs, q + qoff, lay.qs, q0, S);
  load_rows<T, D, L::LDT>(dOs, dout + qoff, lay.qs, q0, S);
  if (has_ids<MASKED>(mask)) load_ids(sq_s, mask, b, q0, S);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
    lse2_s[threadIdx.x] = isfinite(l) ? l * kLog2e : 0.0f;
    delta_s[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.0f;
  }
  __syncthreads();
  if (has_ids<MASKED>(mask) && !ids_meet(sk_s, sq_s))
    return false;  // no shared document
  warp_scores<T, D>(Ks + r0 * L::LDT, Qs, St + r0 * L::LDS);  // K Q^T
  __syncwarp();
  for (int r = r0; r < r0 + 16; ++r) {
    const int kv = kv0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, qrow = q0 + c;
      bool ok = kv < S && qrow < S && keep<MASKED>(mask, qrow, kv) &&
                (!has_ids<MASKED>(mask) || sk_s[r] == sq_s[c]);
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
  return true;
}

// K7 (PER_HEAD false): one block per (batch * KV head, KV tile), the GQA
// group summed in registers, dK/dV written in the input dtype and layout.
// K11 (PER_HEAD true): one block per (batch * query head, KV tile), the
// head's dK/dV written as f32 partials [B, H, S, D], which the caller sums
// over each group.
template <typename T, int D, bool PER_HEAD, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     std::conditional_t<PER_HEAD, float, T>* __restrict__ dk,
                     std::conditional_t<PER_HEAD, float, T>* __restrict__ dv,
                     Layout lay, int causal, int window,
                     const int* __restrict__ seg, int H, int Hkv, int S,
                     float scale, float scale_log2) {
  const Mask mask{causal, window, seg};
  using L = Tiles<T, D>;
  using M = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + M::t0);
  T* Vs = reinterpret_cast<T*>(smem + M::t1);

  const int group = H / Hkv;
  int b, hk, g0, g1;
  if constexpr (PER_HEAD) {
    b = blockIdx.y / H;
    const int h = blockIdx.y % H;
    hk = h / group;
    g0 = h % group;
    g1 = g0 + 1;
  } else {
    b = blockIdx.y / Hkv;
    hk = blockIdx.y % Hkv;
    g0 = 0;
    g1 = group;
  }
  const int kv0 = blockIdx.x * kTile;  // under causality the first tiles
                                       // see the most query rows
  const int warp = threadIdx.x / 32;
  const int r0 = warp * 16;
  const long long koff = b * lay.kb + hk * lay.kh;

  load_rows<T, D, L::LDT>(Ks, k + koff, lay.ks, kv0, S);
  load_rows<T, D, L::LDT>(Vs, v + koff, lay.ks, kv0, S);
  if (has_ids<MASKED>(mask))
    load_ids(reinterpret_cast<int*>(smem + M::sa_off), mask, b, kv0, S);
  WarpAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  const int q_lo = q_begin(mask, kv0), q_hi = q_end<MASKED>(mask, kv0, S);
  for (int g = g0; g < g1; ++g) {  // the query heads of this KV head
    const int h = hk * group + g, bh = b * H + h;
    const long long qoff = b * lay.qb + h * lay.qh;
    for (int q0 = q_lo; q0 < q_hi; q0 += kTile)
      dkv_pair<T, D, MASKED>(q, dout, lse, delta, smem, lay, mask, b, bh,
                             qoff, kv0, q0, S, scale_log2, dk_acc, dv_acc);
  }
  __syncthreads();  // every warp is done with the Q/dO tiles
  float* Cs = reinterpret_cast<float*>(smem + M::t2);  // over Q/dO tiles
  using OutT = std::conditional_t<PER_HEAD, float, T>;
  OutT *dkg, *dvg;
  long long ld;
  if constexpr (PER_HEAD) {
    dkg = dk + (size_t)blockIdx.y * S * D;
    dvg = dv + (size_t)blockIdx.y * S * D;
    ld = D;
  } else {
    dkg = dk + koff;
    dvg = dv + koff;
    ld = lay.ks;
  }
  dk_acc.store(Cs + r0 * L::LDO);
  __syncwarp();
  write_rows<OutT, D>(dkg, ld, Cs + r0 * L::LDO, kv0 + r0, S, scale);
  __syncwarp();
  dv_acc.store(Cs + r0 * L::LDO);
  __syncwarp();
  write_rows<OutT, D>(dvg, ld, Cs + r0 * L::LDO, kv0 + r0, S, 1.0f);
}

// K10's pre-pass: delta = rowsum(dO * O), one warp a row, in the order of
// K6's (row_delta: the two give the same bits).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, Layout lay, int H, int S,
                       int rows) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= rows) return;  // whole warps leave together
  const int bh = w / S, row = w % S, b = bh / H, h = bh % H;
  const long long off = b * lay.qb + h * lay.qh + row * lay.qs;
  const float acc = row_delta<T, D>(dout + off, o + off);
  if (lane == 0) delta[w] = acc;
}

// K10: the fused sweep.  One block per (batch * KV head, KV tile), as K7,
// computes s, p and dp once per tile pair and feeds all three gradients:
// dK and dV accumulate in registers; dQ's share of the pair, ds K, is
// formed from the ds^T tile in shared memory, staged over the score
// tiles, and added into the zeroed f32 buffer dq_acc [B, H, S, D] with
// atomics (red.global.add.f32): the blocks of one query tile run on other
// SMs, so nothing else can sum them without a second sweep.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    flash_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc, T* __restrict__ dk,
                       T* __restrict__ dv, Layout lay, int causal,
                       int window, const int* __restrict__ seg, int H,
                       int Hkv, int S, float scale, float scale_log2) {
  const Mask mask{causal, window, seg};
  using L = Tiles<T, D>;
  using M = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + M::t0);
  T* Vs = reinterpret_cast<T*>(smem + M::t1);
  T* Wt = reinterpret_cast<T*>(smem + M::w_off);
  float* Cq = reinterpret_cast<float*>(smem + M::s0);  // over the scores

  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int kv0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // KV rows in the pair, query rows for dQ
  const long long koff = b * lay.kb + hk * lay.kh;

  load_rows<T, D, L::LDT>(Ks, k + koff, lay.ks, kv0, S);
  load_rows<T, D, L::LDT>(Vs, v + koff, lay.ks, kv0, S);
  if (has_ids<MASKED>(mask))
    load_ids(reinterpret_cast<int*>(smem + M::sa_off), mask, b, kv0, S);
  WarpAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  const int q_lo = q_begin(mask, kv0), q_hi = q_end<MASKED>(mask, kv0, S);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g, bh = b * H + h;
    const long long qoff = b * lay.qb + h * lay.qh;
    for (int q0 = q_lo; q0 < q_hi; q0 += kTile) {
      if (!dkv_pair<T, D, MASKED>(q, dout, lse, delta, smem, lay, mask, b,
                                  bh, qoff, kv0, q0, S, scale_log2, dk_acc,
                                  dv_acc))
        continue;       // no shared document: no share of dQ either
      __syncthreads();  // ds^T complete for all 64 KV rows; scores read
      // dQ[q0 + r0 .. +16] += ds K: the warp's query rows are ds^T's
      // columns [r0, r0 + 16)
      warp_mma_t<T, D>(Wt + r0, Ks, Cq + r0 * L::LDO);
      __syncwarp();
      float* dst = dq_acc + ((size_t)bh * S + q0 + r0) * D;
      for (int e = lane; e < 16 * D; e += 32) {
        const int r = e / D, d = e % D;
        if (q0 + r0 + r < S) atomicAdd(dst + e, Cq[(r0 + r) * L::LDO + d]);
      }
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

// K10's epilogue: dq = dq_acc * scale in q's dtype and layout.
template <typename T, int D>
__global__ void flash_dq_epilogue_kernel(const float* __restrict__ dq_acc,
                                         T* __restrict__ dq, Layout lay,
                                         int H, int S, float scale,
                                         long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long rest = i / D;
    const int d = (int)(i % D), row = (int)(rest % S);
    const int bh = (int)(rest / S), b = bh / H, h = bh % H;
    dq[b * lay.qb + h * lay.qh + row * lay.qs + d] =
        from_f32<T>(dq_acc[i] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, bool MASKED>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, float* delta,
              int B, int H, int Hkv, int S, float scale, Mask mask,
              int layout, cudaStream_t s) {
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_dq_kernel<T, D, MASKED>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta,
      make_layout(layout, H, Hkv, S, D), mask.causal, mask.window, mask.seg,
      H, Hkv, S, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool PER_HEAD, bool MASKED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Hkv, int S, float scale, Mask mask,
               int layout, cudaStream_t s) {
  using OutT = std::conditional_t<PER_HEAD, float, T>;
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_dkv_kernel<T, D, PER_HEAD, MASKED>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * (PER_HEAD ? H : Hkv));
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<OutT*>(dk), static_cast<OutT*>(dv),
      make_layout(layout, H, Hkv, S, D), mask.causal, mask.window, mask.seg,
      H, Hkv, S, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B,
                 int H, int Hkv, int S, int layout, cudaStream_t s) {
  const int rows = B * H * S;
  flash_delta_kernel<T, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta,
      make_layout(layout, H, Hkv, S, D), H, S, rows);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool MASKED>
int launch_fused(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta,
                 float* dq_acc, void* dq, void* dk, void* dv, int B, int H,
                 int Hkv, int S, float scale, Mask mask, int layout,
                 cudaStream_t s) {
  const Layout lay = make_layout(layout, H, Hkv, S, D);
  const int rows = B * H * S;
  const int code = launch_delta<T, D>(o, dout, delta, B, H, Hkv, S, layout,
                                      s);
  if (code != 0) return code;
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  auto kernel = flash_fused_kernel<T, D, MASKED>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * Hkv);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), lay, mask.causal,
      mask.window, mask.seg, H, Hkv, S, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * D;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  flash_dq_epilogue_kernel<T, D><<<blocks, 256, 0, s>>>(
      dq_acc, static_cast<T*>(dq), lay, H, S, scale, n);
  return (int)cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// Dispatch over head dim and the mask's instantiation (see Mask) for one
// element type T: f(Tag<T>, integral_constant<D>, bool_constant<MASKED>)
// is a generic lambda that launches one instantiation.
template <typename T, typename F>
int dispatch_dim(int D, const Mask& m, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  auto by_mask = [&](auto d) {
    return masked(m) ? f(Tag<T>{}, d, std::true_type{})
                     : f(Tag<T>{}, d, std::false_type{});
  };
  if (D == 64) return by_mask(D64{});
  if (D == 128) return by_mask(D128{});
  return (int)cudaErrorInvalidValue;
}

// The same over dtype too.
template <typename F>
int dispatch(int dtype, int D, const Mask& m, F&& f) {
  if (dtype == kBFloat16) return dispatch_dim<__nv_bfloat16>(D, m, f);
  if (dtype == kFloat32) return dispatch_dim<float>(D, m, f);
  return (int)cudaErrorInvalidValue;
}

inline bool bad_dims(int B, int H, int Hkv, int S) {
  return B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0;
}

}  // namespace flash
}  // namespace taper

using namespace taper;
using namespace taper::flash;

namespace taper {
namespace flash {
// csrc/flash_bwd_sm90.cu: K6 on TMA and wgmma (bf16)
int flash_dq_sm90(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, void* dq, float* delta,
                  const Mask& m, int B, int H, int Hkv, int S, int D,
                  float scale, int layout, cudaStream_t stream);
// csrc/flash_sm90.cu: K7 and K10's sweep on TMA and wgmma (bf16)
int flash_dkv_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const Mask& m, int B, int H, int Hkv,
                   int S, int D, float scale, int layout,
                   cudaStream_t stream);
int flash_fused_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dq_acc, void* dq, void* dk, void* dv,
                     const Mask& m, int B, int H, int Hkv, int S, int D,
                     float scale, int layout, cudaStream_t stream);
}  // namespace flash
}  // namespace taper

// K6: bf16 runs the wgmma kernel of flash_bwd_sm90.cu, f32 the FMA kernel
// here.  lse, delta: [B*H, S] f32; seg: [B, S] int32 or null; window: > 0
// keeps cols > row - window.
extern "C" int taper_flash_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* delta,
                              const void* seg, int B, int H, int Hkv, int S,
                              int D, float scale, int causal, int window,
                              int layout, int dtype, void* stream) {
  if (bad_dims(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  const Mask m{causal, window, static_cast<const int*>(seg)};
  if (dtype == kBFloat16)
    return flash_dq_sm90(q, k, v, o, dout, static_cast<const float*>(lse),
                         dq, static_cast<float*>(delta), m, B, H, Hkv, S, D,
                         scale, layout, static_cast<cudaStream_t>(stream));
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  return dispatch_dim<float>(D, m, [&](auto t, auto d, auto mk) {
    return launch_dq<typename decltype(t)::type, decltype(d)::value,
                     decltype(mk)::value>(
        q, k, v, o, dout, static_cast<const float*>(lse), dq,
        static_cast<float*>(delta), B, H, Hkv, S, scale, m, layout,
        static_cast<cudaStream_t>(stream));
  });
}

// K7, after K6 on the same stream (it reads K6's delta): bf16 runs the
// wgmma kernel of flash_sm90.cu, f32 the FMA kernel here.
extern "C" int taper_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               const void* seg, int B, int H, int Hkv, int S,
                               int D, float scale, int causal, int window,
                               int layout, int dtype, void* stream) {
  if (bad_dims(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  const Mask m{causal, window, static_cast<const int*>(seg)};
  if (dtype == kBFloat16)
    return flash_dkv_sm90(q, k, v, dout, static_cast<const float*>(lse),
                          static_cast<const float*>(delta), dk, dv, m, B, H,
                          Hkv, S, D, scale, layout,
                          static_cast<cudaStream_t>(stream));
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  return dispatch_dim<float>(D, m, [&](auto t, auto d, auto mk) {
    return launch_dkv<typename decltype(t)::type, decltype(d)::value, false,
                      decltype(mk)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dk, dv, B, H, Hkv, S, scale, m,
        layout, static_cast<cudaStream_t>(stream));
  });
}

// K11, after K6 (its delta): dK/dV per query head as f32 partials
// dk_part, dv_part [B, H, S, D] (dK's scaled), no segment ids.
extern "C" int taper_flash_dkv_t(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk_part,
                                 void* dv_part, int B, int H, int Hkv, int S,
                                 int D, float scale, int causal, int window,
                                 int layout, int dtype, void* stream) {
  if (bad_dims(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  const Mask m{causal, window, nullptr};
  return dispatch(dtype, D, m, [&](auto t, auto d, auto mk) {
    return launch_dkv<typename decltype(t)::type, decltype(d)::value, true,
                      decltype(mk)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dk_part, dv_part, B, H, Hkv, S,
        scale, m, layout, static_cast<cudaStream_t>(stream));
  });
}

// K10: the delta pre-pass, the fused sweep and the dQ epilogue, three
// launches in order; bf16 runs the wgmma sweep of flash_sm90.cu, f32 the
// FMA kernel here.  dq_acc: B*H*ceil(S/64)*64*D f32, zeroed by the caller
// (f32 uses its first B*H*S*D as [B, H, S, D]); delta: [B*H, S] f32,
// written.
extern "C" int taper_flash_bwd_fused(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, const void* seg, int B, int H, int Hkv, int S, int D,
    float scale, int causal, int window, int layout, int dtype,
    void* stream) {
  if (bad_dims(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
  const Mask m{causal, window, static_cast<const int*>(seg)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    const int err =
        D == 64    ? launch_delta<T, 64>(o, dout, static_cast<float*>(delta),
                                         B, H, Hkv, S, layout, s)
        : D == 128 ? launch_delta<T, 128>(o, dout, static_cast<float*>(delta),
                                          B, H, Hkv, S, layout, s)
                   : (int)cudaErrorInvalidValue;
    if (err != 0) return err;
    return flash_fused_sm90(q, k, v, dout, static_cast<const float*>(lse),
                            static_cast<const float*>(delta),
                            static_cast<float*>(dq_acc), dq, dk, dv, m, B, H,
                            Hkv, S, D, scale, layout, s);
  }
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  return dispatch_dim<float>(D, m, [&](auto t, auto d, auto mk) {
    return launch_fused<typename decltype(t)::type, decltype(d)::value,
                        decltype(mk)::value>(
        q, k, v, o, dout, static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq_acc), dq, dk, dv,
        B, H, Hkv, S, scale, m, layout, s);
  });
}
