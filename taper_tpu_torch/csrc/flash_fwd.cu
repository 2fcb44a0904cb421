// Flash attention forward: o = softmax(scale * q k^T [+ mask]) v, and the
// row logsumexp lse (natural log, f32) that the backward reads.
//
// Replaces _fwd_kernel (K5) of taper_tpu/ops/pallas/attention.py, the
// exact online softmax that _flash_fwd launches for f32 and non-causal
// inputs and for every input with a sliding window or segment ids.  One C
// entry point, taper_flash_fwd, picks the kernel by dtype: bf16 runs
// flash_sm90.cu's TMA + wgmma kernel (fwd_kernel<D, MASKED = true>, K8's
// design with the band, the masks and segment ids added); f32 runs
// flash_fwd_f32<D, RT, MASKED> below.  The bound-max arm that JAX
// selects for bf16 causal inputs (_fwd_kernel_bound, K8) is flash_sm90.cu's
// too.  Layouts: [B, H, S, D] for q and o with [B, Hkv, S, D] for k and v,
// or the projections' [B, S, H*D] with [B, S, Hkv*D]; the kernel is given
// element strides, so neither layout is copied.  GQA is read natively
// (query head h uses KV head h / (H / Hkv)); K/V are never repeated in
// device memory.
//
// What bounds the f32 kernel on the H100: both products run on the CUDA
// cores (the port keeps TF32 off by policy), 4 S^2 D FMA-issued flops per
// head (halved by causality, or S * W * 4 D with a window) against 67
// TFLOP/s, fed from shared memory; the softmax between them and device
// memory (O(S * D) per head) are smaller.  At the sort task's shape (B
// 64, H 2, S 128, D 64) the bytes bound it (16 MB) and the time is the
// latency of a short chain of tiles; at the windowed shape (B 1, H 4, S
// 1024) there are few query tiles to spread over 132 SMs.
// What the design does about that (flash_fwd_f32 below):
//   * register-tiled products: each of 128 threads owns 4 (or 2) query
//     rows, 4-8 score columns and 8-16 output columns; a k step of S = Q
//     K^T or O += P V is one 16-byte shared load of each operand for
//     16-64 FMAs, the tiles laid out so that a warp's loads broadcast or
//     hit distinct bank groups;
//   * O, the running max m and the sum l stay in registers across the
//     whole KV loop and are rescaled there; the row max and sum reduce
//     across the row's 8 lanes by shuffles; P passes through shared memory
//     once a tile, read back only by the lanes that wrote it;
//   * a two-stage cp.async ring of K/V tiles (64 rows at D 64, 32 at D
//     128, so that two blocks fit an SM) with the tile's segment ids, the
//     next tile's copy in flight during this tile's products;
//   * 64-row query tiles where they give every SM a block, 32-row ones
//     where they do not (the windowed shape: 128 blocks, not 64), the
//     longest causal rows first;
//   * the band of KV tiles the mask leaves (causal, window), per-entry
//     tests only on tiles the diagonal, the window's edge, the ragged end
//     or segment ids reach into; a KV tile whose id range cannot meet the
//     query tile's is skipped; a row whose first visited tiles are all
//     masked and a fully masked row are guarded with a finite stand-in for
//     the running max, and the latter gets lse = -inf, as the TPU kernel
//     does.
#include "flash_common.cuh"

namespace taper {
namespace flash {

// csrc/flash_sm90.cu: K5 in bf16 on TMA and wgmma
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Mask& m, int B, int H, int Hkv, int S,
                   int D, float scale, int layout, cudaStream_t stream);

// The f32 kernel's tiles: BQ = 16 * RT query rows a block, BKV keys a KV
// tile, 128 threads as 16 row groups (ty) by 8 column groups (tx).  A
// thread owns RT rows: RT x CT scores (columns tx + 8 j) and RT x DT of
// the output (16-byte chunks tx + 8 c of the row).  Each aligned group of
// 8 lanes shares its rows (the Q and P loads broadcast) and reads 8
// consecutive K rows at one d (rows of D + 4 floats, an odd number of
// 16-byte bank groups, so 8 distinct groups) or 8 consecutive chunks of
// a V row.  Shared memory: the Q tile, two stages of (K tile, V tile, the
// tile's segment ids), and P.
template <int D, int RT, int KVG>
struct FwdF32 {
  static constexpr int NT = kThreads * KVG;
  static constexpr int BQ = 16 * RT;
  static constexpr int BKV = D == 128 ? 32 : 64;
  static constexpr int CT = BKV / 8, DT = D / 8;
  static constexpr int LD = D + 4;      // a staged q, k or v row
  static constexpr int LDP = BKV + 4;   // a row of P
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_off + sizeof(float) * BQ * LD;
  static constexpr size_t stage = sizeof(float) * 2 * BKV * LD +
                                  sizeof(int) * BKV;
  static constexpr size_t p_off = kv_off + KVG * 2 * stage;
  static constexpr size_t p_size = sizeof(float) * BQ * LDP;
  static constexpr size_t bytes = p_off + KVG * p_size;
  // a group's row statistics and output for the merge, in its stages
  static_assert(sizeof(float) * RT * (DT + 2) * kThreads <= 2 * stage, "");
};

// K5 in f32.  Block (x, y): batch-head x, query tile y (reversed under a
// causal mask, so that the longest rows start first; a window without
// causality has its longest rows first already).  The loop runs over the
// band of KV tiles the mask leaves; the next tile's copy is in flight
// while this one's products run.  With KVG = 2 (where the query tiles are
// few) two groups of 128 threads take the band's tiles in turn, each with
// its own stages, P and running statistics, and group 0 merges group 1's
// at the end.  S = Q K^T and O += P V are register-
// tiled FMA loops; the running max m, the sum l (each lane its own
// columns' share, summed across the row's 8 lanes at the end) and O stay
// in registers for the whole loop; P goes through shared memory once a
// tile, read back only by the 8 lanes that wrote it.
template <int D, int RT, int KVG, bool MASKED>
__global__ void __launch_bounds__(kThreads * KVG)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, Layout lay, int causal, int window,
                  const int* __restrict__ seg, int H, int Hkv, int S,
                  float scale_log2) {
  using P = FwdF32<D, RT, KVG>;
  constexpr int BQ = P::BQ, BKV = P::BKV, CT = P::CT, DT = P::DT;
  constexpr int LD = P::LD, LDP = P::LDP;
  const Mask mask{causal, window, seg};  // see Mask
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int sq_s[BQ];
  // the thread's KV group and its place in the group
  const int gi = KVG == 1 ? 0 : threadIdx.x / kThreads;
  const int lt = KVG == 1 ? threadIdx.x : threadIdx.x % kThreads;
  float* Qs = reinterpret_cast<float*>(smem + P::q_off);
  float* Ps = reinterpret_cast<float*>(smem + P::p_off + gi * P::p_size);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tx = lt % 8, ty = lt / 8;
  const int r0 = ty * RT;  // the thread's first row in the tile
  const float* qg = q + b * lay.qb + h * lay.qh;
  const float* kg = k + b * lay.kb + hk * lay.kh;
  const float* vg = v + b * lay.kb + hk * lay.kh;

  // the band: from the window's lower edge (rounded down to a tile) to
  // the diagonal, or to S without causality
  const int lo = MASKED && window > 0 ? max(0, q0 - window + 1) / BKV * BKV
                                      : 0;
  const int hi = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (hi - lo + BKV - 1) / BKV;
  // the group's i-th tile goes to its stage i % 2
  auto kv_stage = [&](int i) {
    return reinterpret_cast<float*>(smem + P::kv_off +
                                    (2 * gi + (i & 1)) * P::stage);
  };
  auto load_kv = [&](int t, int i) {
    float* Ks = kv_stage(i);
    const int kv0 = lo + t * BKV;
    rows_async<BKV, D, LD, kThreads>(Ks, kg, lay.ks, kv0, S, lt);
    rows_async<BKV, D, LD, kThreads>(Ks + BKV * LD, vg, lay.ks, kv0, S, lt);
    if (has_ids<MASKED>(mask))
      for (int i = lt; i < BKV; i += kThreads) {
        const bool in = kv0 + i < S;  // zeros past S: masked by col < S
        cp_async4(Ks + 2 * BKV * LD + i,
                  reinterpret_cast<const float*>(seg + (size_t)b * S +
                                                 (in ? kv0 + i : 0)),
                  in);
      }
  };

  rows_async<BQ, D, LD, P::NT>(Qs, qg, lay.qs, q0, S, threadIdx.x);
  if (gi < n_tiles) load_kv(gi, 0);
  cp_async_commit();
  int sq[RT];
  int2 q_ids = make_int2(0, 0);
  if (has_ids<MASKED>(mask)) {
    for (int i = threadIdx.x; i < BQ; i += P::NT)
      sq_s[i] = q0 + i < S ? seg[(size_t)b * S + q0 + i] : -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT; ++i) sq[i] = sq_s[r0 + i];
    q_ids = id_range(sq_s, BQ);
  }

  float m_i[RT], l_i[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.0f;
  }

  if constexpr (KVG > 1) {  // Q, loaded by both groups, before either reads
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int i = 0, t = gi; t < n_tiles; ++i, t += KVG) {
    if (t + KVG < n_tiles) load_kv(t + KVG, i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) has landed
    group_sync<KVG>(gi);  // ... for every thread of the group
    const float* Ks = kv_stage(i);
    const float* Vs = Ks + BKV * LD;
    const int* ids = reinterpret_cast<const int*>(Vs + BKV * LD);
    const int kv0 = lo + t * BKV;
    bool skip = false;
    if (has_ids<MASKED>(mask)) {  // no shared document: a whole-block skip
      const int2 k_ids = id_range(ids, BKV);
      skip = q_ids.x > k_ids.y || k_ids.x > q_ids.y;
    }
    if (!skip) {
      // ---- S = Q K^T for the thread's RT x CT scores ----
      float s[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qa[RT], kb[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          qa[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < CT; ++j)
          kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }

      // ---- online softmax of the thread's rows ----
      // a tile needs the per-entry tests where the ragged edge, the
      // diagonal, the window's lower edge or segment ids reach into it
      const bool edge = kv0 + BKV > S || (causal && kv0 + BKV - 1 > q0) ||
                        (MASKED && window > 0 && kv0 < q0 + BQ - window) ||
                        has_ids<MASKED>(mask);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = q0 + r0 + i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int c = tx + 8 * j, col = kv0 + c;
          const bool ok =
              !edge || (col < S && keep<MASKED>(mask, row, col) &&
                        (!has_ids<MASKED>(mask) || sq[i] == ids[c]));
          s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        // fully masked so far: exp2 against 0 keeps p = corr = 0, not NaN
        const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
        const float corr = exp2f(m_i[i] - m_safe);
        float psum = 0.0f;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float p = exp2f(s[i][j] - m_safe);
          psum += p;
          Ps[(r0 + i) * LDP + tx + 8 * j] = p;
        }
        l_i[i] = l_i[i] * corr + psum;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] *= corr;
      }
      __syncwarp();  // the row's 8 lanes have written P

      // ---- O += P V ----
#pragma unroll 2
      for (int c = 0; c < BKV; c += 4) {
        float4 pa[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          pa[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * LDP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vb[DT];
#pragma unroll
          for (int g = 0; g < DT / 4; ++g) {
            const float4 x = *reinterpret_cast<const float4*>(
                Vs + (c + cc) * LD + (g * 8 + tx) * 4);
            vb[4 * g] = x.x, vb[4 * g + 1] = x.y, vb[4 * g + 2] = x.z,
                   vb[4 * g + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float p = cc == 0   ? pa[i].x
                            : cc == 1 ? pa[i].y
                            : cc == 2 ? pa[i].z
                                      : pa[i].w;
#pragma unroll
            for (int e = 0; e < DT; ++e) acc[i][e] = fmaf(p, vb[e], acc[i][e]);
          }
        }
      }
    }
    group_sync<KVG>(gi);  // the group is done with stage i and P
  }
  cp_async_wait<0>();
  if constexpr (KVG > 1) {
    // group 1 hands its m, l and O to group 0 through group 1's stages;
    // group 0 rescales both to the larger max and adds
    float* red = reinterpret_cast<float*>(smem + P::kv_off + 2 * P::stage);
    __syncthreads();
    if (gi == 1)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        red[(i * (DT + 2)) * kThreads + lt] = m_i[i];
        red[(i * (DT + 2) + 1) * kThreads + lt] = l_i[i];
#pragma unroll
        for (int c = 0; c < DT; ++c)
          red[(i * (DT + 2) + 2 + c) * kThreads + lt] = acc[i][c];
      }
    __syncthreads();
    if (gi == 1) return;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float m1 = red[(i * (DT + 2)) * kThreads + lt];
      const float l1 = red[(i * (DT + 2) + 1) * kThreads + lt];
      const float m_new = fmaxf(m_i[i], m1);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float c0 = exp2f(m_i[i] - m_safe), c1 = exp2f(m1 - m_safe);
      l_i[i] = l_i[i] * c0 + l1 * c1;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c)
        acc[i][c] = acc[i][c] * c0 +
                    red[(i * (DT + 2) + 2 + c) * kThreads + lt] * c1;
    }
  }

  float* og = o + b * lay.qb + h * lay.qh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float inv = l > 0.0f ? 1.0f / fmaxf(l, 1e-37f) : 0.0f;
#pragma unroll
    for (int g = 0; g < DT / 4; ++g) {
      float4 x;
      x.x = l > 0.0f ? acc[i][4 * g] * inv : 0.0f;
      x.y = l > 0.0f ? acc[i][4 * g + 1] * inv : 0.0f;
      x.z = l > 0.0f ? acc[i][4 * g + 2] * inv : 0.0f;
      x.w = l > 0.0f ? acc[i][4 * g + 3] * inv : 0.0f;
      *reinterpret_cast<float4*>(og + row * lay.qs + (g * 8 + tx) * 4) = x;
    }
    // natural-log lse from the base-2 running max
    if (tx == 0)
      lse[(size_t)bh * S + row] =
          l > 0.0f ? m_i[i] * kLn2 + logf(fmaxf(l, 1e-37f)) : -INFINITY;
  }
}

template <int D, int RT, int KVG, bool MASKED>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, float scale,
                   Mask mask, int layout, cudaStream_t stream) {
  using P = FwdF32<D, RT, KVG>;
  auto kernel = flash_fwd_f32<D, RT, KVG, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + P::BQ - 1) / P::BQ);
  kernel<<<grid, P::NT, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      make_layout(layout, H, Hkv, S, D), mask.causal, mask.window, mask.seg,
      H, Hkv, S, scale * kLog2e);
  return (int)cudaGetLastError();
}

// 64-row query tiles where they give every SM a block, else 32-row ones
// (twice the blocks, each with half the rows) with two KV groups (twice
// the threads on each block's band).
template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Hkv, int S, float scale, Mask mask, int layout,
            cudaStream_t stream) {
  const bool wide = (long long)B * H * ((S + 63) / 64) >= sm_count();
#define TAPER_FWD_F32(RT, KVG, MASKED)                                      \
  launch_fwd_f32<D, RT, KVG, MASKED>(q, k, v, o, lse, B, H, Hkv, S, scale, \
                                     mask, layout, stream)
  if (masked(mask))
    return wide ? TAPER_FWD_F32(4, 1, true) : TAPER_FWD_F32(2, 2, true);
  return wide ? TAPER_FWD_F32(4, 1, false) : TAPER_FWD_F32(2, 2, false);
#undef TAPER_FWD_F32
}

}  // namespace flash
}  // namespace taper

using namespace taper;
using namespace taper::flash;

// The exact kernel (K5): bf16 on flash_sm90.cu's, f32 on flash_fwd_f32.
// lse: [B*H, S] f32; seg: [B, S] int32 segment ids or null; window: > 0
// keeps cols > row - window.
extern "C" int taper_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* seg, int B,
                               int H, int Hkv, int S, int D, float scale,
                               int causal, int window, int layout, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Mask m{causal, window, static_cast<const int*>(seg)};
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return flash_fwd_sm90(q, k, v, o, l, m, B, H, Hkv, S, D, scale, layout,
                          s);
  if (dtype == kFloat32) {
    if (D == 32)
      return fwd_f32<32>(q, k, v, o, l, B, H, Hkv, S, scale, m, layout, s);
    if (D == 64)
      return fwd_f32<64>(q, k, v, o, l, B, H, Hkv, S, scale, m, layout, s);
    if (D == 128)
      return fwd_f32<128>(q, k, v, o, l, B, H, Hkv, S, scale, m, layout,
                          s);
  }
  return (int)cudaErrorInvalidValue;
}
