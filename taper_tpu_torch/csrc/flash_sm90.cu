// Flash attention on Hopper: K8, the bound-max forward, K7, the dK/dV
// backward, K10's fused sweep (K7's with dQ's share added) and K11 (K7's
// sweep over one query head, per-head partials out), in bf16 at D 64 or
// 128, on TMA rings and warpgroup MMA (wgmma) with the softmax in
// registers.  K6 (dQ) is flash_bwd_sm90.cu's.
//
// Replaces, for bf16 operands (16-byte aligned, as TMA needs and
// ops/backend.py::check_kernel_args demands of every launch; K7 and K10 in
// f32 run flash_bwd.cu's FMA kernels):
//   * taper_tpu/ops/pallas/attention.py::_fwd_kernel_bound (K8, launched
//     by _flash_fwd): causal attention o = softmax(scale q k^T) v and the
//     natural-log row logsumexp.  Softmax is shift-invariant, so any row
//     shift b >= max(s) gives the exact ratio; the Cauchy-Schwarz bound
//     b = |q_row| scale log2(e) max|k| (max over the KV head's positions)
//     is known before the first KV tile, so the bound arm has no running
//     max and no rescale.  The exact arm (a running max) is chosen per
//     launch by pred[0] in device memory, computed by the caller from
//     max|q| max|k| <= 60 in base 2, which keeps every row's largest weight
//     above 2^-120 and so inside f32; reading it here costs no host sync.
//     The row sum is clamped at 1e-37 for the same envelope, as
//     _fwd_kernel_bound does, and a launch on the bound arm adds one to
//     bound_count (when given);
//   * taper_tpu/ops/pallas/attention.py::_dkv_kernel (K7, launched by
//     _flash_bwd_impl): dK and dV of one KV tile over the band of query
//     tiles and the GQA group's query heads, under a causal mask, a
//     sliding window or segment ids;
//   * taper_tpu/ops/pallas/attention.py::_bwd_fused_kernel (K10, opt-in
//     under TAPER_ATTN_FUSED_BWD=1): K7's sweep (dkv_kernel<.., FUSED>)
//     that also adds each query tile's dS K into an f32 dQ buffer, between
//     flash_bwd.cu's delta pre-pass and dq_share_epilogue's scale and
//     cast.  JAX keeps the whole f32 dQ of a head in VMEM (1 MiB at the
//     170M shape), far beyond an SM's 227 KB: here the shares of the
//     blocks that see a query tile meet in device memory, added with
//     16-byte vector reductions (a TMA bulk reduce would need 32 KB more
//     shared memory for its staging than the 227 KB hold at D 128);
//   * taper_tpu/ops/pallas/attention.py::_dkv_kernel_t (K11, opt-in under
//     TAPER_ATTN_DKV_T=1 for non-causal or windowed masks without segment
//     ids): dK and dV of one KV tile for one query head
//     (dkv_kernel<.., kDkvPerHead>: a block a query head, the group loop
//     over that head alone), written as f32 partials [B, H, S, D] straight
//     from the fragments (f32 rows would need twice the bf16 staging), which
//     ops/attention.py::group_sum adds over each group, as JAX sums after
//     its kernel.  JAX's kernel computes on transposed tiles, s^T = K Q^T,
//     so that dV and dK are NN forms; K7's kernel here already does.
//
// What bounds them on the H100: tensor-core work.  At the 170M shape (B 8,
// H 8, S 2048, D 128, causal) K8's two products are 6.9e10 FLOP (69 us at
// 989 TFLOP/s), K7's four 1.4e11 (139 us) and K10's five 1.7e11 (174
// us); device memory traffic is O(S D) a head (K10 adds its dQ shares,
// ~0.55 GB of f32 reductions at that shape, served by L2).  The tensor cores reach that rate only through wgmma fed
// from swizzled shared memory with the operands' loads and the softmax off
// their critical path.  The first WMMA designs (flash_fwd.cu,
// flash_bwd.cu) ran at ~1/20 of it: 16 x 16 tiles, scores and weights
// round-tripped through shared memory, synchronous loads.
// What the design does about that:
//   * a block is a producer warpgroup and two consumer warpgroups of 64
//     rows each (K8: 128 query rows; K7: 128 KV rows); one producer thread
//     (K7: one warp) keeps a ring of 128-byte-swizzled tiles filled by TMA
//     (K8: K and V tiles of 128 rows, 3 stages at D 128 and 4 at D 64, K
//     and V with a barrier each so that the scores start before V has
//     landed; K7: Q and dO tiles of 64 rows with their lse, delta and
//     segment ids, 4 stages), each stage released by an "empty" mbarrier;
//     the operand that stays (K8's Q, K7's K and V) is loaded once;
//   * every product is one wgmma chain: K8 s = Q K^T (both K-major along
//     D), then o += p v with p from registers and v read N-major; K7
//     works on transposed tiles, s^T = K Q^T and dp^T = V dO^T (K-major,
//     issued together), then dV += p^T dO and dK += ds^T Q (A from
//     registers, B N-major, issued together), so neither operand is ever
//     transposed in memory;
//   * scores, weights and gradients never leave registers: the f32
//     accumulator of one product is the bf16 A operand of the next
//     (hopper.cuh, acc_to_a), row statistics are quad shuffles, and the
//     mask is applied to the fragment from each element's (row, col), on
//     the tiles that need it (the diagonal, a window's edges, ragged S,
//     segment ids) only; a K7 tile pair that the mask empties, or whose
//     segment-id ranges cannot meet, is skipped (no load when the whole
//     block skips it);
//   * the accumulators (K8: o; K7: dK and dV, summed over the group's
//     query heads in a fixed order, no atomics) stay in registers for the
//     whole sweep; the epilogue stages each warpgroup's 64 rows in bf16
//     over the shared-memory rows it alone read (K8: its Q rows; K7: its K
//     and V rows) and hands them to TMA stores, which drop rows past S;
//   * the grid takes heads fastest, so the longest rows of every head
//     (K8's last query tiles, K7's first KV tiles) go first;
//   * registers move from the producer to the consumers (setmaxnreg: 40
//     and 232 a thread; K7's two 64 x D f32 accumulators, at D 128 128
//     registers, beside two 64 x 64 score tiles: ptxas reports 0 bytes of
//     spills for every instantiation, and no wgmma serialisation).
// On an H100 80GB HBM3 at 700 W, the two consumer warpgroups of a block
// taking turns at the tensor cores (FA3's ping-pong), and a warpgroup's
// softmax under its own previous P V product, were not worth their code
// (PERF.md); both were left out.  A persistent grid, whose next tile's
// loads would run under this one's epilogue, is the next step for short
// rows.
#include <algorithm>
#include <climits>
#include <cstring>
#include <type_traits>

#include "flash_sm90.cuh"

namespace taper {
namespace flash {
namespace sm90 {

// ---- K8: the bound-max forward ------------------------------------------

// What a stage holds beside its K and V tiles in K5 (MASKED), written by
// the producer warp: the tile's 128 KV rows' segment ids (-1 past S), and
// whether the block skips the tile (no id of it meets the block's query
// rows'; its loads are then not issued).
struct FwdIds {
  int ids[128];
  int skip, pad[3];
};

// K5 (MASKED) adds a FwdIds a stage: 1.5 KB at D 128, which the 227 KB
// still hold beside three stages.
template <int D, bool MASKED>
struct FwdTiles {
  static constexpr int BM = 128;                  // query rows a block
  static constexpr int BN = 128;                  // KV rows a tile
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGE_OFF = Q_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int IDS_OFF = BAR_OFF + (1 + 3 * STAGES) * 8;
  static constexpr int SMEM =
      IDS_OFF + (MASKED ? STAGES * (int)sizeof(FwdIds) : 0) + 1024;
};

// The softmax of one raw score tile in registers (the thread's two rows):
// masks where the tile needs it (``edge``: the pairs ``keep`` refuses),
// takes the shift (the bound, or the running max, whose correction of the
// earlier tiles it returns in ``corr``) and turns the scores into weights
// exp2(s scale log2(e) - shift), summing the thread's share of each row
// into ``l``.
template <int BN, typename Keep>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool fast,
                                             bool edge, int row0, int kv0,
                                             float scale_log2, Keep keep) {
  if (edge) mask_frag<BN>(sc, row0, kv0, -INFINITY, keep);
  float shift[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (fast) {
      shift[h2] = m[h2];
      corr[h2] = 1.0f;
      continue;
    }
    // the max of the raw scores, scaled after (the scale is positive)
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e)
      if (frag_row(e) == 8 * h2) mx = fmaxf(mx, sc[e]);
    const float m_new = fmaxf(m[h2], quad_max(mx) * scale_log2);
    // fully masked so far: exp2 against 0 keeps p = corr = 0, not NaN
    shift[h2] = m_new == -INFINITY ? 0.0f : m_new;
    corr[h2] = exp2_approx(m[h2] - shift[h2]);
    m[h2] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const float p =
        exp2_approx(fmaf(sc[e], scale_log2, -shift[frag_row(e) / 8]));
    sum[frag_row(e) / 8] += p;  // the thread's columns; quad-summed last
    sc[e] = p;
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) l[h2] = l[h2] * corr[h2] + sum[h2];
}

// o += P V over one tile: V's rows are the product's K, its D columns the
// N; issued and committed.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BN / 16][4],
                                         uint32_t vs) {
  fence_frag(o);
  fence_frag(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(o, pa[kk], desc_n<BN>(vs, kk), 1);
    else
      wgmma_m64n64k16_rs<1>(o, pa[kk], desc_n<BN>(vs, kk), 1);
  }
  wgmma_commit();
}

// K5's producer warp: Q once, then for each KV tile of the band the
// tile's segment ids and whether the block skips it (its ids' range
// cannot meet the block's query rows'), written into the stage's FwdIds
// before the warp arrives on k_full (the lanes' arrivals release them);
// lane 0 issues the TMA loads of the tiles it does not skip.
template <int D>
__device__ __forceinline__ void fwd_produce_masked(
    unsigned char* smem, uint64_t* q_full, uint64_t* k_full,
    uint64_t* v_full, uint64_t* empty, FwdIds* kv_ids,
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    HeadAt qat, HeadAt kat, const int* __restrict__ seg, int b, int q0,
    int j_lo, int j_hi, int S) {
  using P = FwdTiles<D, true>;
  const int lane = threadIdx.x;
  // the ids' range of the block's query rows
  int qlo = INT_MAX, qhi = INT_MIN;
  if (seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + lane + 32 * i;
      if (r < S) {
        const int id = seg[(size_t)b * S + r];
        qlo = min(qlo, id);
        qhi = max(qhi, id);
      }
    }
    qlo = __reduce_min_sync(0xffffffffu, qlo);
    qhi = __reduce_max_sync(0xffffffffu, qhi);
  }
  if (lane == 0) {
    tma_prefetch_desc(tq);
    tma_prefetch_desc(tk);
    tma_prefetch_desc(tv);
    mbar_expect_tx(q_full, P::Q_BYTES);
    load_tile<D, P::BM>(smem, tq, q_full, qat, q0);
  }
  for (int j = j_lo; j < j_hi; ++j) {
    const int it = j - j_lo, s = it % P::STAGES, kv0 = j * P::BN;
    if (it >= P::STAGES) mbar_wait(&empty[s], (it / P::STAGES - 1) & 1);
    bool skip = false;
    if (seg != nullptr) {
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kv0 + lane + 32 * i;
        const int id = r < S ? seg[(size_t)b * S + r] : -1;
        kv_ids[s].ids[lane + 32 * i] = id;
        if (r < S) {
          lo = min(lo, id);
          hi = max(hi, id);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      skip = !(lo <= qhi && qlo <= hi);
    }
    if (lane == 0) kv_ids[s].skip = skip;
    if (lane == 0 && !skip) {
      unsigned char* ks = smem + P::STAGE_OFF + s * P::STAGE_BYTES;
      mbar_expect_tx(&k_full[s], P::KV_BYTES);
      load_tile<D, P::BN>(ks, tk, &k_full[s], kat, kv0);
      mbar_expect_tx(&v_full[s], P::KV_BYTES);
      load_tile<D, P::BN>(ks + P::KV_BYTES, tv, &v_full[s], kat, kv0);
    } else {
      mbar_arrive(&k_full[s]);
      if (lane == 0) mbar_arrive(&v_full[s]);
    }
  }
}

// One block a (batch * head, 128-row query tile), the longest rows first.
// ``to``: o's descriptor in boxes of 64 rows; ``tq``: q's in 128.  A
// stage's K and V have a barrier each, so that s = Q K^T starts before V
// has landed.
//
// MASKED = false is K8: causal, the bound arm or the exact one (pred[0]).
// MASKED = true is K5, the exact arm under every mask its last three
// parameters give (see Mask): the loop runs over the band of 128-row KV
// tiles the block's rows keep (kv_begin of its first row to kv_end of its
// last), the mask is applied to the tiles that need it (a window's edges,
// the diagonal, ragged S, segment ids), and a tile whose ids cannot meet
// the block's is skipped by producer and consumers alike (the consumers
// still wait for its stage and release it).  A fully masked row gets o = 0
// and lse = -inf.  The parameters K5 adds come last, so that K8 compiles
// as it did without them.
template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               float* __restrict__ lse, const float* __restrict__ kn,
               const int* __restrict__ pred, int* bound_count, int H,
               int Hkv, int S, int layout, float scale_log2, int causal,
               int window, const int* __restrict__ seg) {
  using P = FwdTiles<D, MASKED>;
  [[maybe_unused]] const Mask mask{causal, window, seg};  // K5's
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + P::STAGES;
  uint64_t* empty = v_full + P::STAGES;
  [[maybe_unused]] FwdIds* kv_ids =
      reinterpret_cast<FwdIds*>(smem + P::IDS_OFF);

  // heads fastest, so that every head's longest rows go first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P::BM;
  // the causal band: KV tiles up to the block's last row (kv_end of its
  // second 64-row half)
  const int n_tiles = (min(S, q0 + P::BM) + P::BN - 1) / P::BN;
  // K5's band: from the tile of the first column its first row keeps
  // (kv_begin) to the causal band's end, or to S without causality
  const int j_lo =
      MASKED && window > 0 ? max(0, q0 - window + 1) / P::BN : 0;
  const int j_hi = MASKED && !causal ? (S + P::BN - 1) / P::BN : n_tiles;
  const HeadAt qat = head_at(layout, b, H, h, D);
  const HeadAt kat = head_at(layout, b, Hkv, hk, D);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      // K5: the producer warp's lanes (lane 0's expect_tx among them)
      mbar_init(&k_full[s], MASKED ? 32 : 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if constexpr (MASKED) {
      if (threadIdx.x < 32)
        fwd_produce_masked<D>(smem, q_full, k_full, v_full, empty, kv_ids,
                              &tq, &tk, &tv, qat, kat, seg, b, q0, j_lo,
                              j_hi, S);
    } else if (threadIdx.x == 0) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      mbar_expect_tx(q_full, P::Q_BYTES);
      load_tile<D, P::BM>(Qs, &tq, q_full, qat, q0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % P::STAGES;
        if (j >= P::STAGES) mbar_wait(&empty[s], (j / P::STAGES - 1) & 1);
        unsigned char* ks = smem + P::STAGE_OFF + s * P::STAGE_BYTES;
        mbar_expect_tx(&k_full[s], P::KV_BYTES);
        load_tile<D, P::BN>(ks, &tk, &k_full[s], kat, j * P::BN);
        mbar_expect_tx(&v_full[s], P::KV_BYTES);
        load_tile<D, P::BN>(ks + P::KV_BYTES, &tv, &v_full[s], kat,
                            j * P::BN);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // rows [64 c, 64 c + 64) of the block's tile
  const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane % 4;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // the thread's rows:
  const int row0 = q0 + 64 * c + r_lo;          // row0 and row0 + 8
  const bool fast = !MASKED && pred[0] != 0;  // uniform over the grid
  const uint32_t qs = smem_u32(Qs);
  const uint32_t stages = smem_u32(smem + P::STAGE_OFF);
  // K5: the segment ids of the thread's two rows (-1 past S)
  int qid0 = -1, qid1 = -1;
  if (has_ids<MASKED>(mask)) {
    if (row0 < S) qid0 = seg[(size_t)b * S + row0];
    if (row0 + 8 < S) qid1 = seg[(size_t)b * S + row0 + 8];
  }

  mbar_wait(q_full, 0);
  // the shift of each of the thread's two rows: the Cauchy-Schwarz bound
  // (bound arm), or a running max from -inf (exact arm)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (fast) {
    const float kmax = kn[b * Hkv + hk];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 64 * c + r_lo + 8 * h2;  // row in the Q tile
      float ss = 0.0f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {  // the quad's 16-byte chunks
        const int col = 8 * (quad + 4 * i);
        const uint4 u = *reinterpret_cast<const uint4*>(
            Qs + (col / 64) * P::BM * 128 + sw128_offset(r, col % 64));
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(v2[j]);
          ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
        }
      }
      m[h2] = sqrtf(quad_sum(ss)) * scale_log2 * kmax;
    }
  }

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
  float sc[P::BN / 2], corr[2];
  uint32_t pa[P::BN / 16][4];
  for (int j = j_lo; j < j_hi; ++j) {
    const int it = j - j_lo;  // ring position
    const int s = it % P::STAGES, kv0 = j * P::BN;
    const uint32_t ks = stages + s * P::STAGE_BYTES;
    mbar_wait(&k_full[s], (it / P::STAGES) & 1);
    if (MASKED && kv_ids[s].skip) {  // no shared document: nothing loaded
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16<0, 0>(sc, desc_k<P::BM>(qs, 64 * c, kk),
                             desc_k<P::BN>(ks, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(sc);
    if constexpr (MASKED) {
      // K5: the tiles that cross the window's lower edge, the diagonal or
      // S, and every tile under segment ids
      const int first = q0 + 64 * c;  // the warpgroup's first row
      const int* ids = kv_ids[s].ids;
      softmax_tile<P::BN>(
          sc, m, l, corr, false,
          kv0 + P::BN > S || (causal && kv0 + P::BN - 1 > first) ||
              (window > 0 && kv0 <= first + 63 - window) || seg != nullptr,
          row0, kv0, scale_log2, [&](int r, int col) {
            return col < S && keep<true>(mask, r, col) &&
                   (seg == nullptr ||
                    (r < row0 + 8 ? qid0 : qid1) == ids[col - kv0]);
          });
    } else {
      softmax_tile<P::BN>(sc, m, l, corr, fast,
                          kv0 + P::BN - 1 > q0 + 64 * c || kv0 + P::BN > S,
                          row0, kv0, scale_log2,
                          [S](int r, int col) { return col <= r && col < S; });
    }
    if (!fast) {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[frag_row(e) / 8];
    }
    acc_to_a<P::BN>(sc, pa);
    mbar_wait(&v_full[s], (it / P::STAGES) & 1);
    issue_pv<D, P::BN>(o, pa, ks + P::KV_BYTES);
    wgmma_wait<0>();
    fence_frag(o);
    fence_frag(pa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: o / l in bf16 over the warpgroup's own Q rows (which only
  // its wgmma read), then one TMA store of its 64 rows; lse from registers
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) l[h2] = quad_sum(l[h2]);
  named_bar_sync(1 + c, 128);
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = 64 * c + r_lo + frag_row(e), col = frag_col(e, quad);
    const float li = l[frag_row(e) / 8];
    const float inv = li > 0.0f ? 1.0f / fmaxf(li, 1e-37f) : 0.0f;
    *reinterpret_cast<uint32_t*>(Qs + (col / 64) * P::BM * 128 +
                                 sw128_offset(r, col % 64)) =
        pack_bf16x2(o[e] * inv, o[e + 1] * inv);
  }
  fence_proxy_async_smem();
  named_bar_sync(1 + c, 128);
  if (tid == 0) {
    store_rows<D, P::BM>(&to, Qs, 64 * c, qat, q0 + 64 * c);
    bulk_wait<0>();
  }
  if (quad == 0) {
    // natural-log lse: the shift is the base-2 running max or the bound
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + 8 * h2;
      if (row < S)
        lse[(size_t)bh * S + row] =
            l[h2] > 0.0f ? m[h2] * kLn2 + logf(fmaxf(l[h2], 1e-37f))
                         : -INFINITY;
    }
  }
  if (fast && bound_count != nullptr && tid == 0 && c == 0 &&
      blockIdx.x == 0 && blockIdx.y == 0)
    atomicAdd(bound_count, 1);
}

// K8 (MASKED = false: kn, pred and bound_count) or K5 (MASKED = true:
// the mask ``m``).
template <int D, bool MASKED>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const float* kn, const int* pred,
               int* bound_count, const Mask& m, int B, int H, int Hkv,
               int S, float scale, int layout, cudaStream_t stream) {
  using P = FwdTiles<D, MASKED>;
  CUtensorMap tq, tk, tv, to;
  int err = head_desc(&tq, q, layout, B, H, S, D, P::BM);
  if (err == 0) err = head_desc(&tk, k, layout, B, Hkv, S, D, P::BN);
  if (err == 0) err = head_desc(&tv, v, layout, B, Hkv, S, D, P::BN);
  if (err == 0) err = head_desc(&to, o, layout, B, H, S, D, 64);
  if (err != 0) return err;
  auto kernel = fwd_kernel<D, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + P::BM - 1) / P::BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(
      tq, tk, tv, to, lse, kn, pred, bound_count, H, Hkv, S, layout,
      scale * kLog2e, m.causal, m.window, m.seg);
  return (int)cudaGetLastError();
}

// ---- K7: dK and dV (and K10's sweep, K11) --------------------------------

// dkv_kernel's modes: K7 (the GQA group's query heads summed into one dK
// and dV), K10's sweep (K7's, adding each query tile's share of dQ) and
// K11 (one query head's dK and dV, written as f32 partials).
enum DkvMode : int { kDkvSum = 0, kDkvFused = 1, kDkvPerHead = 2 };

// What a stage holds beside its Q and dO tiles, written by the producer
// warp: the tile's 64 query rows' lse in base 2 (0 past S or for a fully
// masked row, whose weights are masked anyway), delta (0 past S) and
// segment ids (-1 past S), the ids' range, and whether the block skips the
// tile (its KV rows' ids cannot meet the tile's; the TMA loads are then
// not issued).
struct DkvSlot {
  float lse2[64];
  float delta[64];
  int ids[64];
  int lo, hi, skip, pad;
};

// K10 (FUSED) adds two ds^T tiles of [128 KV rows, 64 query rows] bf16,
// used in turns, and at D 128 gives up a stage for them (227 KB).
template <int D, bool FUSED>
struct DkvTiles {
  static constexpr int BKV = 128;                 // KV rows a block
  static constexpr int BQ = 64;                   // query rows a tile
  static constexpr int KV_BYTES = BKV * D * 2;    // K or V
  static constexpr int T_BYTES = BQ * D * 2;      // a Q or dO tile
  static constexpr int STAGES = FUSED && D == 128 ? 3 : 4;
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;
  static constexpr int DS_BYTES = BKV * BQ * 2;   // one ds^T tile
  static constexpr int DS_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int SLOT_OFF = DS_OFF + (FUSED ? 2 * DS_BYTES : 0);
  static constexpr int RANGE_OFF = SLOT_OFF + STAGES * (int)sizeof(DkvSlot);
  static constexpr int BAR_OFF = RANGE_OFF + 2 * 4 * 2 * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// K10: the ds^T fragment ``a`` (acc_to_a's registers: the thread's KV
// rows ``r`` and ``r`` + 8 of a ds^T tile, 64 query columns) into the
// swizzled [128, 64] bf16 tile at ``tile``.
__device__ __forceinline__ void put_ds(unsigned char* tile,
                                       const uint32_t (&a)[4][4], int r) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(
          tile + sw128_offset(r + 8 * (i & 1), 16 * k + 8 * (i >> 1) +
                                                   2 * quad)) = a[k][i];
}

// K10: issues warpgroup ``c``'s share of one query tile's dQ_part = dS K,
// an m64n64 product: at D 128 columns [64 c, 64 c + 64) of D over the
// block's 128 KV rows, at D 64 all 64 columns over the warpgroup's own 64
// KV rows (so that both warpgroups issue the same instructions, with no
// branch around a wgmma).  dS is read from the ds^T tile ``ds`` M-major
// (the instruction's transpose bit), K N-major.
template <int D, int BKV>
__device__ __forceinline__ void issue_dq_share(float (&dqp)[32], uint32_t ds,
                                               uint32_t ks, int c) {
  constexpr int KK = D == 128 ? BKV / 16 : BKV / 32;  // k16 slices
  const int kk0 = D == 128 ? 0 : KK * c;
  const uint32_t kb = ks + (D == 128 ? c * BKV * 128 : 0);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_m64n64k16<1, 1>(dqp, desc_n<BKV>(ds, kk0 + kk),
                          desc_n<BKV>(kb, kk0 + kk), kk > 0);
}

// K10: adds the warpgroup's m64n64 share into its chunk of dq_acc with
// 16-byte vector reductions (red.global.add.v4.f32), in fragment order:
// element 4 j + i of thread t at float 4 (128 j + t) + i, so that a warp's
// reduction covers 512 contiguous bytes (dq_share_epilogue reads it back).
__device__ __forceinline__ void red_dq_share(float* chunk,
                                             const float (&dqp)[32],
                                             int tid) {
  float4* dst = reinterpret_cast<float4*>(chunk) + tid;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    atomicAdd(dst + 128 * j, make_float4(dqp[4 * j], dqp[4 * j + 1],
                                         dqp[4 * j + 2], dqp[4 * j + 3]));
}

// One block a (batch * KV head, 128-row KV tile); its first tiles see the
// most query rows under causality.  The query tiles of the band are taken
// head by head over the GQA group, in the same order on every run, and
// summed into one set of f32 accumulators before one cast.  ``tq``/``tdo``:
// boxes of 64 rows; ``tk``/``tv``: 128; ``tdk``/``tdv``: 64.
//
// FUSED (K10) adds each query tile's share of dQ: the two consumer
// warpgroups put their ds^T halves into one shared tile (two tiles used in
// turns), each announces its half on a named barrier without waiting
// (bar.arrive) and issues dV and dK, then waits for the other's half,
// computes its m64n64 part of dS K (issue_dq_share) and adds it into
// ``dq_acc`` (red_dq_share; zeroed by the caller, [B*H, n_qt, D / 64, 64 *
// 64] f32 with n_qt = ceil(S / 64)).  Waiting for the other half of tile
// j also orders this warpgroup's writes of tile j + 2 after the other's
// reads of tile j, and one warpgroup's softmax can run under the other's
// products.  A warpgroup whose pair the mask empties still computes it
// (its ds^T is 0 there): the other needs its half, and no wgmma sits
// behind a branch (ptxas serialises the wgmma of a kernel that has one).
// The order of the blocks' additions varies from run to run, and so do
// dQ's low bits.
//
// K11 (kDkvPerHead) takes one block a (batch * query head, KV tile): the
// sweep covers that head's query tiles alone, and the epilogue writes its
// dK (scaled as K7's) and dV as f32 partials [B, H, S, D] (dk_part,
// dv_part).
template <int D, bool MASKED, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tdk,
               const __grid_constant__ CUtensorMap tdv,
               const float* __restrict__ lse, const float* __restrict__ delta,
               int causal, int window, const int* __restrict__ seg, int H,
               int Hkv, int S, int layout, float scale, float scale_log2,
               float* __restrict__ dq_acc, int n_qt,
               float* __restrict__ dk_part, float* __restrict__ dv_part) {
  constexpr bool FUSED = MODE == kDkvFused, PER_HEAD = MODE == kDkvPerHead;
  const Mask mask{causal, window, seg};  // see Mask
  using P = DkvTiles<D, FUSED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + P::KV_BYTES;
  DkvSlot* slots = reinterpret_cast<DkvSlot*>(smem + P::SLOT_OFF);
  int* ranges = reinterpret_cast<int*>(smem + P::RANGE_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + P::STAGES;

  // KV heads (K11: query heads) fastest, so that every head's first
  // (longest) tiles go first
  const int heads = PER_HEAD ? H : Hkv, group = H / Hkv;
  const int b = blockIdx.x / heads;
  const int hk = PER_HEAD ? blockIdx.x % H / group : blockIdx.x % Hkv;
  // the sweep's query heads: the group's g0 .. g0 + n_g - 1 (K11: the
  // block's own)
  const int g0 = PER_HEAD ? blockIdx.x % H % group : 0;
  const int n_g = PER_HEAD ? 1 : group;
  const int kv0 = blockIdx.y * P::BKV;
  // the band of query tiles the block's two 64-row halves see
  const int q_lo = q_begin(mask, kv0);
  const int q_hi = q_end<MASKED>(mask, kv0 + 64, S);
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + P::BQ - 1) / P::BQ : 0;
  const int total = n_g * n_q;
  const HeadAt kat = head_at(layout, b, Hkv, hk, D);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp; lane 0 issues the TMA loads, every lane writes
    // two query rows' lse, delta and ids and arrives
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch_desc(&tq);
      tma_prefetch_desc(&tdo);
      mbar_expect_tx(kv_full, 2 * P::KV_BYTES);
      load_tile<D, P::BKV>(Ks, &tk, kv_full, kat, kv0);
      load_tile<D, P::BKV>(Vs, &tv, kv_full, kat, kv0);
    }
    int klo = 0, khi = 0;  // the block's KV ids' range
    if (has_ids<MASKED>(mask)) {
      klo = INT_MAX;
      khi = INT_MIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kv0 + lane + 32 * i;
        const int id = r < S ? seg[(size_t)b * S + r] : -1;
        klo = min(klo, id);
        khi = max(khi, id);
      }
      klo = __reduce_min_sync(0xffffffffu, klo);
      khi = __reduce_max_sync(0xffffffffu, khi);
    }
    for (int it = 0; it < total; ++it) {
      const int g = g0 + it / n_q, q0 = q_lo + (it % n_q) * P::BQ;
      const int h = hk * group + g, bh = b * H + h;
      const int s = it % P::STAGES;
      if (it >= P::STAGES) mbar_wait(&empty[s], (it / P::STAGES - 1) & 1);
      DkvSlot& sl = slots[s];
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = lane + 32 * i, row = q0 + col;
        const float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
        sl.lse2[col] = isfinite(l) ? l * kLog2e : 0.0f;
        sl.delta[col] = row < S ? delta[(size_t)bh * S + row] : 0.0f;
        if (has_ids<MASKED>(mask)) {
          const int id = row < S ? seg[(size_t)b * S + row] : -1;
          sl.ids[col] = id;
          lo = min(lo, id);
          hi = max(hi, id);
        }
      }
      bool skip = false;
      if (has_ids<MASKED>(mask)) {
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        skip = !(lo <= khi && klo <= hi);  // no shared document
      }
      if (lane == 0) {
        sl.lo = lo;
        sl.hi = hi;
        sl.skip = skip;
      }
      if (lane == 0 && !skip) {
        const HeadAt qat = head_at(layout, b, H, h, D);
        unsigned char* qt = smem + P::STAGE_OFF + s * P::STAGE_BYTES;
        mbar_expect_tx(&full[s], P::STAGE_BYTES);
        load_tile<D, P::BQ>(qt, &tq, &full[s], qat, q0);
        load_tile<D, P::BQ>(qt + P::T_BYTES, &tdo, &full[s], qat, q0);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // KV rows [64 c, 64 c + 64) of the block's tile
  const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane % 4;
  const int r_lo = (tid / 32) * 16 + lane / 4;
  const int k0 = kv0 + 64 * c;  // the warpgroup's first KV row
  const int kr0 = k0 + r_lo;    // the thread's KV rows: kr0 and kr0 + 8
  const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
  // the thread's KV rows' ids and the warpgroup's range
  int kid0 = 0, kid1 = 0, wlo = 0, whi = 0;
  if (has_ids<MASKED>(mask)) {
    kid0 = kr0 < S ? seg[(size_t)b * S + kr0] : -1;
    kid1 = kr0 + 8 < S ? seg[(size_t)b * S + kr0 + 8] : -1;
    const int lo = __reduce_min_sync(0xffffffffu, min(kid0, kid1));
    const int hi = __reduce_max_sync(0xffffffffu, max(kid0, kid1));
    if (lane == 0) {
      ranges[(c * 4 + tid / 32) * 2] = lo;
      ranges[(c * 4 + tid / 32) * 2 + 1] = hi;
    }
    named_bar_sync(1 + c, 128);
    wlo = INT_MAX;
    whi = INT_MIN;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      wlo = min(wlo, ranges[(c * 4 + w) * 2]);
      whi = max(whi, ranges[(c * 4 + w) * 2 + 1]);
    }
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    dk[e] = 0.0f;
    dv[e] = 0.0f;
  }
  int xc = 0;  // K10: ds^T tiles exchanged so far (alike in both)
  [[maybe_unused]] float dqp[FUSED ? 32 : 1];
  // K10: the warpgroup's chunk of dq_acc for query tile q0 of query head
  // g of the group
  [[maybe_unused]] auto chunk = [&](int g, int q0) {
    const size_t bh = (size_t)b * H + hk * group + g;
    return dq_acc +
           ((bh * n_qt + q0 / 64) * (D / 64) + (D == 128 ? c : 0)) * 4096;
  };
  mbar_wait(kv_full, 0);
  for (int it = 0; it < total; ++it) {
    const int g = g0 + it / n_q, q0 = q_lo + (it % n_q) * P::BQ;
    const int s = it % P::STAGES;
    mbar_wait(&full[s], (it / P::STAGES) & 1);
    const DkvSlot& sl = slots[s];
    const bool block_skip = sl.skip;
    // the warpgroup's tile pair adds nothing: masked whole (the far side
    // of the diagonal, behind the window) or no shared document
    bool skip = block_skip || (causal && q0 + P::BQ - 1 < k0) ||
                (MASKED && window > 0 && q0 - window >= k0 + 63);
    if (has_ids<MASKED>(mask) && !skip)
      skip = !(sl.lo <= whi && wlo <= sl.hi);
    // K10 skips only what the whole block skips (see above)
    if (FUSED ? block_skip : skip) {
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t qs = smem_u32(smem + P::STAGE_OFF + s * P::STAGE_BYTES);
    const uint32_t dos = qs + P::T_BYTES;

    // s^T = K Q^T and dp^T = V dO^T: the warpgroup's 64 KV rows against
    // the tile's 64 query rows, all operands K-major along D
    float st[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(st, desc_k<P::BKV>(ks, 64 * c, kk),
                            desc_k<P::BQ>(qs, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(dp, desc_k<P::BKV>(vs, 64 * c, kk),
                            desc_k<P::BQ>(dos, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(st);
    fence_frag(dp);

    // p^T = exp2(s^T scale log2(e) - lse), masked pairs 0; then ds^T =
    // p^T (dp^T - delta) over dp^T: a row is a KV row, a column a query row
#pragma unroll
    for (int e = 0; e < 32; ++e)
      st[e] = st[e] * scale_log2 - sl.lse2[frag_col(e, quad)];
    const bool edge = q0 + P::BQ > S || k0 + 64 > S ||
                      (causal && q0 < k0 + 63) ||
                      (MASKED && window > 0 && q0 + P::BQ - 1 - window >= k0) ||
                      has_ids<MASKED>(mask);
    if (edge)
      mask_frag<64>(st, kr0, q0, -INFINITY, [&](int kv, int qrow) {
        return kv < S && qrow < S && keep<MASKED>(mask, qrow, kv) &&
               (!has_ids<MASKED>(mask) ||
                (kv < kr0 + 8 ? kid0 : kid1) == sl.ids[qrow - q0]);
      });
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      st[e] = exp2_approx(st[e]);
      dp[e] = st[e] * (dp[e] - sl.delta[frag_col(e, quad)]);
    }
    // p^T and ds^T as the bf16 A operands (p cast to dO's dtype, ds to
    // Q's, as JAX's kernel casts them)
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a<64>(st, pa);
    acc_to_a<64>(dp, dsa);
    [[maybe_unused]] unsigned char* dt =
        smem + P::DS_OFF + (xc & 1) * P::DS_BYTES;
    // K10: named barriers 4 + 2 w + t announce warpgroup w's half of ds^T
    // tile t
    if constexpr (FUSED) {
      put_ds(dt + 64 * c * 128, dsa, r_lo);
      fence_proxy_async_smem();
      named_bar_arrive(4 + 2 * c + (xc & 1), 256);
    }

    // dV += p^T dO and dK += ds^T Q, dO and Q read N-major (K10: and the
    // warpgroup's share of dS K)
    fence_frag(dv);
    fence_frag(dk);
    fence_frag(pa);
    fence_frag(dsa);
    if constexpr (FUSED) fence_frag(dqp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BQ / 16; ++kk) {
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(dv, pa[kk], desc_n<P::BQ>(dos, kk), 1);
      else
        wgmma_m64n64k16_rs<1>(dv, pa[kk], desc_n<P::BQ>(dos, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < P::BQ / 16; ++kk) {
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(dk, dsa[kk], desc_n<P::BQ>(qs, kk), 1);
      else
        wgmma_m64n64k16_rs<1>(dk, dsa[kk], desc_n<P::BQ>(qs, kk), 1);
    }
    wgmma_commit();
    if constexpr (FUSED) {
      named_bar_sync(4 + 2 * (1 - c) + (xc & 1), 256);
      wgmma_fence();
      issue_dq_share<D, P::BKV>(dqp, smem_u32(dt), ks, c);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_frag(dv);
    fence_frag(dk);
    fence_frag(pa);
    fence_frag(dsa);
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (FUSED) {
      fence_frag(dqp);
      red_dq_share(chunk(g, q0), dqp, tid);
      ++xc;
    }
  }

  if constexpr (PER_HEAD) {
    // K11: the head's dK (scaled once) and dV as f32 partials [B, H, S,
    // D], straight from the fragments (a quad writes 32 contiguous bytes
    // of a row)
    const size_t bh = (size_t)b * H + hk * group + g0;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int row = kr0 + frag_row(e), col = frag_col(e, quad);
      if (row >= S) continue;
      const size_t at = (bh * S + row) * D + col;
      *reinterpret_cast<float2*>(dk_part + at) =
          make_float2(dk[e] * scale, dk[e + 1] * scale);
      *reinterpret_cast<float2*>(dv_part + at) = make_float2(dv[e], dv[e + 1]);
    }
    return;
  }
  // epilogue: dK (scaled once) and dV in bf16 over the warpgroup's own K
  // and V rows (which only its wgmma read; K10's dS K read all of K, so
  // both warpgroups finish that first), then TMA stores of its 64 rows
  if constexpr (FUSED) named_bar_sync(3, 256);
  named_bar_sync(1 + c, 128);
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = 64 * c + r_lo + frag_row(e), col = frag_col(e, quad);
    const uint32_t at = (col / 64) * P::BKV * 128 + sw128_offset(r, col % 64);
    *reinterpret_cast<uint32_t*>(Ks + at) =
        pack_bf16x2(dk[e] * scale, dk[e + 1] * scale);
    *reinterpret_cast<uint32_t*>(Vs + at) = pack_bf16x2(dv[e], dv[e + 1]);
  }
  fence_proxy_async_smem();
  named_bar_sync(1 + c, 128);
  if (tid == 0) {
    store_rows<D, P::BKV>(&tdk, Ks, 64 * c, kat, k0);
    store_rows<D, P::BKV>(&tdv, Vs, 64 * c, kat, k0);
    bulk_wait<0>();
  }
}

// K7 (kDkvSum), K10's sweep (kDkvFused: dq_acc) or K11 (kDkvPerHead: dk
// and dv are the f32 partials [B, H, S, D]).
template <int D, bool MASKED, int MODE>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq_acc, void* dk,
               void* dv, const int* seg, int B, int H, int Hkv, int S,
               float scale, int causal, int window, int layout,
               cudaStream_t stream) {
  constexpr bool PER_HEAD = MODE == kDkvPerHead;
  using P = DkvTiles<D, MODE == kDkvFused>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = head_desc(&tq, q, layout, B, H, S, D, P::BQ);
  if (err == 0) err = head_desc(&tdo, dout, layout, B, H, S, D, P::BQ);
  if (err == 0) err = head_desc(&tk, k, layout, B, Hkv, S, D, P::BKV);
  if (err == 0) err = head_desc(&tv, v, layout, B, Hkv, S, D, P::BKV);
  if (PER_HEAD) {
    memset(&tdk, 0, sizeof(tdk));
    memset(&tdv, 0, sizeof(tdv));
  } else {
    if (err == 0) err = head_desc(&tdk, dk, layout, B, Hkv, S, D, 64);
    if (err == 0) err = head_desc(&tdv, dv, layout, B, Hkv, S, D, 64);
  }
  if (err != 0) return err;
  auto kernel = dkv_kernel<D, MASKED, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * (PER_HEAD ? H : Hkv), (S + P::BKV - 1) / P::BKV);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, lse, delta, causal, window, seg, H, Hkv, S,
      layout, scale, scale * kLog2e, dq_acc, (S + 63) / 64,
      PER_HEAD ? static_cast<float*>(dk) : nullptr,
      PER_HEAD ? static_cast<float*>(dv) : nullptr);
  return (int)cudaGetLastError();
}

// K10's epilogue: dq = dq_acc scale in bf16, in q's layout.  dq_acc holds
// each (head, 64-row query tile, 64-column block of D) as red_dq_share
// left it: one float4 a thread, rows r and r + 8, columns c and c + 1.
template <int D>
__global__ void dq_share_epilogue(const float4* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ dq, int H,
                                  int S, int n_qt, int layout, float scale,
                                  long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(i % 128), j = (int)(i / 128 % 8);
    const long long block = i / 1024;  // (bh, query tile, column block)
    const int x = (int)(block % (D / 64));
    const long long tile = block / (D / 64);
    const int bh = (int)(tile / n_qt), b = bh / H, h = bh % H;
    const int row = (int)(tile % n_qt) * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = 64 * x + 8 * j + 2 * (t % 4);
    const float4 a = acc[i];
    if (row < S)
      *reinterpret_cast<uint32_t*>(dq + row_at(layout, b, H, h, S, D, row) +
                                   col) = pack_bf16x2(a.x * scale,
                                                      a.y * scale);
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(
          dq + row_at(layout, b, H, h, S, D, row + 8) + col) =
          pack_bf16x2(a.z * scale, a.w * scale);
  }
}

template <int D, bool MASKED>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq_acc, void* dq, void* dk, void* dv, const int* seg,
                 int B, int H, int Hkv, int S, float scale, int causal,
                 int window, int layout, cudaStream_t stream) {
  int err = launch_dkv<D, MASKED, kDkvFused>(q, k, v, dout, lse, delta,
                                             dq_acc, dk, dv, seg, B, H, Hkv,
                                             S, scale, causal, window, layout,
                                             stream);
  if (err != 0) return err;
  const int n_qt = (S + 63) / 64;
  const long long n4 = (long long)B * H * n_qt * 64 * D / 4;
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 132 * 16);
  dq_share_epilogue<D><<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc),
      static_cast<__nv_bfloat16*>(dq), H, S, n_qt, layout, scale, n4);
  return (int)cudaGetLastError();
}

// ---- a card test of the fragment helpers ---------------------------------

// One warpgroup: s = a b^T (SS wgmma, both K-major), the rows' max and sum
// of s by quad shuffles, then out = bf16(s) c with bf16(s) taken from the
// accumulator as A fragments (RS wgmma, c N-major); a [64, 64], b [64, 64]
// and c [64, N] bf16 row-major, out [64, N] f32.
template <int N>
__global__ void __launch_bounds__(128)
    frag_test_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ c,
                     float* __restrict__ out, float* __restrict__ rmax,
                     float* __restrict__ rsum) {
  __shared__ __align__(1024) unsigned char sm[(2 + N / 64) * 8192];
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const uint4* c4 = reinterpret_cast<const uint4*>(c);
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {
    const int r = i / 8, col = (i % 8) * 8;
    *reinterpret_cast<uint4*>(sm + sw128_offset(r, col)) = a4[i];
    *reinterpret_cast<uint4*>(sm + 8192 + sw128_offset(r, col)) = b4[i];
  }
  for (int i = threadIdx.x; i < 64 * N / 8; i += 128) {
    const int r = i / (N / 8), col = (i % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(sm + 16384 + (col / 64) * 8192 +
                              sw128_offset(r, col % 64)) = c4[i];
  }
  fence_proxy_async_smem();
  __syncthreads();
  const uint32_t base = smem_u32(sm);
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16<0, 0>(s, desc_k<64>(base, 0, kk),
                          desc_k<64>(base + 8192, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_frag(s);
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int r_lo = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float mx = -INFINITY, sum = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (frag_row(e) == 8 * h2) {
        mx = fmaxf(mx, s[e]);
        sum += s[e];
      }
    mx = quad_max(mx);
    sum = quad_sum(sum);
    if (quad == 0) {
      rmax[r_lo + 8 * h2] = mx;
      rsum[r_lo + 8 * h2] = sum;
    }
  }
  uint32_t pa[4][4];
  acc_to_a<64>(s, pa);
  float o[N / 2];
  fence_frag(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 128)
      wgmma_m64n128k16_rs<1>(o, pa[kk], desc_n<64>(base + 16384, kk),
                             kk > 0);
    else
      wgmma_m64n64k16_rs<1>(o, pa[kk], desc_n<64>(base + 16384, kk),
                            kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_frag(o);
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    out[(r_lo + frag_row(e)) * N + frag_col(e, quad)] = o[e];
}

}  // namespace sm90

int flash_dkv_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const Mask& m, int B, int H, int Hkv,
                   int S, int D, float scale, int layout,
                   cudaStream_t stream) {
  return sm90::by_dim_and_mask(D, m, [&](auto d, auto mk) {
    return sm90::launch_dkv<decltype(d)::value, decltype(mk)::value,
                            sm90::kDkvSum>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, m.seg, B, H, Hkv, S,
        scale, m.causal, m.window, layout, stream);
  });
}

int flash_dkv_t_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dk_part, float* dv_part, const Mask& m, int B,
                     int H, int Hkv, int S, int D, float scale, int layout,
                     cudaStream_t stream) {
  return sm90::by_dim_and_mask(D, m, [&](auto d, auto mk) {
    return sm90::launch_dkv<decltype(d)::value, decltype(mk)::value,
                            sm90::kDkvPerHead>(
        q, k, v, dout, lse, delta, nullptr, dk_part, dv_part, m.seg, B, H,
        Hkv, S, scale, m.causal, m.window, layout, stream);
  });
}

int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Mask& m, int B, int H, int Hkv, int S,
                   int D, float scale, int layout, cudaStream_t stream) {
  auto go = [&](auto d) {
    return sm90::launch_fwd<decltype(d)::value, true>(
        q, k, v, o, lse, nullptr, nullptr, nullptr, m, B, H, Hkv, S, scale,
        layout, stream);
  };
  if (D == 64) return go(std::integral_constant<int, 64>{});
  if (D == 128) return go(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

int flash_fused_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dq_acc, void* dq, void* dk, void* dv,
                     const Mask& m, int B, int H, int Hkv, int S, int D,
                     float scale, int layout, cudaStream_t stream) {
  return sm90::by_dim_and_mask(D, m, [&](auto d, auto mk) {
    return sm90::launch_fused<decltype(d)::value, decltype(mk)::value>(
        q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, m.seg, B, H, Hkv, S,
        scale, m.causal, m.window, layout, stream);
  });
}

}  // namespace flash
}  // namespace taper

// K8: bf16, causal.  kn: [B*Hkv] f32, max |k| per KV head; pred: one
// int32, the arm; bound_count: one int32 or null; lse: [B*H, S] f32.
extern "C" int taper_flash_fwd_bound(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* kn, const void* pred,
                                     void* bound_count, int B, int H,
                                     int Hkv, int S, int D, float scale,
                                     int layout, void* stream) {
  using namespace taper::flash::sm90;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const taper::flash::Mask causal{1, 0, nullptr};
  auto go = [&](auto d) {
    return launch_fwd<decltype(d)::value, false>(
        q, k, v, o, static_cast<float*>(lse),
        static_cast<const float*>(kn), static_cast<const int*>(pred),
        static_cast<int*>(bound_count), causal, B, H, Hkv, S, scale, layout,
        static_cast<cudaStream_t>(stream));
  };
  if (D == 64) return go(std::integral_constant<int, 64>{});
  if (D == 128) return go(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// The fragment test (frag_test_kernel): n is 64 or 128.
extern "C" int taper_wgmma_frag_test(const void* a, const void* b,
                                     const void* c, void* out, void* rmax,
                                     void* rsum, int n, void* stream) {
  using namespace taper::flash::sm90;
  auto bf = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* mx = static_cast<float*>(rmax);
  float* sum = static_cast<float*>(rsum);
  if (n == 64)
    frag_test_kernel<64><<<1, 128, 0, s>>>(bf(a), bf(b), bf(c), o, mx, sum);
  else if (n == 128)
    frag_test_kernel<128><<<1, 128, 0, s>>>(bf(a), bf(b), bf(c), o, mx, sum);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
