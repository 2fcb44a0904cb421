// Flash attention backward on Hopper: K6, dQ, in bf16 at D 64 or 128, on a
// TMA ring of K/V tiles and warpgroup MMA (wgmma) with the scores, the
// weights and dS in registers.
//
// Replaces, for bf16 operands (16-byte aligned, as TMA needs and
// ops/backend.py::check_kernel_args demands of every launch; K6 in f32
// runs flash_bwd.cu's FMA kernel):
//   * taper_tpu/ops/pallas/attention.py::_dq_kernel (K6, launched by
//     _flash_bwd_impl): for one query tile over the band of KV tiles that
//     its mask leaves (causal, a sliding window, segment ids), p = exp(s -
//     lse), ds = p (dO V^T - delta), dQ += ds K with ds cast to bf16 before
//     its product, the scale applied once at the end; and delta =
//     rowsum(dO O) of its rows, exported for K7 and K11 (JAX also subtracts
//     an lse cotangent there, which only its flash_attention_lse has).
//
// What bounds it on the H100: tensor-core work, three products of 2 S^2 D
// a head (Q K^T, dO V^T, dS K), halved by causality: at the 170M shape (B
// 8, H 8, S 2048, D 128) 1.0e11 FLOP, 104 us at 989 TFLOP/s; device memory
// traffic is O(S D) a head.  The first design (flash_bwd.cu's WMMA kernel:
// 16 x 16 tiles, both score tiles and dS round-tripped through shared
// memory, synchronous K/V loads) ran at ~1/14 of it.  What the design does about that, on K8's
// loop (flash_sm90.cu) with dO beside Q:
//   * a block is a producer warpgroup and two consumer warpgroups of 64
//     query rows each (128 rows a block); the block's Q and dO tiles are
//     loaded once by TMA and stay; one producer warp keeps a ring of K and
//     V tiles of 64 rows filled by TMA (3 stages at D 128, 4 at D 64), with
//     each tile's segment ids, their range and whether the block skips it
//     (the loads are then not issued), each stage released by an "empty"
//     mbarrier;
//   * per KV tile a consumer issues s = Q K^T and dp = dO V^T together (SS
//     wgmma, every operand K-major along D), forms p = exp2(s scale log2(e)
//     - lse) and ds = p (dp - delta) in registers, masking from each
//     element's (row, col) only on the tiles that need it (the diagonal, a
//     window's edges, ragged S, segment ids), and adds ds K by an RS wgmma
//     with ds as the bf16 A operand (hopper.cuh, acc_to_a) and K read
//     N-major: the same operand form as K8's o += p v;
//   * dQ stays in registers for the whole sweep; the epilogue casts dQ
//     scale to bf16 over the warpgroup's own Q rows (which only its wgmma
//     read) and hands them to one TMA store, which drops rows past S;
//   * tiles outside the band, and tiles whose segment-id range cannot meet
//     the warpgroup's, are skipped; the grid takes heads fastest with the
//     longest query tiles (causal) first;
//   * delta is summed by the consumer warps from O and dO in device memory
//     while the first tiles land, 8 rows' loads in flight a warp, through
//     flash_common.cuh's DeltaTerms, so K10's pre-pass (row_delta) gives
//     the same bits.
// Both masks are instantiations: MASKED = false takes a causal mask or none
// and compiles the window and segment tests away (flash_common.cuh, Mask).
#include <climits>

#include "flash_sm90.cuh"

namespace taper {
namespace flash {
namespace sm90 {

// What a stage holds beside its K and V tiles, written by the producer
// warp: the tile's 64 KV rows' segment ids (-1 past S), their range, and
// whether the block skips the tile (no shared document).
struct DqSlot {
  int ids[64];
  int lo, hi, skip, pad;
};

template <int D>
struct DqTiles {
  static constexpr int BM = 128;                 // query rows a block
  static constexpr int BN = 64;                  // KV rows a tile
  static constexpr int Q_BYTES = BM * D * 2;     // Q or dO
  static constexpr int KV_BYTES = BN * D * 2;    // one K or V tile
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGE_OFF = 2 * Q_BYTES;
  static constexpr int SLOT_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int RANGE_OFF = SLOT_OFF + STAGES * (int)sizeof(DqSlot);
  static constexpr int BAR_OFF = RANGE_OFF + 2 * 4 * 2 * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// One block a (batch * head, 128-row query tile), the longest rows first.
// ``tq``/``tdo``: boxes of 128 rows; ``tk``/``tv``: 64; ``tdq``: 64.
template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tdq,
              const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              int causal, int window, const int* __restrict__ seg, int H,
              int Hkv, int S, int layout, float scale, float scale_log2) {
  const Mask mask{causal, window, seg};  // see Mask
  using P = DqTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + P::Q_BYTES;
  DqSlot* slots = reinterpret_cast<DqSlot*>(smem + P::SLOT_OFF);
  int* ranges = reinterpret_cast<int*>(smem + P::RANGE_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + P::STAGES;

  // heads fastest, so that every head's longest rows go first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P::BM;
  // the band of KV tiles the block's 128 rows see
  const int kv_lo = kv_begin<MASKED>(mask, q0);
  const int kv_hi = causal ? min(S, q0 + P::BM) : S;
  const int n_kv = kv_hi > kv_lo ? (kv_hi - kv_lo + P::BN - 1) / P::BN : 0;
  const HeadAt qat = head_at(layout, b, H, h, D);
  const HeadAt kat = head_at(layout, b, Hkv, hk, D);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp; lane 0 issues the TMA loads, every lane writes
    // two KV rows' ids and arrives
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch_desc(&tk);
      tma_prefetch_desc(&tv);
      mbar_expect_tx(q_full, 2 * P::Q_BYTES);
      load_tile<D, P::BM>(Qs, &tq, q_full, qat, q0);
      load_tile<D, P::BM>(dOs, &tdo, q_full, qat, q0);
    }
    int qlo = 0, qhi = 0;  // the block's query ids' range
    if (has_ids<MASKED>(mask)) {
      qlo = INT_MAX;
      qhi = INT_MIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + lane + 32 * i;
        const int id = r < S ? seg[(size_t)b * S + r] : -1;
        qlo = min(qlo, id);
        qhi = max(qhi, id);
      }
      qlo = __reduce_min_sync(0xffffffffu, qlo);
      qhi = __reduce_max_sync(0xffffffffu, qhi);
    }
    for (int j = 0; j < n_kv; ++j) {
      const int kv0 = kv_lo + j * P::BN, s = j % P::STAGES;
      if (j >= P::STAGES) mbar_wait(&empty[s], (j / P::STAGES - 1) & 1);
      DqSlot& sl = slots[s];
      bool skip = false;
      if (has_ids<MASKED>(mask)) {
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = lane + 32 * i, r = kv0 + col;
          const int id = r < S ? seg[(size_t)b * S + r] : -1;
          sl.ids[col] = id;
          lo = min(lo, id);
          hi = max(hi, id);
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        skip = !(lo <= qhi && qlo <= hi);  // no shared document
        if (lane == 0) {
          sl.lo = lo;
          sl.hi = hi;
        }
      }
      if (lane == 0) sl.skip = skip;
      if (lane == 0 && !skip) {
        unsigned char* ks = smem + P::STAGE_OFF + s * P::STAGE_BYTES;
        mbar_expect_tx(&full[s], P::STAGE_BYTES);
        load_tile<D, P::BN>(ks, &tk, &full[s], kat, kv0);
        load_tile<D, P::BN>(ks + P::KV_BYTES, &tv, &full[s], kat, kv0);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // query rows [64 c, 64 c + 64) of the block's tile
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r_lo = warp * 16 + lane / 4;
  const int qc = q0 + 64 * c;    // the warpgroup's first query row
  const int row0 = qc + r_lo;    // the thread's rows: row0 and row0 + 8

  // delta of the warp's 16 rows (one warp a row, the order of K10's
  // pre-pass), exported; the thread keeps its two rows' delta and lse (in
  // base 2; a fully masked row's -inf becomes 0, its weights are 0 anyway;
  // rows past S: 0)
  float dl[2] = {0.0f, 0.0f}, lse2[2];
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += 8) {  // 8 rows' loads in flight
    DeltaTerms<__nv_bfloat16, D> t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = min(qc + warp * 16 + i0 + i, S - 1);
      const size_t at = row_at(layout, b, H, h, S, D, row);
      t[i].load(dout + at, o + at);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = qc + warp * 16 + i0 + i;
      const float d = row < S ? t[i].sum() : 0.0f;  // uniform over the warp
      if (i0 + i == lane / 4) dl[0] = d;
      if (i0 + i == lane / 4 + 8) dl[1] = d;
      if (lane == 0 && row < S) delta[(size_t)bh * S + row] = d;
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + 8 * h2;
    const float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
    lse2[h2] = isfinite(l) ? l * kLog2e : 0.0f;
  }
  // the thread's query rows' ids and the warpgroup's range
  int qid0 = 0, qid1 = 0, wlo = 0, whi = 0;
  if (has_ids<MASKED>(mask)) {
    qid0 = row0 < S ? seg[(size_t)b * S + row0] : -1;
    qid1 = row0 + 8 < S ? seg[(size_t)b * S + row0 + 8] : -1;
    const int lo = __reduce_min_sync(0xffffffffu, min(qid0, qid1));
    const int hi = __reduce_max_sync(0xffffffffu, max(qid0, qid1));
    if (lane == 0) {
      ranges[(c * 4 + warp) * 2] = lo;
      ranges[(c * 4 + warp) * 2 + 1] = hi;
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

  const uint32_t qs = smem_u32(Qs), dos = smem_u32(dOs);
  const uint32_t stages = smem_u32(smem + P::STAGE_OFF);
  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.0f;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = kv_lo + j * P::BN, s = j % P::STAGES;
    mbar_wait(&full[s], (j / P::STAGES) & 1);
    const DqSlot& sl = slots[s];
    // the warpgroup's tile adds nothing: masked whole (the far side of the
    // diagonal, behind the window) or no shared document
    bool skip = sl.skip || (causal && kv0 > qc + 63) ||
                (MASKED && window > 0 && kv0 + P::BN - 1 <= qc - window);
    if (has_ids<MASKED>(mask) && !skip)
      skip = !(sl.lo <= whi && wlo <= sl.hi);
    if (skip) {
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t ks = stages + s * P::STAGE_BYTES, vs = ks + P::KV_BYTES;

    // s = Q K^T and dp = dO V^T: the warpgroup's 64 query rows against the
    // tile's 64 KV rows, all operands K-major along D
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(sc, desc_k<P::BM>(qs, 64 * c, kk),
                            desc_k<P::BN>(ks, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(dp, desc_k<P::BM>(dos, 64 * c, kk),
                            desc_k<P::BN>(vs, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(sc);
    fence_frag(dp);

    // p = exp2(s scale log2(e) - lse), masked pairs 0; ds = p (dp - delta)
    // over dp: a row is a query row, a column a KV row
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = sc[e] * scale_log2 - lse2[frag_row(e) / 8];
    const bool edge = kv0 + P::BN > S || (causal && kv0 + P::BN - 1 > qc) ||
                      (MASKED && window > 0 && kv0 <= qc + 63 - window) ||
                      has_ids<MASKED>(mask);
    if (edge)
      mask_frag<64>(sc, row0, kv0, -INFINITY, [&](int r, int col) {
        return col < S && keep<MASKED>(mask, r, col) &&
               (!has_ids<MASKED>(mask) ||
                (r == row0 ? qid0 : qid1) == sl.ids[col - kv0]);
      });
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = exp2_approx(sc[e]) * (dp[e] - dl[frag_row(e) / 8]);
    // ds as the bf16 A operand (cast to Q's dtype, as JAX's kernel does)
    uint32_t dsa[4][4];
    acc_to_a<64>(dp, dsa);

    // dQ += ds K, K read N-major (its rows are the product's K)
    fence_frag(dq);
    fence_frag(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BN / 16; ++kk) {
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(dq, dsa[kk], desc_n<P::BN>(ks, kk), 1);
      else
        wgmma_m64n64k16_rs<1>(dq, dsa[kk], desc_n<P::BN>(ks, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(dq);
    fence_frag(dsa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: dQ scale in bf16 over the warpgroup's own Q rows (which only
  // its wgmma read), then one TMA store of its 64 rows
  named_bar_sync(1 + c, 128);
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = 64 * c + r_lo + frag_row(e), col = frag_col(e, quad);
    *reinterpret_cast<uint32_t*>(Qs + (col / 64) * P::BM * 128 +
                                 sw128_offset(r, col % 64)) =
        pack_bf16x2(dq[e] * scale, dq[e + 1] * scale);
  }
  fence_proxy_async_smem();
  named_bar_sync(1 + c, 128);
  if (tid == 0) {
    store_rows<D, P::BM>(&tdq, Qs, 64 * c, qat, qc);
    bulk_wait<0>();
  }
}

template <int D, bool MASKED>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, float* delta,
              const int* seg, int B, int H, int Hkv, int S, float scale,
              int causal, int window, int layout, cudaStream_t stream) {
  using P = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = head_desc(&tq, q, layout, B, H, S, D, P::BM);
  if (err == 0) err = head_desc(&tdo, dout, layout, B, H, S, D, P::BM);
  if (err == 0) err = head_desc(&tk, k, layout, B, Hkv, S, D, P::BN);
  if (err == 0) err = head_desc(&tv, v, layout, B, Hkv, S, D, P::BN);
  if (err == 0) err = head_desc(&tdq, dq, layout, B, H, S, D, 64);
  if (err != 0) return err;
  auto kernel = dq_kernel<D, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + P::BM - 1) / P::BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, causal, window,
      seg, H, Hkv, S, layout, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace sm90

int flash_dq_sm90(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, void* dq, float* delta,
                  const Mask& m, int B, int H, int Hkv, int S, int D,
                  float scale, int layout, cudaStream_t stream) {
  return sm90::by_dim_and_mask(D, m, [&](auto d, auto mk) {
    return sm90::launch_dq<decltype(d)::value, decltype(mk)::value>(
        q, k, v, o, dout, lse, dq, delta, m.seg, B, H, Hkv, S, scale,
        m.causal, m.window, layout, stream);
  });
}

}  // namespace flash
}  // namespace taper
