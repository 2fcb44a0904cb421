// Flash attention backward in f32 on the CUDA cores: K6 (dQ), K7 (dK, dV)
// and K11 (K7 per query head), the kernels that every f32 call of
// taper_flash_dq, taper_flash_dkv and taper_flash_dkv_t (csrc/flash_bwd.cu)
// runs, under every mask that
// flash_common.cuh's Mask takes (causal, a window, segment ids), in both
// layouts (Layout strides), with GQA read natively and any S.
//
// Replaces, in f32, three backward TPU kernels of
// taper_tpu/ops/pallas/attention.py, launched by _flash_bwd_impl:
//   * dq_f32_kernel (K6, _dq_kernel): per query tile, delta = rowsum(dO *
//     O), exported for K7 (JAX also subtracts an lse cotangent there, which
//     only its flash_attention_lse has); then over the band of KV tiles
//     the mask leaves, p = exp2(s * scale_log2 - lse2) with s = Q K^T,
//     ds = p * (dO V^T - delta), dQ += ds K; the scale is applied once at
//     the end.
//   * dkv_f32_kernel (K7, _dkv_kernel): per KV tile, over the band of
//     query tiles and the query heads of its GQA group, on transposed
//     tiles (s^T = K Q^T), p^T, dV += p^T dO, dp^T = V dO^T, ds^T = p^T
//     (dp^T - delta), dK += ds^T Q; dK is scaled once at the end.  The
//     group's query heads sum into the same registers in a fixed order: no
//     partials at query-head width, no atomics, the same bits on every run
//     (JAX sums per-head partials after its kernel).
//   * dkv_f32_kernel<.., PER_HEAD = true> (K11, _dkv_kernel_t, opt-in
//     under TAPER_ATTN_DKV_T=1 for non-causal or windowed masks without
//     segment ids): K7's sweep over one query head's tiles, a block a
//     (batch * query head, KV tile), its dK and dV written as f32 partials
//     [B, H, S, D], which ops/attention.py::group_sum adds over each group,
//     as JAX sums after its kernel.
// The port keeps TF32 off (ops/backend.py), so every product is an FMA
// loop.
//
// What bounds them on the H100: FMA work, 3 (K6) and 4 (K7) products of 2
// D flops over each live (row, column) pair, against 67 TFLOP/s; device
// memory (q, k, v, o, do and the gradients, O(S * D) per head) is smaller
// except at short S, where the sort task's shape (B 64, H 2, S 128, D 64)
// is bound by its bytes and, in practice, by the latency of a short chain
// of tiles.  What the design does about that:
//   * register-tiled products: 128 threads as 16 row groups (ty) by 8
//     column groups (tx); a thread owns RT rows (ty + 16 i) by CT columns
//     (tx + 8 j) of s and dp (of s^T and dp^T in K7), at the same
//     positions, and RT rows by D / 8 columns (16-byte chunks tx + 8 g) of
//     dQ (of dK and dV), which stay in registers for the whole sweep.  A
//     16-byte shared load feeds 8-16 FMAs (4 d of one row against the
//     thread's rows or columns of the other operand); the rows of a
//     warp's broadcast loads are consecutive and a tile row is D + 4
//     floats, an odd number of 16-byte bank groups, so that 8 lanes
//     reading 8 rows at one d hit 8 distinct groups;
//   * p and ds (p^T and ds^T) are formed in registers by the thread that
//     computed s and dp there, and pass through shared memory once a tile,
//     for the next product, read back only by the 8 lanes that wrote them
//     (a warp barrier, no block barrier);
//   * a two-stage cp.async ring: K6 streams 32-row K/V tiles with their
//     segment ids past resident Q and dO tiles; K7 streams 32-row Q/dO
//     tiles with their rows' lse, delta and segment ids past resident K and
//     V tiles, over the band and the group's heads; the next tile's copy is
//     in flight during this one's products;
//   * K6's delta from the staged dO rows and O's rows read 16 bytes wide,
//     each lane its chunks in order, then a butterfly over the row's 8 lanes;
//   * tiles sized so that two blocks fit an SM (77-109 KB of shared memory),
//     and where those leave SMs idle (few heads, long rows: the windowed
//     shape's 64 KV tiles) 32-row tiles and two thread groups of 128 taking
//     every other tile of the sweep, each with its own stages and partial
//     sums, merged at the end in group order (the same bits on every call);
//   * the band of tiles the mask leaves, the longest sweeps first, per-entry
//     tests only on tiles that the diagonal, the window's edge, the ragged
//     end or segment ids reach into; a tile pair whose segment-id ranges
//     cannot meet is skipped whole; a fully masked row's lse = -inf gets a
//     finite stand-in (its weights are masked to 0 either way).
#include "flash_common.cuh"

namespace taper {
namespace flash {

// K6's tiles: BQ = 16 * RT query rows a block, 32-row KV tiles.  Shared
// memory: the Q and dO tiles, two stages of (K tile, V tile, the tile's
// segment ids) and dS, the last two per thread group.
template <int D, int RT, int KVG>
struct DqF32 {
  static constexpr int NT = kThreads * KVG;
  static constexpr int BQ = 16 * RT, BKV = 32;
  static constexpr int CT = BKV / 8, DT = D / 8;
  static constexpr int LD = D + 4;     // a staged q, do, k or v row
  static constexpr int LDS = BKV + 4;  // a row of dS
  static constexpr size_t tile = sizeof(float) * BQ * LD;
  static constexpr size_t kv_off = 2 * tile;
  static constexpr size_t stage =
      sizeof(float) * 2 * BKV * LD + sizeof(int) * BKV;
  static constexpr size_t ds_off = kv_off + KVG * 2 * stage;
  static constexpr size_t ds_size = sizeof(float) * BQ * LDS;
  static constexpr size_t bytes = ds_off + KVG * ds_size;
  // group 1's dQ for the merge, in its stages
  static_assert(sizeof(float) * RT * DT * kThreads <= 2 * stage, "");
};

// K7's tiles: BK = 16 * RT KV rows a block, 32-row query tiles.  Shared
// memory: the K and V tiles, two stages of (Q tile, dO tile, the rows'
// lse, delta and segment ids) and p^T and ds^T, the last two per group.
template <int D, int RT, int KVG>
struct DkvF32 {
  static constexpr int NT = kThreads * KVG;
  static constexpr int BK = 16 * RT, BQ = 32;
  static constexpr int CT = BQ / 8, DT = D / 8;
  static constexpr int LD = D + 4;
  static constexpr int LDW = BQ + 4;  // a row of p^T or ds^T
  static constexpr size_t tile = sizeof(float) * BK * LD;
  static constexpr size_t st_off = 2 * tile;
  static constexpr size_t stage = sizeof(float) * (2 * BQ * LD + 3 * BQ);
  static constexpr size_t w_off = st_off + KVG * 2 * stage;
  static constexpr size_t w_size = sizeof(float) * 2 * BK * LDW;
  static constexpr size_t bytes = w_off + KVG * w_size;
  // group 1's dK and dV for the merge, in its stages
  static_assert(sizeof(float) * 2 * RT * DT * kThreads <= 2 * stage, "");
};

// The blocks an SM holds, as the shared memory allows them: two of one
// group, one of two.  Told to ptxas, so that it does not cap registers for
// an occupancy the tiles cannot reach (and spill).
template <int KVG>
constexpr int kMinBlocks = KVG == 1 ? 2 : 1;

// acc[i][e] += a[i].cc * B[row][chunks tx + 8 g] for one row of a staged
// tile (LD floats a row): the rank-1 update of the thread's RT x D/8 block
// by lane cc of the thread's float4 of each of its rows of A.
template <int RT, int DT>
__device__ __forceinline__ void row_update(float (&acc)[RT][DT],
                                           const float4 (&a)[RT], int cc,
                                           const float* row, int tx) {
  float bv[DT];
#pragma unroll
  for (int g = 0; g < DT / 4; ++g) {
    const float4 x =
        *reinterpret_cast<const float4*>(row + (g * 8 + tx) * 4);
    bv[4 * g] = x.x, bv[4 * g + 1] = x.y, bv[4 * g + 2] = x.z,
           bv[4 * g + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float ai = cc == 0 ? a[i].x : cc == 1 ? a[i].y
                   : cc == 2 ? a[i].z : a[i].w;
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = fmaf(ai, bv[e], acc[i][e]);
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 8 j] over D for two staged tiles.
template <int D, int RT, int CT, int LD>
__device__ __forceinline__ void tile_scores(float (&s)[RT][CT],
                                            const float* A, const float* B,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RT], b[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < CT; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// The rows of a thread's RT x D/8 block, times `scale`, to rows row0 + ty
// + 16 i of one head (row stride `ld`), skipping rows past S.
template <int RT, int DT>
__device__ __forceinline__ void store_block(float* out, long long ld,
                                           const float (&acc)[RT][DT],
                                           int row0, int S, float scale,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < DT / 4; ++g)
      *reinterpret_cast<float4*>(out + row * ld + (g * 8 + tx) * 4) =
          make_float4(acc[i][4 * g] * scale, acc[i][4 * g + 1] * scale,
                      acc[i][4 * g + 2] * scale, acc[i][4 * g + 3] * scale);
  }
}

// K6.  Block (x, y): batch-head x, query tile y (reversed under a causal
// mask, so that the longest rows start first; a window without causality
// has its longest rows first already).  With KVG = 2 two groups of 128
// threads take the band's KV tiles in turn and group 0 adds group 1's dQ
// at the end.
template <int D, int RT, int KVG, bool MASKED>
__global__ void __launch_bounds__(kThreads * KVG, kMinBlocks<KVG>)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dq,
                  float* __restrict__ delta, Layout lay, int causal,
                  int window, const int* __restrict__ seg, int H, int Hkv,
                  int S, float scale, float scale_log2) {
  using P = DqF32<D, RT, KVG>;
  constexpr int BQ = P::BQ, BKV = P::BKV, CT = P::CT, DT = P::DT;
  constexpr int LD = P::LD, LDS = P::LDS;
  const Mask mask{causal, window, seg};  // see Mask
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int sq_s[BQ];
  const int gi = KVG == 1 ? 0 : threadIdx.x / kThreads;
  const int lt = KVG == 1 ? threadIdx.x : threadIdx.x % kThreads;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = reinterpret_cast<float*>(smem + P::tile);
  float* dSs = reinterpret_cast<float*>(smem + P::ds_off + gi * P::ds_size);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tx = lt % 8, ty = lt / 8;
  const long long qoff = b * lay.qb + h * lay.qh;
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

  rows_async<BQ, D, LD, P::NT>(Qs, q + qoff, lay.qs, q0, S, threadIdx.x);
  rows_async<BQ, D, LD, P::NT>(dOs, dout + qoff, lay.qs, q0, S,
                               threadIdx.x);
  cp_async_commit();
  if (gi < n_tiles) load_kv(gi, 0);
  cp_async_commit();
  if (has_ids<MASKED>(mask))
    for (int i = threadIdx.x; i < BQ; i += P::NT)
      sq_s[i] = q0 + i < S ? seg[(size_t)b * S + q0 + i] : -1;
  // lse in base 2 (a fully masked row's -inf becomes a finite stand-in:
  // its weights are masked to 0 anyway)
  float lse2[RT], dl[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l = row < S ? lse[(size_t)bh * S + row] : 0.0f;
    lse2[i] = isfinite(l) ? l * kLog2e : 0.0f;
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();     // ... for every thread; the ids are in
  int sq[RT];
  int2 q_ids = make_int2(0, 0);
  if (has_ids<MASKED>(mask)) {
#pragma unroll
    for (int i = 0; i < RT; ++i) sq[i] = sq_s[ty + 16 * i];
    q_ids = id_range(sq_s, BQ);
  }
  // delta = rowsum(dO * O): each lane its 16-byte chunks of the row in
  // order, then a butterfly over the row's 8 lanes (every lane gets the
  // same bits); group 0 exports it for K7
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    float acc = 0.0f;
    if (row < S)
#pragma unroll
      for (int g = 0; g < DT / 4; ++g) {
        const int d = (g * 8 + tx) * 4;
        const float4 x = *reinterpret_cast<const float4*>(dOs + r * LD + d);
        const float4 y =
            *reinterpret_cast<const float4*>(o + qoff + row * lay.qs + d);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dl[i] = acc;
    if (gi == 0 && tx == 0 && row < S) delta[(size_t)bh * S + row] = acc;
  }

  float acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = 0.0f;
  for (int i = 0, t = gi; t < n_tiles; ++i, t += KVG) {
    if (t + KVG < n_tiles) load_kv(t + KVG, i + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed
    group_sync<KVG>(gi);  // ... for every thread of the group
    const float* Ks = kv_stage(i);
    const float* Vs = Ks + BKV * LD;
    const int* ids = reinterpret_cast<const int*>(Vs + BKV * LD);
    const int kv0 = lo + t * BKV;
    bool skip = false;
    if (has_ids<MASKED>(mask)) {  // no shared document: a whole-tile skip
      const int2 k_ids = id_range(ids, BKV);
      skip = q_ids.x > k_ids.y || k_ids.x > q_ids.y;
    }
    if (!skip) {
      float s[RT][CT], dp[RT][CT];
      tile_scores<D, RT, CT, LD>(s, Qs, Ks, ty, tx);    // Q K^T
      tile_scores<D, RT, CT, LD>(dp, dOs, Vs, ty, tx);  // dO V^T
      // a tile needs the per-entry tests where the ragged edge, the
      // diagonal, the window's lower edge or segment ids reach into it; a
      // masked pair has p = 0, so it adds nothing to dS
      const bool edge = kv0 + BKV > S || (causal && kv0 + BKV - 1 > q0) ||
                        (MASKED && window > 0 && kv0 < q0 + BQ - window) ||
                        has_ids<MASKED>(mask);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int c = tx + 8 * j, col = kv0 + c;
          const bool ok =
              !edge || (col < S && keep<MASKED>(mask, row, col) &&
                        (!has_ids<MASKED>(mask) || sq[i] == ids[c]));
          const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.0f;
          dSs[(ty + 16 * i) * LDS + c] = p * (dp[i][j] - dl[i]);
        }
      }
      __syncwarp();  // the row's 8 lanes have written dS

      // dQ += dS K
#pragma unroll 2
      for (int c = 0; c < BKV; c += 4) {
        float4 da[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          da[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * LDS +
                                                   c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          row_update(acc, da, cc, Ks + (c + cc) * LD, tx);
      }
    }
    group_sync<KVG>(gi);  // the group is done with stage i and dS
  }
  cp_async_wait<0>();
  if constexpr (KVG > 1) {
    // group 1 hands its dQ to group 0 through group 1's stages
    float* red = reinterpret_cast<float*>(smem + P::kv_off + 2 * P::stage);
    __syncthreads();
    if (gi == 1)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < DT; ++e)
          red[(i * DT + e) * kThreads + lt] = acc[i][e];
    __syncthreads();
    if (gi == 1) return;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < DT; ++e)
        acc[i][e] += red[(i * DT + e) * kThreads + lt];
  }
  store_block(dq + qoff, lay.qs, acc, q0, S, scale, ty, tx);
}

// K7.  Block (x, y): batch-KV head x, KV tile y (the tiles that the most
// query rows see first: the first ones under causality, the last under a
// window without it).  The sweep runs over the group's (head, query tile)
// pairs, head by head; with KVG = 2 two groups of 128 threads take every
// other pair and group 0 adds group 1's dK and dV at the end.  K11
// (PER_HEAD): block x is a batch-query head, the sweep covers that head
// alone, and dk, dv are its f32 partials [B, H, S, D].
template <int D, int RT, int KVG, bool MASKED, bool PER_HEAD>
__global__ void __launch_bounds__(kThreads * KVG, kMinBlocks<KVG>)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, Layout lay, int causal,
                   int window, const int* __restrict__ seg, int H, int Hkv,
                   int S, float scale, float scale_log2) {
  using P = DkvF32<D, RT, KVG>;
  constexpr int BK = P::BK, BQ = P::BQ, CT = P::CT, DT = P::DT;
  constexpr int LD = P::LD, LDW = P::LDW;
  const Mask mask{causal, window, seg};  // see Mask
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int sk_s[BK];
  const int gi = KVG == 1 ? 0 : threadIdx.x / kThreads;
  const int lt = KVG == 1 ? threadIdx.x : threadIdx.x % kThreads;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + P::tile);
  float* Pt = reinterpret_cast<float*>(smem + P::w_off + gi * P::w_size);
  float* DSt = Pt + BK * LDW;

  const int group = H / Hkv, heads = PER_HEAD ? H : Hkv;
  const int b = blockIdx.x / heads;
  const int hk = PER_HEAD ? blockIdx.x % H / group : blockIdx.x % Hkv;
  // the sweep's query heads: the group's g0 .. g0 + n_g - 1 (K11: the
  // block's own)
  const int g0 = PER_HEAD ? blockIdx.x % H % group : 0;
  const int n_g = PER_HEAD ? 1 : group;
  const bool rev = MASKED && !causal && window > 0;
  const int kv0 = (rev ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BK;
  const int tx = lt % 8, ty = lt / 8;
  const long long koff = b * lay.kb + hk * lay.kh;

  // the band of query tiles: from the diagonal (0 without causality) to
  // the window's upper edge, or to S without a window
  const int q_lo = causal ? kv0 : 0;
  const int q_hi = MASKED && window > 0 ? min(S, kv0 + BK - 1 + window) : S;
  const int n_q = (q_hi - q_lo + BQ - 1) / BQ;
  const int total = n_g * n_q;  // (head, query tile) pairs, head-major
  auto q_stage = [&](int i) {
    return reinterpret_cast<float*>(smem + P::st_off +
                                    (2 * gi + (i & 1)) * P::stage);
  };
  auto load_q = [&](int t, int i) {
    float* Qs = q_stage(i);
    const int h = hk * group + g0 + t / n_q, q0 = q_lo + (t % n_q) * BQ;
    const long long qoff = b * lay.qb + h * lay.qh;
    const size_t roff = (size_t)(b * H + h) * S;
    rows_async<BQ, D, LD, kThreads>(Qs, q + qoff, lay.qs, q0, S, lt);
    rows_async<BQ, D, LD, kThreads>(Qs + BQ * LD, dout + qoff, lay.qs, q0,
                                    S, lt);
    float* rows = Qs + 2 * BQ * LD;  // lse, delta, ids; zeros past S
    for (int r = lt; r < BQ; r += kThreads) {
      const bool in = q0 + r < S;
      const int at = in ? q0 + r : 0;
      cp_async4(rows + r, lse + roff + at, in);
      cp_async4(rows + BQ + r, delta + roff + at, in);
      if (has_ids<MASKED>(mask))
        cp_async4(rows + 2 * BQ + r,
                  reinterpret_cast<const float*>(seg + (size_t)b * S + at),
                  in);
    }
  };

  rows_async<BK, D, LD, P::NT>(Ks, k + koff, lay.ks, kv0, S, threadIdx.x);
  rows_async<BK, D, LD, P::NT>(Vs, v + koff, lay.ks, kv0, S, threadIdx.x);
  cp_async_commit();
  if (gi < total) load_q(gi, 0);
  cp_async_commit();
  if (has_ids<MASKED>(mask))
    for (int i = threadIdx.x; i < BK; i += P::NT)
      sk_s[i] = kv0 + i < S ? seg[(size_t)b * S + kv0 + i] : -1;
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();     // ... for every thread; the ids are in
  int sk[RT];
  int2 k_ids = make_int2(0, 0);
  if (has_ids<MASKED>(mask)) {
#pragma unroll
    for (int i = 0; i < RT; ++i) sk[i] = sk_s[ty + 16 * i];
    k_ids = id_range(sk_s, BK);
  }

  float dka[RT][DT], dva[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < DT; ++e) dka[i][e] = dva[i][e] = 0.0f;
  for (int i = 0, t = gi; t < total; ++i, t += KVG) {
    if (t + KVG < total) load_q(t + KVG, i + 1);
    cp_async_commit();
    cp_async_wait<1>();   // pair t's query tile has landed
    group_sync<KVG>(gi);  // ... for every thread of the group
    const float* Qs = q_stage(i);
    const float* dOs = Qs + BQ * LD;
    const float* lse_s = dOs + BQ * LD;
    const float* delta_s = lse_s + BQ;
    const int* ids = reinterpret_cast<const int*>(delta_s + BQ);
    const int q0 = q_lo + (t % n_q) * BQ;
    bool skip = false;
    if (has_ids<MASKED>(mask)) {  // no shared document: a whole-pair skip
      const int2 q_ids = id_range(ids, BQ);
      skip = k_ids.x > q_ids.y || q_ids.x > k_ids.y;
    }
    if (!skip) {
      float s[RT][CT], dp[RT][CT];
      tile_scores<D, RT, CT, LD>(s, Ks, Qs, ty, tx);    // K Q^T
      tile_scores<D, RT, CT, LD>(dp, Vs, dOs, ty, tx);  // V dO^T
      const bool edge = kv0 + BK > S || q0 + BQ > S ||
                        (causal && kv0 + BK - 1 > q0) ||
                        (MASKED && window > 0 && kv0 < q0 + BQ - window) ||
                        has_ids<MASKED>(mask);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = tx + 8 * j, qrow = q0 + c;
        const float l = lse_s[c], dl = delta_s[c];
        const float l2 = isfinite(l) ? l * kLog2e : 0.0f;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int kv = kv0 + ty + 16 * i;
          const bool ok =
              !edge || (kv < S && qrow < S && keep<MASKED>(mask, qrow, kv) &&
                        (!has_ids<MASKED>(mask) || sk[i] == ids[c]));
          const float p = ok ? exp2f(s[i][j] * scale_log2 - l2) : 0.0f;
          Pt[(ty + 16 * i) * LDW + c] = p;
          DSt[(ty + 16 * i) * LDW + c] = p * (dp[i][j] - dl);
        }
      }
      __syncwarp();  // the row's 8 lanes have written p^T and ds^T

      // dV += p^T dO, dK += ds^T Q
#pragma unroll 2
      for (int c = 0; c < BQ; c += 4) {
        float4 pa[RT], sa[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          pa[i] = *reinterpret_cast<const float4*>(Pt + (ty + 16 * i) * LDW +
                                                   c);
          sa[i] = *reinterpret_cast<const float4*>(DSt + (ty + 16 * i) * LDW +
                                                   c);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          row_update(dva, pa, cc, dOs + (c + cc) * LD, tx);
          row_update(dka, sa, cc, Qs + (c + cc) * LD, tx);
        }
      }
    }
    group_sync<KVG>(gi);  // the group is done with stage i, p^T and ds^T
  }
  cp_async_wait<0>();
  if constexpr (KVG > 1) {
    // group 1 hands its dK and dV to group 0 through group 1's stages
    float* red = reinterpret_cast<float*>(smem + P::st_off + 2 * P::stage);
    __syncthreads();
    if (gi == 1)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          red[(i * DT + e) * kThreads + lt] = dka[i][e];
          red[((RT + i) * DT + e) * kThreads + lt] = dva[i][e];
        }
    __syncthreads();
    if (gi == 1) return;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < DT; ++e) {
        dka[i][e] += red[(i * DT + e) * kThreads + lt];
        dva[i][e] += red[((RT + i) * DT + e) * kThreads + lt];
      }
  }
  if constexpr (PER_HEAD) {
    const size_t off = ((size_t)b * H + hk * group + g0) * S * D;
    store_block(dk + off, D, dka, kv0, S, scale, ty, tx);
    store_block(dv + off, D, dva, kv0, S, 1.0f, ty, tx);
  } else {
    store_block(dk + koff, lay.ks, dka, kv0, S, scale, ty, tx);
    store_block(dv + koff, lay.ks, dva, kv0, S, 1.0f, ty, tx);
  }
}

template <int D, int RT, int KVG, bool MASKED>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, void* dq, float* delta,
                  int B, int H, int Hkv, int S, float scale, const Mask& m,
                  int layout, cudaStream_t stream) {
  using P = DqF32<D, RT, KVG>;
  auto kernel = dq_f32_kernel<D, RT, KVG, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + P::BQ - 1) / P::BQ);
  kernel<<<grid, P::NT, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, static_cast<float*>(dq), delta,
      make_layout(layout, H, Hkv, S, D), m.causal, m.window, m.seg, H, Hkv,
      S, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D, int RT, int KVG, bool MASKED, bool PER_HEAD>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int S,
                   float scale, const Mask& m, int layout,
                   cudaStream_t stream) {
  using P = DkvF32<D, RT, KVG>;
  auto kernel = dkv_f32_kernel<D, RT, KVG, MASKED, PER_HEAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * (PER_HEAD ? H : Hkv), (S + P::BK - 1) / P::BK);
  kernel<<<grid, P::NT, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv),
      make_layout(layout, H, Hkv, S, D), m.causal, m.window, m.seg, H, Hkv,
      S, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// One instantiation's tile: RT rows a thread, KVG thread groups.
template <int RT_, int KVG_, bool MASKED_>
struct Tile {
  static constexpr int RT = RT_, KVG = KVG_;
  static constexpr bool MASKED = MASKED_;
};

// Calls f(Tile<...>{}) with 64-row tiles at D 32 and 64 (32-row ones at D 128,
// where 64 would not let two blocks share an SM) where they give every SM
// a block, else 32-row tiles with two thread groups (twice the blocks,
// each with twice the threads on its sweep).  `units` is B * H for K6 and
// K11, B * Hkv for K7.
template <int D, typename F>
int by_tile(long long units, int S, const Mask& m, F&& f) {
  constexpr int RT = D == 128 ? 2 : 4;
  const bool wide = units * ((S + 16 * RT - 1) / (16 * RT)) >= sm_count();
  if (masked(m))
    return wide ? f(Tile<RT, 1, true>{}) : f(Tile<2, 2, true>{});
  return wide ? f(Tile<RT, 1, false>{}) : f(Tile<2, 2, false>{});
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, float* delta,
           const Mask& m, int B, int H, int Hkv, int S, float scale,
           int layout, cudaStream_t stream) {
  return by_tile<D>((long long)B * H, S, m, [&](auto t) {
    using C = decltype(t);
    return launch_dq_f32<D, C::RT, C::KVG, C::MASKED>(
        q, k, v, o, dout, lse, dq, delta, B, H, Hkv, S, scale, m, layout,
        stream);
  });
}

template <int D, bool PER_HEAD>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            const Mask& m, int B, int H, int Hkv, int S, float scale,
            int layout, cudaStream_t stream) {
  return by_tile<D>((long long)B * (PER_HEAD ? H : Hkv), S, m, [&](auto t) {
    using C = decltype(t);
    return launch_dkv_f32<D, C::RT, C::KVG, C::MASKED, PER_HEAD>(
        q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, scale, m, layout,
        stream);
  });
}

// K6 in f32 (taper_flash_dq's f32 calls).
int flash_dq_f32(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, float* delta,
                 const Mask& m, int B, int H, int Hkv, int S, int D,
                 float scale, int layout, cudaStream_t stream) {
  if (D == 32)
    return dq_f32<32>(q, k, v, o, dout, lse, dq, delta, m, B, H, Hkv, S,
                      scale, layout, stream);
  if (D == 64)
    return dq_f32<64>(q, k, v, o, dout, lse, dq, delta, m, B, H, Hkv, S,
                      scale, layout, stream);
  if (D == 128)
    return dq_f32<128>(q, k, v, o, dout, lse, dq, delta, m, B, H, Hkv, S,
                       scale, layout, stream);
  return (int)cudaErrorInvalidValue;
}

// K7 in f32 (taper_flash_dkv's f32 calls), after K6 (its delta).
int flash_dkv_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const Mask& m, int B, int H, int Hkv,
                  int S, int D, float scale, int layout,
                  cudaStream_t stream) {
  if (D == 32)
    return dkv_f32<32, false>(q, k, v, dout, lse, delta, dk, dv, m, B, H,
                              Hkv, S, scale, layout, stream);
  if (D == 64)
    return dkv_f32<64, false>(q, k, v, dout, lse, delta, dk, dv, m, B, H,
                              Hkv, S, scale, layout, stream);
  if (D == 128)
    return dkv_f32<128, false>(q, k, v, dout, lse, delta, dk, dv, m, B, H,
                               Hkv, S, scale, layout, stream);
  return (int)cudaErrorInvalidValue;
}

// K11 in f32 (taper_flash_dkv_t's f32 calls), after K6: dk_part, dv_part
// [B, H, S, D].
int flash_dkv_t_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dk_part, float* dv_part, const Mask& m, int B,
                    int H, int Hkv, int S, int D, float scale, int layout,
                    cudaStream_t stream) {
  if (D == 32)
    return dkv_f32<32, true>(q, k, v, dout, lse, delta, dk_part, dv_part, m,
                             B, H, Hkv, S, scale, layout, stream);
  if (D == 64)
    return dkv_f32<64, true>(q, k, v, dout, lse, delta, dk_part, dv_part, m,
                             B, H, Hkv, S, scale, layout, stream);
  if (D == 128)
    return dkv_f32<128, true>(q, k, v, dout, lse, delta, dk_part, dv_part,
                              m, B, H, Hkv, S, scale, layout, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace taper
