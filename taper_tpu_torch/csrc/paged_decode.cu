// Paged decode attention: one query token per slot against a KV pool
// addressed through per-slot block tables.
//
// Replaces the TPU kernel
// taper_tpu/ops/pallas/paged_attention.py::_make_paged_kernel (launched by
// _pallas_paged).  q [B, kvh, G, D] (GQA folds its G query heads per KV
// head into rows), pools [n_blocks, kvh, bs, D], tables [B, mb] int32,
// lengths [B] int32 -> o [B, kvh, G, D].  Slot b's position p lives in pool
// block tables[b, p / bs] at offset p % bs; positions [0, min(length,
// mb bs)) are read (a frozen row past its table's reach is clamped).  The
// online softmax runs in f32, base 2.
//
// int8 pools (taper_paged_decode_int8; the TPU kernel's quant=True arm):
// pools hold int8 rows with one f32 scale per stored position,
// k_scales/v_scales [n_blocks, kvh, bs], indexed like the rows without
// their D.  q and o stay f32 or bf16.  The int8 -> f32 convert happens in
// registers; the k scale multiplies the scalar score after the dot (s =
// q.k_int8 * scale * k_scale[pos]), and the v scale multiplies the softmax
// weight before it meets the row (acc += (p * v_scale[pos]) * v_int8),
// while the row sum l accumulates the unscaled p: the TPU kernel's order.
//
// What bounds it on the H100: device memory.  Each K/V row is read once
// and used for G dot products, far below the ~295 flop/byte the tensor
// cores need, so the kernel is a streaming read of the live K/V rows: a
// long row of the serving model (4,033 positions of bf16 D 128 on one KV
// head) is 2 MB.  The card's 3.35 TB/s needs tens of KB of loads in
// flight on every SM for the whole call.  What the design does about that:
//   * the positions of a row are split across blocks (flash-decoding):
//     block (head, split) takes the ``chunk`` table entries from split *
//     chunk (ops/paged_attention.py::plan picks splits and chunk from the
//     shape and the SM count; lengths stay on the device).  A split whose
//     chunk lies past its row's length exits at once;
//   * a page's rows are contiguous (bs D elements of one KV head), so a
//     stage of up to ROWS rows of K and of V (32 KB together) is two bulk
//     copies (cp.async.bulk), issued by one thread from the split's table
//     entries (staged in shared memory first) onto a ring of 3 stages with
//     one mbarrier each: 64 KB in flight for each block, two blocks an SM.
//     An int8 pool's scales of the stage follow by 4-byte cp.async, one a
//     thread, which arrive on the same barrier (.noinc);
//   * each of the 8 warps takes positions 4 w.. of a stage, U at a time
//     (fewer at larger G), each lane D/32 elements of a row, read from
//     shared memory as the row lies; scores by FMA and a warp sum, one
//     online-softmax update (f32, exp2f) for the U positions;
//   * the warps' partial (m, l, acc) meet in shared memory in warp order;
//     a split that is its row's only one writes o, else its partial goes
//     to an f32 workspace and paged_decode_merge_kernel (the same entry
//     point, a second launch) merges the splits in split order.  No
//     atomics: a repeated call gives the same bits.
// MMA was not taken: at G <= 8 the work is a few FLOPs a byte, and a bulk
// copy leaves the rows unswizzled, where a fragment load of 8 rows at a
// 128-256 byte stride meets itself in the same banks.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace taper {

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

namespace {

using hopper::bulk_load;
using hopper::cp_async_mbar_arrive;
using hopper::fence_mbar_init;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kStageBytes = 32768;  // a stage's rows of K and V together

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

template <typename T, int VPL>
__device__ __forceinline__ void load_row(float (&out)[VPL], const T* p) {
  using V = typename RowVec<T, VPL>::type;
  V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VPL; ++i) out[i] = to_f32(e[i]);
}

// The shared memory of a split block: the ring of stages (each ROWS rows
// of K, then of V), then (int8) each stage's k and v scales, then the
// split's table entries.  The warps' partial accumulators reuse the ring
// once every stage is consumed.
template <typename P, int D>
struct Ring {
  static constexpr int ROW = D * (int)sizeof(P);  // bytes of a row
  static constexpr int ROWS =
      kStageBytes / (2 * ROW) < 128 ? kStageBytes / (2 * ROW) : 128;
  static constexpr int STAGE = 2 * ROWS * ROW;
  static constexpr int SCALES = kStages * STAGE;  // offset of the scales
  static constexpr int TABLE = SCALES + kStages * 2 * ROWS * 4;
  static_assert(ROWS % kWarps == 0 && ROWS * 2 <= kThreads, "rows");
  static size_t bytes(int chunk) { return TABLE + (size_t)chunk * 4; }
};

// T: q and o (f32 or bf16); P: the pools (T, or int8 with QUANT, where
// ks/vs are the per-position scales; null otherwise).  Block x: head x %
// heads (slot b = head / kvh, KV head h = head % kvh), split x / heads.
template <typename T, typename P, int D, int G, bool QUANT>
__global__ void __launch_bounds__(kThreads, 2)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const P* __restrict__ kp,
                              const P* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              T* __restrict__ o, float* __restrict__ ws,
                              int heads, int kvh, int bs, int mb, int splits,
                              int chunk, float scale_log2) {
  using R = Ring<P, D>;
  constexpr int VPL = D / 32;  // elements of a row per lane
  constexpr int U = G >= 8 ? 1 : G >= 4 ? 2 : 4;  // positions a warp step
  static_assert(kWarps * G * D * 4 <= kStages * R::STAGE, "partials fit");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages];
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  float* scales = reinterpret_cast<float*>(smem + R::SCALES);
  int* tab = reinterpret_cast<int*>(smem + R::TABLE);

  const int head = blockIdx.x % heads, split = blockIdx.x / heads;
  const int b = head / kvh, h = head % kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // positions past the table's reach are never read (a frozen row may run
  // past its reservation; its extra tokens are discarded by the engine)
  const int len = min(lengths[b], mb * bs);
  const int span = chunk * bs;  // positions a split covers
  const int p0 = split * span;
  if (split > 0 && p0 >= len) return;  // past the row: another split's
  const int p1 = min(len, p0 + span);
  const bool alone = len <= span;      // the row's only split writes o
  const int rows_s = min(R::ROWS, bs);  // rows of a stage
  const int per_page = (bs + rows_s - 1) / rows_s;
  const int n = max(p1 - p0, 0);
  const int n_stages =
      n / bs * per_page + (n % bs + rows_s - 1) / rows_s;
  const int pages = (n + bs - 1) / bs;

  for (int i = threadIdx.x; i < pages; i += kThreads)
    tab[i] = tables[(size_t)b * mb + split * chunk + i];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      mbar_init(&full[s], QUANT ? 1 + kThreads : 1);
    fence_mbar_init();
  }
  __syncthreads();

  // the rows of stage j: (first pool row, count, ring slot)
  auto stage_rows = [&](int j, size_t& row0, int& rows) {
    const int lp = j / per_page, off = (j % per_page) * rows_s;
    rows = min(min(rows_s, bs - off), p1 - (p0 + lp * bs + off));
    row0 = ((size_t)tab[lp] * kvh + h) * bs + off;
  };
  auto issue = [&](int j) {  // every thread: the scales are theirs
    const int slot = j % kStages;
    size_t row0;
    int rows;
    stage_rows(j, row0, rows);
    unsigned char* st = smem + slot * R::STAGE;
    if (threadIdx.x == 0) {
      const uint32_t bytes = rows * R::ROW;
      mbar_expect_tx(&full[slot], 2 * bytes);
      bulk_load(st, kp + row0 * D, bytes, &full[slot]);
      bulk_load(st + R::STAGE / 2, vp + row0 * D, bytes, &full[slot]);
    }
    if constexpr (QUANT) {
      float* sc = scales + slot * 2 * R::ROWS;
      const int t = threadIdx.x;
      if (t < rows)
        cp_async4(sc + t, ks + row0 + t, true);
      else if (t < 2 * rows)
        cp_async4(sc + R::ROWS + t - rows, vs + row0 + t - rows, true);
      cp_async_mbar_arrive(&full[slot]);
    }
  };
  for (int j = 0; j < kStages && j < n_stages; ++j) issue(j);

  float qr[G][VPL], acc[G][VPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, VPL>(qr[g], q + ((size_t)head * G + g) * D + lane * VPL);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      qr[g][i] *= scale_log2;
      acc[g][i] = 0.0f;
    }
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }

  for (int j = 0; j < n_stages; ++j) {
    const int slot = j % kStages;
    size_t row0;
    int rows;
    stage_rows(j, row0, rows);
    mbar_wait(&full[slot], (j / kStages) & 1);
    const P* sk = reinterpret_cast<const P*>(smem + slot * R::STAGE);
    const P* sv = sk + R::ROWS * D;
    const float* sks = scales + slot * 2 * R::ROWS;
    const float* svs = sks + R::ROWS;
    for (int r0 = warp * U; r0 < rows; r0 += kWarps * U) {
      float kr[U][VPL], vr[U][VPL], s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + u < rows) {
          load_row<P, VPL>(kr[u], sk + (r0 + u) * D + lane * VPL);
          load_row<P, VPL>(vr[u], sv + (r0 + u) * D + lane * VPL);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.0f;
          if (r0 + u < rows) {
#pragma unroll
            for (int i = 0; i < VPL; ++i) d = fmaf(qr[g][i], kr[u][i], d);
          }
          s[u][g] = d;
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[u][g] = warp_sum(s[u][g]);
          if (QUANT) s[u][g] *= sks[min(r0 + u, rows - 1)];
          if (r0 + u >= rows) s[u][g] = -INFINITY;  // weighs exp2(-inf) = 0
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u][g]);
        // position r0 is valid: m_new is finite
        const float corr = exp2f(m[g] - m_new);
        float pe[U];
        float lsum = 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pe[u] = exp2f(s[u][g] - m_new);
          lsum += pe[u];  // the unscaled weights
        }
        l[g] = fmaf(l[g], corr, lsum);
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          float a = acc[g][i] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (r0 + u < rows) {
              const float pv = QUANT ? pe[u] * svs[r0 + u] : pe[u];
              a = fmaf(pv, vr[u][i], a);
            }
          }
          acc[g][i] = a;
        }
        m[g] = m_new;
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (j + kStages < n_stages) issue(j + kStages);
  }

  // the warps' partials, in the ring (every stage consumed)
  float* sm_acc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      sm_acc[(warp * G + g) * D + lane * VPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.0f, den = 0.0f;
    if (mx != -INFINITY) {  // a warp with no positions weighs exp2(-inf) = 0
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(sm_m[w][g] - mx);
        num = fmaf(sm_acc[(w * G + g) * D + d], f, num);
        den = fmaf(sm_l[w][g], f, den);
      }
    }
    if (alone) {
      o[((size_t)head * G + g) * D + d] =
          from_f32<T>(den > 0.0f ? num / den : 0.0f);
    } else {
      // workspace: acc [heads, splits, G, D], then (m, l) [heads, splits,
      // G, 2]
      const size_t at = (size_t)head * splits + split;
      ws[(at * G + g) * D + d] = num;
      if (d == 0) {
        float* ml = ws + (size_t)heads * splits * G * D + (at * G + g) * 2;
        ml[0] = mx;
        ml[1] = den;
      }
    }
  }
}

// The splits of a row that has more than one, merged in split order: o =
// sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M the largest m_s.  One
// block a head; a row with one split was written by it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ ws,
                              const int* __restrict__ lengths,
                              T* __restrict__ o, int heads, int kvh, int G,
                              int D, int bs, int mb, int splits, int chunk) {
  const int head = blockIdx.x, b = head / kvh;
  const int len = min(lengths[b], mb * bs);
  const int span = chunk * bs;
  if (len <= span) return;
  const int n = (len + span - 1) / span;  // the row's splits
  const float* ml = ws + (size_t)heads * splits * G * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
    for (int s = 0; s < n; ++s)
      mx = fmaxf(mx, ml[(((size_t)head * splits + s) * G + g) * 2]);
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < n; ++s) {
      const size_t at = ((size_t)head * splits + s) * G + g;
      const float f = exp2f(ml[at * 2] - mx);
      num = fmaf(ws[at * D + d], f, num);
      den = fmaf(ml[at * 2 + 1], f, den);
    }
    o[((size_t)head * G + g) * D + d] = from_f32<T>(num / den);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *lengths;
  void* o;
  float* ws;
  int B, kvh, G, D, bs, mb, splits, chunk;
  float scale_log2;
  cudaStream_t s;
};

template <typename T, typename P, int D, int G, bool QUANT>
int launch_split(const Args& a) {
  auto kernel = paged_decode_split_kernel<T, P, D, G, QUANT>;
  const size_t smem = Ring<P, D>::bytes(a.chunk);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int heads = a.B * a.kvh;
  kernel<<<heads * a.splits, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.kp),
      static_cast<const P*>(a.vp), a.ks, a.vs, a.tables, a.lengths,
      static_cast<T*>(a.o), a.ws, heads, a.kvh, a.bs, a.mb, a.splits,
      a.chunk, a.scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  paged_decode_merge_kernel<T><<<heads, kThreads, 0, a.s>>>(
      a.ws, a.lengths, static_cast<T*>(a.o), heads, a.kvh, a.G, a.D, a.bs,
      a.mb, a.splits, a.chunk);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int D, bool QUANT>
int by_groups(const Args& a) {
  switch (a.G) {
    case 1: return launch_split<T, P, D, 1, QUANT>(a);
    case 2: return launch_split<T, P, D, 2, QUANT>(a);
    case 4: return launch_split<T, P, D, 4, QUANT>(a);
    case 8: return launch_split<T, P, D, 8, QUANT>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool QUANT>
int by_dim(const Args& a) {
  using P = typename std::conditional<QUANT, int8_t, T>::type;
  if (a.D == 64) return by_groups<T, P, 64, QUANT>(a);
  if (a.D == 128) return by_groups<T, P, 128, QUANT>(a);
  return (int)cudaErrorInvalidValue;
}

// q of `dtype` (f32 or bf16); pools of the same type, or int8 with QUANT.
// ``splits`` blocks a head, each over ``chunk`` table entries (splits
// chunk >= mb > (splits - 1) chunk); ``ws`` holds heads splits G (D + 2)
// floats where splits > 1.
template <bool QUANT>
int launch_paged(Args a, float scale, int dtype) {
  if (a.B <= 0 || a.kvh <= 0 || a.bs <= 0 || a.mb <= 0 || a.splits < 1 ||
      a.chunk < 1 || (long long)a.splits * a.chunk < a.mb ||
      (long long)(a.splits - 1) * a.chunk >= a.mb ||
      (a.splits > 1 && a.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  a.scale_log2 = scale * kLog2e;
  if (dtype == kBFloat16) return by_dim<__nv_bfloat16, QUANT>(a);
  if (dtype == kFloat32) return by_dim<float, QUANT>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

}  // namespace taper

using namespace taper;

extern "C" int taper_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* lengths, void* o, int B,
                                  int kvh, int G, int D, int bs, int mb,
                                  float scale, int dtype, void* stream,
                                  void* ws, int splits, int chunk) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(tables), static_cast<const int*>(lengths),
         o, static_cast<float*>(ws), B, kvh, G, D, bs, mb, splits, chunk,
         0.0f, static_cast<cudaStream_t>(stream)};
  return launch_paged<false>(a, scale, dtype);
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
                                       float scale, int dtype, void* stream,
                                       void* ws, int splits, int chunk) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales),
         static_cast<const int*>(tables), static_cast<const int*>(lengths),
         o, static_cast<float*>(ws), B, kvh, G, D, bs, mb, splits, chunk,
         0.0f, static_cast<cudaStream_t>(stream)};
  return launch_paged<true>(a, scale, dtype);
}
