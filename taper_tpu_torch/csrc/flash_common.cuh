// Building blocks shared by the flash attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels.
//
// Every flash kernel runs blocks of four warps over 64-row tiles; each warp
// owns 16 rows of the block's tile.  Tiles are staged in shared memory with
// padded rows.  bf16 tiles go through the tensor cores with WMMA 16x16x16
// fragments, f32 tiles through the same schedule with FMA loops in which
// lane owns columns lane + 32 j.
//
// Tensors are addressed through element strides (Layout), so one kernel
// reads [B, H, S, D] and the projections' [B, S, H*D] alike: a row of a
// head is D contiguous elements either way, only the strides differ.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace taper {
namespace flash {

using namespace nvcuda;

constexpr int kTile = 64, kWarps = 4, kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Element strides of q/o (and of dq/do) and of k/v (and of dk/dv).
struct Layout {
  long long qb, qh, qs, kb, kh, ks;
};

// layout 0: [B, H, S, D] and [B, Hkv, S, D]; layout 1: [B, S, H*D] and
// [B, S, Hkv*D].
inline Layout make_layout(int layout, int H, int Hkv, int S, int D) {
  const long long s = S, d = D;
  if (layout == 0) return {H * s * d, s * d, d, Hkv * s * d, s * d, d};
  return {s * H * d, d, H * d, s * Hkv * d, d, Hkv * d};
}

template <typename T, int D>
struct Tiles {
  static constexpr bool kTC = sizeof(T) == 2;  // tensor-core path
  // bf16 tiles keep WMMA's 32-byte alignment; f32 tiles pad by one float
  // so that lanes walking a column hit distinct banks.
  static constexpr int LDT = kTC ? D + 8 : D + 1;  // [64, D] tile of T
  static constexpr int LDS = kTile + 4;            // [64, 64] f32 scores
  static constexpr int LDP = kTile + 8;            // [64, 64] weights, T
  static constexpr int LDO = D + 4;                // [64, D] f32
  static constexpr size_t tile = align128(sizeof(T) * kTile * LDT);
  static constexpr size_t scores = align128(sizeof(float) * kTile * LDS);
  static constexpr size_t weights = align128(sizeof(T) * kTile * LDP);
  static constexpr size_t out = align128(sizeof(float) * kTile * LDO);
  static constexpr size_t rows = align128(sizeof(float) * kTile);
};

// The mask every flash kernel applies on top of the ragged edge: causal,
// a sliding window over the past (window > 0: row r keeps cols > r -
// window, the `window` term of attention.py:_mask), and segment ids of
// packed documents (seg [B, S] int32, non-null: a pair is kept when the
// ids are equal; id 0 is padding, which attends padding).
//
// Each kernel is instantiated twice: MASKED = false takes a causal mask
// or none, and its tests below compile to the causal test alone, so the
// unmasked path keeps the code it had before windows and segments;
// MASKED = true takes every mask.  A kernel takes the fields as scalar
// parameters and builds its Mask inside.  Measured on an H100 at the 170M
// shape: with the extra tests in its inner loops K6 took 1.63 ms against
// 1.44, and with the struct as a by-value parameter the forward took
// 5-10% longer (tools/flash_ab.py).
struct Mask {
  int causal, window;
  const int* seg;
};

// True for a mask only the MASKED instantiation takes.
inline bool masked(const Mask& m) { return m.window > 0 || m.seg != nullptr; }

template <bool MASKED>
__device__ __forceinline__ bool keep(const Mask& m, int row, int col) {
  if constexpr (MASKED)
    return (!m.causal || col <= row) &&
           (m.window <= 0 || col > row - m.window);
  return !m.causal || col <= row;
}

template <bool MASKED>
__device__ __forceinline__ bool has_ids(const Mask& m) {
  return MASKED && m.seg != nullptr;
}

// The band of tiles a mask leaves (the counterparts of attention.py's
// _kv_band_start/_kv_band and _q_band): a query tile [q0, q0 + 64) needs
// the KV tiles from (q0 - window + 1), rounded down to a tile, up to the
// diagonal (or to S without causality); a KV tile [kv0, kv0 + 64) is seen
// by the query tiles from the diagonal (0 without causality) up to row
// kv0 + 63 + window - 1.  Without a window both run from 0 to S.
template <bool MASKED>
__device__ __forceinline__ int kv_begin(const Mask& m, int q0) {
  return MASKED && m.window > 0 ? max(0, q0 - m.window + 1) / kTile * kTile
                                : 0;
}
__device__ __forceinline__ int kv_end(const Mask& m, int q0, int S) {
  return m.causal ? min(S, q0 + kTile) : S;
}
__device__ __forceinline__ int q_begin(const Mask& m, int kv0) {
  return m.causal ? kv0 : 0;
}
template <bool MASKED>
__device__ __forceinline__ int q_end(const Mask& m, int kv0, int S) {
  return MASKED && m.window > 0 ? min(S, kv0 + kTile - 1 + m.window) : S;
}

// The segment ids of rows [row0, row0 + 64) of batch row `b` into shared
// memory (-1 past S, which the ragged-edge test masks anyway).
__device__ __forceinline__ void load_ids(int* sm, const Mask& m, int b,
                                         int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    sm[i] = row0 + i < S ? m.seg[(size_t)b * S + row0 + i] : -1;
}

// Whether two tiles' segment ids can meet: their [min, max] ranges
// overlap.  Every thread scans both 64-id tiles in shared memory and so
// reaches the same answer, and a block skips a tile pair whole or not at
// all.  A skipped pair has no kept entry, so skipping changes no result.
__device__ __forceinline__ bool ids_meet(const int* a, const int* b) {
  int alo = a[0], ahi = a[0], blo = b[0], bhi = b[0];
#pragma unroll 8
  for (int i = 1; i < kTile; ++i) {
    alo = min(alo, a[i]);
    ahi = max(ahi, a[i]);
    blo = min(blo, b[i]);
    bhi = max(bhi, b[i]);
  }
  return alo <= bhi && blo <= ahi;
}

// delta = rowsum(dO * O) of one D-element row, by one warp: each lane's
// terms (columns lane + 32 j) loaded first, so that a warp can have many
// rows' loads in flight (K6 on wgmma, flash_bwd_sm90.cu, loads 8 rows at
// a time), then summed in order and across the warp by a butterfly (every
// lane gets the same bits).  K6 and K10's pre-pass (row_delta) both sum
// through it, so the two give the same delta.
template <typename T, int D>
struct DeltaTerms {
  float g[D / 32], o[D / 32];

  __device__ __forceinline__ void load(const T* dout_row, const T* o_row) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      g[j] = to_f32(dout_row[lane + 32 * j]);
      o[j] = to_f32(o_row[lane + 32 * j]);
    }
  }
  __device__ __forceinline__ float sum() const {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc = fmaf(g[j], o[j], acc);
    return warp_sum(acc);
  }
};

template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* dout, const T* o) {
  DeltaTerms<T, D> t;
  t.load(dout, o);
  return t.sum();
}

// Rows [row0, row0 + 64) of one head (row stride `ld` elements) into a
// shared tile, zeros past S (zeros matter: 0 * garbage could be NaN).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* sm, const T* g, long long ld,
                                          int row0, int S) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = D / VEC;
  for (int c = threadIdx.x; c < kTile * CPR; c += kThreads) {
    int r = c / CPR, d = (c % CPR) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(g + (row0 + r) * ld + d);
    if constexpr (LD % VEC == 0) {
      *reinterpret_cast<uint4*>(sm + r * LD + d) = val;
    } else {
      const T* src = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm[r * LD + d + e] = src[e];
    }
  }
}

// S[16 x 64] (f32) = A[16 x D] . B[64 x D]^T for one warp: A holds the
// warp's 16 rows, B a whole 64-row tile, both in shared memory.
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* A, const T* B,
                                            float* S) {
  using L = Tiles<T, D>;
  if constexpr (L::kTC) {
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        // B stored [64, D] row-major is the D x 64 operand in col-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bt;
        wmma::load_matrix_sync(a, A + kk, L::LDT);
        wmma::load_matrix_sync(bt, B + n * 16 * L::LDT + kk, L::LDT);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x % 32;
    // lane owns columns lane and lane + 32 for all 16 rows
    float acc[16][2] = {};
    for (int d = 0; d < D; ++d) {
      float b0 = to_f32(B[lane * L::LDT + d]);
      float b1 = to_f32(B[(lane + 32) * L::LDT + d]);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float av = to_f32(A[r * L::LDT + d]);
        acc[r][0] = fmaf(av, b0, acc[r][0]);
        acc[r][1] = fmaf(av, b1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      S[r * L::LDS + lane] = acc[r][0];
      S[r * L::LDS + lane + 32] = acc[r][1];
    }
  }
}

// A warp's [16 x D] f32 accumulator in registers: WMMA fragments on the
// tensor-core path, lane-owned columns on the FMA path.  The backward
// kernels keep dQ, dK and dV here for the whole sweep.
template <typename T, int D, bool TC = (sizeof(T) == 2)>
struct WarpAcc;

template <typename T, int D>
struct WarpAcc<T, D, true> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(f[n], 0.0f);
  }
  // this += A[16 x 64] . B[64 x D]: A the warp's rows of a weight tile
  // (leading dimension LDP), B a [64, D] tile (LDT)
  __device__ __forceinline__ void mma(const T* A, const T* B) {
    using L = Tiles<T, D>;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, A + kk, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b;
        wmma::load_matrix_sync(b, B + kk * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(f[n], a, b, f[n]);
      }
    }
  }
  // the warp's 16 rows into f32 shared memory (leading dimension LDO)
  __device__ __forceinline__ void store(float* C) const {
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(C + n * 16, f[n], Tiles<T, D>::LDO,
                              wmma::mem_row_major);
  }
};

template <typename T, int D>
struct WarpAcc<T, D, false> {
  float v[D / 32][16];  // lane owns column lane + 32 j of rows 0..15

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
#pragma unroll
      for (int r = 0; r < 16; ++r) v[j][r] = 0.0f;
  }
  __device__ __forceinline__ void mma(const T* A, const T* B) {
    using L = Tiles<T, D>;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      for (int c = 0; c < kTile; ++c) {
        float bv = to_f32(B[c * L::LDT + lane + 32 * j]);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          v[j][r] = fmaf(to_f32(A[r * L::LDP + c]), bv, v[j][r]);
      }
    }
  }
  __device__ __forceinline__ void store(float* C) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
#pragma unroll
      for (int r = 0; r < 16; ++r)
        C[r * Tiles<T, D>::LDO + lane + 32 * j] = v[j][r];
  }
};

// C[16 x D] (f32, leading dimension LDO) = A[16 x 64] . B[64 x D] for one
// warp, with A given transposed: At is a [64, 64] weight tile (LDP) whose
// columns [c0, c0 + 16) are the warp's rows.  The f32 fused backward (K10)
// forms dQ's share of a tile pair this way from the ds^T tile it already
// holds (bf16 K10 runs flash_sm90.cu's wgmma sweep).
template <typename T, int D>
__device__ __forceinline__ void warp_mma_t(const T* At, const T* B,
                                           float* C) {
  static_assert(sizeof(T) == 4, "the FMA path: f32 tiles");
  using L = Tiles<T, D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    float acc[16] = {};
    for (int c = 0; c < kTile; ++c) {
      float bv = to_f32(B[c * L::LDT + lane + 32 * j]);
#pragma unroll
      for (int r = 0; r < 16; ++r)
        acc[r] = fmaf(to_f32(At[c * L::LDP + r]), bv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) C[r * L::LDO + lane + 32 * j] = acc[r];
  }
}

// Writes a warp's 16 staged rows (f32, leading dimension LDO) times
// `scale` to rows [row0, row0 + 16) of one head, skipping rows past S.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* g, long long ld,
                                           const float* C, int row0, int S,
                                           float scale) {
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 16 * D; e += 32) {
    int r = e / D, d = e % D;
    if (row0 + r < S)
      g[(row0 + r) * ld + d] =
          from_f32<T>(C[r * Tiles<T, D>::LDO + d] * scale);
  }
}

}  // namespace flash
}  // namespace taper
