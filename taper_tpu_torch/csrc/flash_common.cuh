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
