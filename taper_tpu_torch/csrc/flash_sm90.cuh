// Building blocks of the Hopper flash kernels (flash_sm90.cu: K8's forward
// and K7's dK/dV), on top of hopper.cuh and flash_common.cuh.
//
// A head's rows are read and written by TMA through rank-3 descriptors, so
// that a tile past S reads zeros and a store past S is dropped inside its
// own batch row and head, in either layout of the port:
//   * [B, S, H*D] (layout 1): dims (H*D, S, B), a head's box at column
//     h*D, outer index b;
//   * [B, H, S, D] (layout 0): dims (D, S, B*H), column 0, outer index
//     b*H + h.
// A [rows, D] tile in shared memory is D / 64 boxes of [rows, 64] bf16
// under the 128-byte swizzle, box x (columns 64 x .. 64 x + 63) at byte
// rows * 128 * x; it is read K-major (along D) or N-major (along the rows)
// by the wgmma descriptors alone.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace taper {
namespace flash {
namespace sm90 {

using namespace hopper;

// A producer warpgroup (one thread or one warp issues the loads) and two
// consumer warpgroups of 64 rows each; registers move from the producer
// to the consumers (setmaxnreg).
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Where a head's rows start in its tensor's rank-3 descriptor: the column
// of the head's first box and the outer index.
struct HeadAt {
  int col, outer;
};

__host__ __device__ __forceinline__ HeadAt head_at(int layout, int b,
                                                   int heads, int head,
                                                   int D) {
  return layout ? HeadAt{head * D, b} : HeadAt{0, b * heads + head};
}

// The descriptor of a [B, S, heads*D] or [B, heads, S, D] bf16 tensor in
// boxes of ``box_rows`` rows of 64 columns.
inline int head_desc(CUtensorMap* map, const void* ptr, int layout, int B,
                     int heads, int S, int D, int box_rows) {
  return layout ? tma_desc_bf16_3d(map, ptr, (uint64_t)heads * D, S, B, 64,
                                   box_rows)
                : tma_desc_bf16_3d(map, ptr, D, S, (uint64_t)B * heads, 64,
                                   box_rows);
}

// The [rows, D] tile of one head at row ``row0`` into shared memory at
// ``dst`` (D / 64 boxes), reported to ``bar``.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, HeadAt at,
                                          int row0) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x)
    tma_load_3d(dst + x * ROWS * 128, map, bar, at.col + 64 * x, row0,
                at.outer);
}

// Rows [row0, row0 + 64) of a staged [ROWS, D] tile (its rows
// ``first``..``first`` + 63) out to one head, one bulk group; rows past S
// are dropped by the descriptor.
template <int D, int ROWS>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           const unsigned char* tile,
                                           int first, HeadAt at, int row0) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x)
    tma_store_3d(map, tile + x * ROWS * 128 + first * 128, at.col + 64 * x,
                 row0, at.outer);
  bulk_commit();
}

// K-major descriptor of the k16 slice ``kk`` (along D) of rows [first,
// first + n) of a [ROWS, D] tile at shared address ``tile``.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int first,
                                           int kk) {
  return desc_sw128(tile + (kk / 4) * ROWS * 128 + first * 128 +
                        (kk % 4) * 32,
                    16, 1024);
}

// N-major descriptor of the k16 slice ``kk`` (along the rows: rows 16 kk
// .. 16 kk + 15) of a [ROWS, D] tile, all D columns as N: the 64-wide
// boxes lie ROWS * 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_n(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, ROWS * 128, 1024);
}

// Keeps the compiler from moving accumulator or operand registers across
// the asynchronous wgmma that own them.
template <int N>
__device__ __forceinline__ void fence_frag(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Applies a mask to a warpgroup's m64nN fragment: ``keep(r, c)`` is called
// with the element's row (``row0``: the thread's first row, frag_row
// added) and column (``col0``: the tile's first column, frag_col added);
// where it is false the element becomes ``masked``.
template <int N, typename Keep>
__device__ __forceinline__ void mask_frag(float (&f)[N / 2], int row0,
                                          int col0, float masked,
                                          Keep keep) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    if (!keep(row0 + frag_row(e), col0 + frag_col(e, q))) f[e] = masked;
}

}  // namespace sm90
}  // namespace flash
}  // namespace taper
