// K15a / K15b for Hopper: xq[M, K] int8 . q[N, K]^T int8 with int32
// accumulators on the int8 tensor cores through warpgroup MMA (wgmma), fed
// by TMA from a ring of 128-byte-swizzled shared-memory stages.
//
// Replaces the TPU kernels taper_tpu/ops/pallas/quant.py::_i8mm_kernel
// (K15b, quant.py:292: the exact int32 product) and _i8mm_scaled_kernel
// (K15a, quant.py:324: the W8A8 epilogue
//   y = (sx[m] sw[n]) (float(acc) - zw[n] corr[m]) (+ bias[n]) (+ relu)
// in f32 or bf16, each step rounded through the _rn intrinsics so that
// nvcc contracts nothing into an FMA, as the plain version rounds every
// step) for operands whose rows are whole 16-byte units (K % 16 == 0) from
// 16-byte-aligned bases, TMA's rules (ops/quant.py::plan routes the rest
// to the mma.sync kernel of quant.cu).  The two are one template: they
// differ in the epilogue alone.
//
// What bounds it on the H100: the W8A8 prefill's products (M = 4,096, (N,
// K) = (2,048, 2,048), (8,192, 2,048), (2,048, 8,192)) do 4,096 to 16,384
// operations a byte, so the int8 tensor cores do (1,979 TOP/s), which only
// wgmma fed from swizzled shared memory reaches.
// What the design does about that (the shape of gemm_sm90.cu):
//   * int8 wgmma takes both operands K-major, which is how [M, K] and [N,
//     K] lie: nothing is transposed;
//   * 128 x 128 output tiles, three warpgroups: one producer thread issues
//     the TMA loads of 128-deep K tiles (128 bytes, the swizzle's box
//     width; A 128 x 128, B 128 x 128, 32 KB a stage) into a ring of 4
//     or 5 stages with full and empty mbarriers; two consumer
//     warpgroups take whole tiles in turn, each a 64-row half by one
//     m64n128k32 wgmma four times a stage, one wgmma group in flight
//     behind the current one;
//   * persistent: one block an SM walks the tiles (N fastest) and the ring
//     runs on from tile to tile, so one warpgroup's epilogue overlaps the
//     other's products and the next tile's loads.  At the W8A8 shapes
//     128 x 128 tiles give 512 to 2,048 tiles, 3.9 to 15.5 waves of 132
//     blocks (97-99% of the last wave busy); 128 x 256 tiles would give
//     the same share (1.9 to 7.8 waves), so the tile stays the one whose
//     accumulators fit a warpgroup twice;
//   * TMA zero-fills the ragged M/N/K edges of a load, so M = 1..63 runs
//     on the same path (rows past M compute zeros and are not stored);
//   * the epilogue works on the s32 accumulator registers.  Its row terms
//     (sx, corr: four rows a thread) and column terms (sw, zw, the bias:
//     one column a thread, shared through shared memory) are loaded when
//     a tile starts, so that their latency hides behind its K loop (read
//     in the epilogue from global memory, they made K15a a quarter slower
//     than K15b at K = 2,048 on an H100).  The tile goes out through
//     shared memory and a TMA store where the output's rows are whole
//     16-byte units, else by pairs from the registers.
#include <algorithm>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace taper {

namespace {

using namespace hopper;

// output codes shared with taper_matmul_int8 (quant.cu)
constexpr int kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2;

constexpr int BM = 128, BN = 128, BK = 128;
constexpr int TILE_BYTES = BM * BK;             // A or B tile: 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int MAX_STAGES = 5;
constexpr int BAR_BYTES = (2 * MAX_STAGES + 2) * 8;
constexpr int THREADS = 384;                    // producer + 2 consumers
constexpr int CONSUMER_WARPS = 4;               // a tile's consumers

template <int OUT>
using OutT = typename std::conditional<
    OUT == kOutI32, int,
    typename std::conditional<OUT == kOutBF16, __nv_bfloat16,
                              float>::type>::type;

// Shared memory: the ring, the output staging tile (two 64-row halves,
// one a consumer), K15a's column terms (sw, zw and the bias of each
// consumer's tile), the mbarriers, and the slack that puts the stages on
// 1024-byte boundaries.  The ring takes as many stages as fit beside the
// rest of the 227 KB, at most 5: 5 for K15b and for K15a's bf16 output, 4
// for its f32 output (K15b ran slower on 4 stages at K = 2,048).
template <int OUT>
struct Layout {
  static constexpr int OUT_BYTES = BM * BN * (int)sizeof(OutT<OUT>);
  static constexpr int TERMS_BYTES = OUT == kOutI32 ? 0 : 2 * 3 * BN * 4;
  static constexpr int FIT =
      (232448 - 1024 - BAR_BYTES - OUT_BYTES - TERMS_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int OUT_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int TERMS_OFFSET = OUT_OFFSET + OUT_BYTES;
  static constexpr int BAR_OFFSET = TERMS_OFFSET + TERMS_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFFSET + BAR_BYTES + 1024;
};

// The W8A8 epilogue of one accumulator, in the TPU kernel's order, every
// step rounded (quant.py:351).
__device__ __forceinline__ float w8a8(int acc, float sxm, float corrm,
                                      float swn, float zwn, bool has_bias,
                                      float bn, bool relu) {
  float v = __fmul_rn(__fmul_rn(sxm, swn),
                      __fsub_rn(__int2float_rn(acc), __fmul_rn(zwn, corrm)));
  if (has_bias) v = __fadd_rn(v, bn);
  return relu ? fmaxf(v, 0.0f) : v;
}

template <int OUT>
__device__ __forceinline__ void store_pair(OutT<OUT>* p, int i0, int i1,
                                           float v0, float v1) {
  if constexpr (OUT == kOutI32) {
    *reinterpret_cast<int2*>(p) = make_int2(i0, i1);
  } else if constexpr (OUT == kOutBF16) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

template <int OUT>
__device__ __forceinline__ void store_one(OutT<OUT>* p, int i, float v) {
  if constexpr (OUT == kOutI32)
    *p = i;
  else if constexpr (OUT == kOutBF16)
    *p = __float2bfloat16(v);
  else
    *p = v;
}

// The thread's row within a warpgroup's 64-row fragment (and that row + 8).
__device__ __forceinline__ int frag_row0() {
  return (threadIdx.x % 128) / 32 * 16 + threadIdx.x % 32 / 4;
}

// A warpgroup's 64 x 128 fragment ``acc`` (rows m0 + r0 and r0 + 8 of the
// thread, tile columns n0 + 8 j + 2 (lane % 4) + {0, 1}) through the
// epilogue: into the staging ``tile`` and out by a TMA store at (n0, m0)
// where ``tma_out``, else straight to y (pairs where the row allows).
// ``rows``: sx and corr of the thread's two rows; ``terms``: sw, zw and the
// bias of the tile's columns, in shared memory (zero past M and N: those
// outputs are not stored).
template <int OUT>
__device__ __forceinline__ void epilogue(
    unsigned char* tile, const int (&acc)[64], int m0, int n0, int M, int N,
    const float (&rows)[2][2], const float* terms, bool has_bias, bool relu,
    OutT<OUT>* __restrict__ y, int bar, const CUtensorMap* tma_y,
    bool tma_out) {
  const int lane = threadIdx.x % 32;
  const int r0 = frag_row0();
  const bool leader = threadIdx.x % 128 == 0;
  OutT<OUT>* out = reinterpret_cast<OutT<OUT>*>(tile);
  if (tma_out) {
    if (leader) bulk_wait_read<0>();
    named_bar_sync(bar, 128);
  }
  const bool even = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const int gn = n0 + col;
    // sw, zw and the bias of the thread's column pair
    float2 swn = {}, zwn = {}, bn = {};
    if constexpr (OUT != kOutI32) {
      swn = *reinterpret_cast<const float2*>(terms + col);
      zwn = *reinterpret_cast<const float2*>(terms + BN + col);
      bn = *reinterpret_cast<const float2*>(terms + 2 * BN + col);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i0 = acc[j * 4 + h * 2], i1 = acc[j * 4 + h * 2 + 1];
      float v0 = 0.0f, v1 = 0.0f;
      if constexpr (OUT != kOutI32) {
        const float sxm = rows[h][0], corrm = rows[h][1];
        v0 = w8a8(i0, sxm, corrm, swn.x, zwn.x, has_bias, bn.x, relu);
        v1 = w8a8(i1, sxm, corrm, swn.y, zwn.y, has_bias, bn.y, relu);
      }
      const int r = r0 + h * 8;
      if (tma_out) {
        store_pair<OUT>(out + r * BN + col, i0, i1, v0, v1);
        continue;
      }
      const int row = m0 + r;
      if (row >= M || gn >= N) continue;
      OutT<OUT>* p = y + (size_t)row * N + gn;
      if (gn + 1 < N && even) {
        store_pair<OUT>(p, i0, i1, v0, v1);
      } else {
        store_one<OUT>(p, i0, v0);
        if (gn + 1 < N) store_one<OUT>(p + 1, i1, v1);
      }
    }
  }
  if (tma_out) {
    fence_proxy_async_smem();
    named_bar_sync(bar, 128);
    if (leader) {
      tma_store_2d(tma_y, tile, n0, m0);
      bulk_commit();
    }
  }
}

// Persistent: block x takes tiles x, x + gridDim.x, ... (N tiles fastest).
// The two consumer warpgroups take the block's tiles in turn, each a whole
// 128 x 128 tile (two m64n128k32 wgmma a 32-deep k-step); the producer
// fills the ring tile after tile.
template <int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    i8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const __grid_constant__ CUtensorMap tma_y,
                    const float* __restrict__ sx,
                    const float* __restrict__ corr,
                    const float* __restrict__ sw,
                    const float* __restrict__ zw,
                    const float* __restrict__ bias, OutT<OUT>* __restrict__ y,
                    int M, int N, int K, int relu, bool tma_out) {
  using L = Layout<OUT>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // stages on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  // order[c]: the other consumer has waited for every stage of its tile,
  // so warpgroup c may wait for the stages of its next one (a parity wait
  // must never run two phases ahead of its barrier)
  uint64_t* order = empty + STAGES;

  const int k_tiles = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  const int tiles = n_tiles * m_tiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tma_a);
      tma_prefetch_desc(&tma_b);
      int it = 0;  // ring position
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const int n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * BM;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* sa = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(sa, &tma_a, &full[s], kt * BK, m0);
          tma_load_2d(sa + TILE_BYTES, &tma_b, &full[s], kt * BK, n0);
        }
      }
    }
  } else {
    // consumers: warpgroup c takes the block's tiles c, c + 2, ... whole
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    unsigned char* tile = smem + L::OUT_OFFSET + c * (L::OUT_BYTES / 2);
    float* terms =
        reinterpret_cast<float*>(smem + L::TERMS_OFFSET) + c * 3 * BN;
    const int t = threadIdx.x % 128, r0 = frag_row0();
    int acc[2][64];  // rows [64 mh, 64 mh + 64) of the tile
    int it = 0;      // ring position of this tile's first K tile
    int own = 0;     // this warpgroup's tiles so far
    for (int u = blockIdx.x, i = 0; u < tiles; u += gridDim.x, ++i) {
      if (i % 2 != c) {  // the other warpgroup's tile
        it += k_tiles;
        continue;
      }
      const int n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * BM;
      // the epilogue's terms, loaded now and used after the K loop: sx
      // and corr of the thread's four rows, sw, zw and the bias of column
      // n0 + t (zero past M and N)
      float rows[2][2][2] = {}, cols[3] = {};
      if constexpr (OUT != kOutI32) {
#pragma unroll
        for (int mh = 0; mh < 2; ++mh)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + mh * 64 + r0 + h * 8;
            if (row < M)
              rows[mh][h][0] = sx[row], rows[mh][h][1] = corr[row];
          }
        if (n0 + t < N) {
          cols[0] = sw[n0 + t], cols[1] = zw[n0 + t];
          if (bias != nullptr) cols[2] = bias[n0 + t];
        }
      }
      // the tiles' stages are consumed in ring order
      if (c == 1)
        mbar_wait(&order[1], own & 1);
      else if (own > 0)
        mbar_wait(&order[0], (own - 1) & 1);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          acc[mh][e] = 0;
          fence_operand(acc[mh][e]);
        }
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t sa = smem_u32(smem + s * STAGE_BYTES);
        const uint32_t sb = sa + TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t db = desc_sw128(sb + kk * 32, 16, 1024);
#pragma unroll
          for (int mh = 0; mh < 2; ++mh)
            wgmma_s8_m64n128k32(
                acc[mh], desc_sw128(sa + mh * 64 * 128 + kk * 32, 16, 1024),
                db);
        }
        wgmma_commit();
        // the previous stage's wgmma have finished reading it: release it
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int e = 0; e < 64; ++e) fence_operand(acc[mh][e]);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      if (threadIdx.x % 128 == 0) mbar_arrive(&order[1 - c]);
      ++own;
      if constexpr (OUT != kOutI32) {
        // the warpgroup's previous epilogue has read the column terms
        named_bar_sync(1 + c, 128);
#pragma unroll
        for (int i = 0; i < 3; ++i) terms[i * BN + t] = cols[i];
        named_bar_sync(1 + c, 128);
      }
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        epilogue<OUT>(tile, acc[mh], m0 + mh * 64, n0, M, N, rows[mh], terms,
                      bias != nullptr, relu != 0, y, 1 + c, &tma_y, tma_out);
    }
    // the last stores have read their tile (and are complete) before exit
    if (tma_out && threadIdx.x % 128 == 0) bulk_wait<0>();
  }
}

template <int OUT>
int launch(const void* xq, const void* q, const float* sx, const float* corr,
           const float* sw, const float* zw, const float* bias, void* y,
           int M, int N, int K, int relu, cudaStream_t s) {
  CUtensorMap ta, tb, ty;
  int err = tma_desc_i8(&ta, xq, K, M, BM);
  if (err == 0) err = tma_desc_i8(&tb, q, K, N, BN);
  if (err != 0) return err;
  // the output through TMA where its rows are whole 16-byte units: y as
  // [M, N] in boxes of 64 x 128
  constexpr int ELEM = sizeof(OutT<OUT>);
  const bool tma_out = ((size_t)N * ELEM) % 16 == 0;
  if (tma_out) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M};
    const uint32_t box[2] = {BN, 64};
    const CUtensorMapDataType type =
        OUT == kOutI32    ? CU_TENSOR_MAP_DATA_TYPE_INT32
        : OUT == kOutBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    err = tma_desc(&ty, type, ELEM, 2, y, dims, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  } else {
    memset(&ty, 0, sizeof(ty));
  }
  auto kernel = i8_wgmma_kernel<OUT>;
  constexpr int SMEM_BYTES = Layout<OUT>::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(ta, tb, ty, sx, corr, sw, zw,
                                           bias, static_cast<OutT<OUT>*>(y),
                                           M, N, K, relu, tma_out);
  return (int)cudaGetLastError();
}

}  // namespace

// K15 on the wgmma route: ``out`` kOutI32 (K15b, the vectors null) or
// kOutF32 / kOutBF16 (K15a).  K % 16 == 0 and 16-byte-aligned xq and q.
int matmul_int8_wgmma(const void* xq, const void* q, const void* sx,
                      const void* corr, const void* sw, const void* zw,
                      const void* bias, void* y, int M, int N, int K,
                      int relu, int out, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (out == kOutI32)
    return launch<kOutI32>(xq, q, nullptr, nullptr, nullptr, nullptr,
                           nullptr, y, M, N, K, 0, s);
  if (out == kOutBF16)
    return launch<kOutBF16>(xq, q, f(sx), f(corr), f(sw), f(zw), f(bias), y,
                            M, N, K, relu, s);
  return launch<kOutF32>(xq, q, f(sx), f(corr), f(sw), f(zw), f(bias), y, M,
                         N, K, relu, s);
}

}  // namespace taper
