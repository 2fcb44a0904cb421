// K15a / K15b and K12's wgmma route for Hopper, on the persistent
// skeleton of hopper.cuh (gemm_pingpong), which K1's wgmma GEMM shares.
//
// K15: xq[M, K] int8 . q[N, K]^T int8 with int32 accumulators on the int8
// tensor cores through warpgroup MMA (wgmma), fed by TMA from a ring of
// 128-byte-swizzled shared-memory stages.
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
//
// K12 and K13 (replace taper_tpu/ops/pallas/quant.py::_q8_kernel, :41,
// launched by _linear_q8_jit, and _q4_kernel, :159, launched by
// _linear_q4_jit, at M > 16 where ops/quant.py::plan_q sends them here):
//   y[m,n] = scale[n] sum_k bf16(x[m,k]) q[n,k] - xsum[m] (scale[n] zp[n])
//            (+ bias[n]) (+ relu | sigmoid)
// over int8 codes [N, K] or int4 codes packed two to a byte [N, K / 2] (the
// even element in the low nibble), with the activations rounded to bf16
// (quant.py:53), xsum over the unrounded f32 activations (:57) and
// common.cuh's q_epilogue order of rounded steps (q_affine); a per-tensor
// scale or zero point is read with a stride of 0 (QTerms).  Its bound on the H100 at
// the W8A8 prefill's M = 4,096: the bf16 tensor cores (989 TFLOP/s).  What
// the design does about that: wgmma multiplies bf16 by bf16, and only its A
// operand may come from registers, while K12's and K13's operands are f32
// activations and integer codes.  So a row pass (rows_kernel) writes bf16 x
// and the row sums once (6 bytes an element, 0.015 ms of bytes at K 2,048, M
// 4,096), TMA brings bf16 x and the codes into each stage, and the codes are
// widened into a swizzled bf16 tile of the same stage (exact; no
// device-memory bytes), each row in K order: half by the producer
// warpgroup's three idle warps before they complete its "full" barrier, half
// by the consumer under the previous K tile's wgmma; wgmma then reads both
// operands from shared memory, as in K1's nt mode.  The int4 stage holds half
// the code bytes of the int8 one, so its ring has 5 stages where int8's has
// 4; the widening writes the same bf16 tile from either.  Measured against it
// on an H100 (PERF.md): the activations as f32 rounded in registers by the
// consumers (no row pass, but 4 bytes an element from L2 for each column
// tile, and spilled registers), and the codes widened by the consumers
// alone; both slower.  The widening's instruction rate and the row pass hold
// K12 at 30-38% of the tensor cores' rate, not the MMA.
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
// where ``tma_out`` (staged_store), else straight to y (pairs where the
// row allows).  ``rows``: sx and corr of the thread's two rows; ``terms``:
// sw, zw and the bias of the tile's columns, in shared memory (zero past M
// and N: those outputs are not stored).
template <int OUT>
__device__ __forceinline__ void epilogue(
    unsigned char* tile, const int (&acc)[64], int m0, int n0, int M, int N,
    const float (&rows)[2][2], const float* terms, bool has_bias, bool relu,
    OutT<OUT>* __restrict__ y, int bar, const CUtensorMap* tma_y,
    bool tma_out) {
  const int lane = threadIdx.x % 32;
  const int r0 = frag_row0();
  OutT<OUT>* out = reinterpret_cast<OutT<OUT>*>(tile);
  const bool even = N % 2 == 0;
  auto emit = [&](bool staged) {
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
        if (staged) {
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
  };
  if (tma_out)
    staged_store(bar, [&] { emit(true); },
                 [&] { tma_store_2d(tma_y, tile, n0, m0); });
  else
    emit(false);
}

// K15 on the skeleton of hopper.cuh (gemm_pingpong): a work unit is one
// 128 x 128 output tile (N tiles fastest) over all its 128-deep K tiles;
// a consumer takes it whole, two m64n128k32 wgmma a 32-deep k-step.
template <int OUT>
struct I8Work {
  using L = Layout<OUT>;
  static constexpr int STAGES = L::STAGES, STAGE_BYTES = taper::STAGE_BYTES;
  static constexpr int STAGE_TX = STAGE_BYTES, BAR_OFFSET = L::BAR_OFFSET;
  static constexpr bool WIDEN = false;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  const CUtensorMap* tma_a;
  const CUtensorMap* tma_b;
  const CUtensorMap* tma_y;
  const float *sx, *corr, *sw, *zw, *bias;
  OutT<OUT>* y;
  unsigned char* smem;
  int M, N, relu, n_tiles, m_tiles, k_count;
  bool tma_out;
  // the consumer's tile and the epilogue's terms, loaded as it starts: sx
  // and corr of the thread's four rows, sw, zw and the bias of column n0
  // + t (zero past M and N)
  int n0, m0;
  float rows[2][2][2], cols[3];
  int acc[2][64];  // rows [64 mh, 64 mh + 64) of the tile

  __device__ int units() const { return n_tiles * m_tiles; }
  __device__ int k_tiles(int) const { return k_count; }
  __device__ void prefetch() const {
    tma_prefetch_desc(tma_a);
    tma_prefetch_desc(tma_b);
  }
  __device__ void locate(int u) {
    n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * BM;
  }
  __device__ void load(unsigned char* sa, uint64_t* bar, int i) const {
    tma_load_2d(sa, tma_a, bar, i * BK, m0);
    tma_load_2d(sa + TILE_BYTES, tma_b, bar, i * BK, n0);
  }
  __device__ void start(int u, int) {
    locate(u);
    const int t = threadIdx.x % 128, r0 = frag_row0();
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int h = 0; h < 2; ++h) rows[mh][h][0] = rows[mh][h][1] = 0.0f;
    cols[0] = cols[1] = cols[2] = 0.0f;
    if constexpr (OUT != kOutI32) {
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + mh * 64 + r0 + h * 8;
          if (row < M) rows[mh][h][0] = sx[row], rows[mh][h][1] = corr[row];
        }
      if (n0 + t < N) {
        cols[0] = sw[n0 + t], cols[1] = zw[n0 + t];
        if (bias != nullptr) cols[2] = bias[n0 + t];
      }
    }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        acc[mh][e] = 0;
        fence_operand(acc[mh][e]);
      }
  }
  __device__ void mma(unsigned char* stage) {
    const uint32_t sa = smem_u32(stage);
    const uint32_t sb = sa + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t db = desc_sw128(sb + kk * 32, 16, 1024);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        wgmma_s8_m64n128k32(
            acc[mh], desc_sw128(sa + mh * 64 * 128 + kk * 32, 16, 1024), db);
    }
  }
  __device__ void fence_acc() {
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[mh][e]);
  }
  __device__ void finish(int, int c) {
    unsigned char* tile = smem + L::OUT_OFFSET + c * (L::OUT_BYTES / 2);
    float* terms =
        reinterpret_cast<float*>(smem + L::TERMS_OFFSET) + c * 3 * BN;
    if constexpr (OUT != kOutI32) {
      const int t = threadIdx.x % 128;
      // the warpgroup's previous epilogue has read the column terms
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int i = 0; i < 3; ++i) terms[i * BN + t] = cols[i];
      named_bar_sync(1 + c, 128);
    }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
      epilogue<OUT>(tile, acc[mh], m0 + mh * 64, n0, M, N, rows[mh], terms,
                    bias != nullptr, relu != 0, y, 1 + c, tma_y, tma_out);
  }
  // the last stores have read their tile (and are complete) before exit
  __device__ void drain(int) {
    if (tma_out && threadIdx.x % 128 == 0) bulk_wait<0>();
  }
};

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
  extern __shared__ unsigned char smem_raw[];
  // stages on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  I8Work<OUT> w;
  w.tma_a = &tma_a;
  w.tma_b = &tma_b;
  w.tma_y = &tma_y;
  w.sx = sx, w.corr = corr, w.sw = sw, w.zw = zw, w.bias = bias;
  w.y = y;
  w.smem = smem;
  w.M = M, w.N = N, w.relu = relu;
  w.n_tiles = (N + BN - 1) / BN, w.m_tiles = (M + BM - 1) / BM;
  w.k_count = (K + BK - 1) / BK;
  w.tma_out = tma_out;
  gemm_pingpong(smem, w);
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


// ---- K12 and K13 on the wgmma route -------------------------------------

namespace qlinear {

constexpr int BM = 128, BN = 128, BK = 64;
// A stage: bf16 x [128, 64] (TMA, 128-byte swizzled), the codes widened
// to bf16 [128, 64] (the same swizzle, written by the producer's warps
// 1-3 and the consumer) and the codes of the K tile (TMA, unswizzled: int8
// [128, 64 bytes], int4 [128, 32 bytes]; each widening thread reads 16
// codes, a row's in turn).  Then each consumer's 64 x 64 f32 staging
// tile, its column terms (scale, zp and the bias of its tile's columns)
// and the mbarriers.  The ring takes as many stages as fit beside the rest
// of the 227 KB, at most 5: 4 of int8's 40 KB, 5 of int4's 36 KB.
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int OUT_BYTES = 64 * 64 * 4;
constexpr int TERMS_BYTES = 2 * 3 * BN * 4;
constexpr int MAX_STAGES = 5;

template <int BITS>
struct QLayout {
  static constexpr int Q_ROW = BK * BITS / 8;  // a code row's K-tile bytes
  static constexpr int Q_BYTES = BN * Q_ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + Q_BYTES;
  static constexpr int FIT =
      (232448 - 1024 - 2 * OUT_BYTES - TERMS_BYTES -
       (3 * MAX_STAGES + 2) * 8) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int OUT_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int TERMS_OFFSET = OUT_OFFSET + 2 * OUT_BYTES;
  static constexpr int BAR_OFFSET = TERMS_OFFSET + TERMS_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFFSET + (3 * STAGES + 2) * 8 + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "stages on the swizzle's period");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// The row pass: xb = bf16(x) and xsum[m] = the sum of x's row m over the
// unrounded f32 values (quant.py:57), x read once: one warp a row, 16
// bytes a lane, the row sum by shuffles (K a multiple of 4 from a
// 16-byte-aligned base).
__global__ void __launch_bounds__(256)
    rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                float* __restrict__ xsum, int M, int K) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;  // whole warps leave together
  const size_t base = (size_t)row * K;
  float s = 0.0f;
#pragma unroll 4
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + base + k));
    s += ((v.x + v.y) + v.z) + v.w;
    *reinterpret_cast<uint2*>(xb + base + k) =
        make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
  s = warp_sum(s);
  if (lane == 0) xsum[row] = s;
}

// Eight int4 codes of a word (element i in bits 4i..4i+3, two's
// complement) as four bf16 pairs in K order, pair j holding elements 2j
// (low half) and 2j + 1: each nibble biased to unsigned, the even one as
// the mantissa of bf16 128 (136 subtracted), the odd one as bits 3-6 of
// the mantissa of bf16 16 (24 subtracted), both exact.
__device__ __forceinline__ uint4 widen_nibbles(uint32_t w) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t bias = 0x41C04308u;  // bf16 24 (high), 136 (low)
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = u >> (8 * j);
    uint32_t v = (b & 0x0000000Fu) | ((b << 15) & 0x00780000u) | 0x41804300u;
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
    h = __hsub2(h, *reinterpret_cast<const __nv_bfloat162*>(&bias));
    r[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// K12 (BITS 8) and K13 (BITS 4) on the skeleton of hopper.cuh
// (gemm_pingpong): a work unit is one 128 x 128 output tile of y = bf16(x)
// q^T (N tiles fastest) over its 64-deep K tiles, taken whole by one
// consumer (two m64n128k16 wgmma a 16-deep k-step, both operands K-major
// from shared memory, as K1's nt mode).  Per stage the producer's warps
// 1-3 widen the first 64 of its 128 code rows into the stage's bf16 tile,
// and the consumer the other 64 of its next stage under the current one's
// wgmma (WIDEN); each widened row holds its K tile in order.
// The epilogue, y = scale acc - xsum (scale zp) (+ bias) (+ relu |
// sigmoid), each step rounded (q_affine), goes out by 64 x 64 quarters
// through the consumer's staging tile and a TMA store (N a multiple of 4).
template <int BITS>
struct QWork {
  using L = QLayout<BITS>;
  static constexpr int STAGES = L::STAGES, STAGE_BYTES = L::STAGE_BYTES;
  static constexpr int STAGE_TX = A_BYTES + L::Q_BYTES;
  static constexpr int BAR_OFFSET = L::BAR_OFFSET;
  static constexpr bool WIDEN = true;
  // the widening warps keep their chunks' loads in flight
  static constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 200;
  // the code rows the producer's warps widen; the consumer the rest
  static constexpr int SPLIT = 64;
  const CUtensorMap* tma_a;
  const CUtensorMap* tma_q;
  const CUtensorMap* tma_y;
  const float *xsum, *bias;
  QTerms qt;
  unsigned char* smem;
  int M, N, act, n_tiles, m_tiles, k_count;
  // the unit's tile; the consumer's row sums of the thread's four rows,
  // and scale, zp and the bias of column n0 + t (zero past M and N)
  int n0, m0;
  float xs[2][2], cols[3];
  float acc[2][64];  // rows [64 mh, 64 mh + 64) of the tile

  __device__ int units() const { return n_tiles * m_tiles; }
  __device__ int k_tiles(int) const { return k_count; }
  __device__ void prefetch() const {
    tma_prefetch_desc(tma_a);
    tma_prefetch_desc(tma_q);
  }
  __device__ void locate(int u) {
    n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * BM;
  }
  __device__ void load(unsigned char* st, uint64_t* bar, int i) const {
    tma_load_2d(st, tma_a, bar, i * BK, m0);
    tma_load_2d(st + A_BYTES + B_BYTES, tma_q, bar, i * L::Q_ROW, n0);
  }
  // Part PART of a stage's widening: code rows [0, SPLIT) (part 0, the
  // producer's) or [SPLIT, 128) (part 1, the consumer's) in chunks of 16
  // codes (16 bytes of int8, 8 of int4: either way 32 bytes, two 16-byte
  // units, of the widened row), thread t of THREADS taking chunks t +
  // THREADS j, all its loads in flight before the first is widened; chunk
  // ch of a row holds its codes [16 ch, + 16), units 2 ch and 2 ch + 1.
  template <int PART, int THREADS>
  __device__ void widen(unsigned char* st, int t) const {
    constexpr int ROW0 = PART ? SPLIT : 0, ROWS = PART ? BN - SPLIT : SPLIT;
    constexpr int CB = 2 * BITS;         // a chunk's code bytes
    constexpr int CPR = BK / 16;         // chunks a code row
    constexpr int CHUNKS = ROWS * CPR;
    constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
    const uint32_t qs = smem_u32(st) + A_BYTES + B_BYTES + ROW0 * L::Q_ROW;
    const uint32_t wb = smem_u32(st) + A_BYTES;
    uint32_t v[PER][CB / 4];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = t + THREADS * j;
      if (i >= CHUNKS) continue;
      if constexpr (BITS == 8)
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[j][0]), "=r"(v[j][1]), "=r"(v[j][2]),
                       "=r"(v[j][3])
                     : "r"(qs + i * CB));
      else
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(v[j][0]), "=r"(v[j][1])
                     : "r"(qs + i * CB));
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = t + THREADS * j;
      if (i >= CHUNKS) continue;
      const int n = ROW0 + i / CPR, ch = i % CPR;
      const uint32_t row = wb + n * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 o;
        if constexpr (BITS == 8) {
          const uint2 lo = widen4(v[j][2 * h]), hi = widen4(v[j][2 * h + 1]);
          o = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else {
          o = widen_nibbles(v[j][h]);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         row + (((2 * ch + h) ^ (n & 7)) << 4)),
                     "r"(o.x), "r"(o.y), "r"(o.z), "r"(o.w)
                     : "memory");
      }
    }
  }
  __device__ void start(int u, int) {
    locate(u);
    const int t = threadIdx.x % 128, r0 = frag_row0();
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mh * 64 + r0 + h * 8;
        xs[mh][h] = row < M ? xsum[row] : 0.0f;
      }
    cols[0] = cols[1] = cols[2] = 0.0f;
    if (n0 + t < N) {
      cols[0] = qt.s(n0 + t), cols[1] = qt.z(n0 + t);
      if (bias != nullptr) cols[2] = bias[n0 + t];
    }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        acc[mh][e] = 0.0f;
        fence_operand(acc[mh][e]);
      }
  }
  __device__ void mma(unsigned char* st) {
    const uint32_t sa = smem_u32(st), sb = sa + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(sb + kk * 32, 16, 1024);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        wgmma_m64n128k16<0, 0>(
            acc[mh], desc_sw128(sa + mh * 64 * 128 + kk * 32, 16, 1024), db);
    }
  }
  __device__ void fence_acc() {
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[mh][e]);
  }
  // one instantiation an activation (the choice made once, not per
  // element)
  __device__ void finish(int, int c) {
    if (act == kRelu)
      finish_act<kRelu>(c);
    else if (act == kSigmoid)
      finish_act<kSigmoid>(c);
    else
      finish_act<kNone>(c);
  }
  template <int ACT>
  __device__ void finish_act(int c) {
    const int t = threadIdx.x % 128, lane = t % 32, r0 = frag_row0();
    float* terms =
        reinterpret_cast<float*>(smem + L::TERMS_OFFSET) + c * 3 * BN;
    // the warpgroup's previous epilogue has read the column terms
    named_bar_sync(1 + c, 128);
#pragma unroll
    for (int i = 0; i < 3; ++i) terms[i * BN + t] = cols[i];
    named_bar_sync(1 + c, 128);
    float* out =
        reinterpret_cast<float*>(smem + L::OUT_OFFSET + c * OUT_BYTES);
    const bool has_bias = bias != nullptr;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
        staged_store(
            1 + c,
            [&] {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int lc = j * 8 + (lane % 4) * 2, col = 64 * nh + lc;
                const float2 s =
                    *reinterpret_cast<const float2*>(terms + col);
                const float2 z =
                    *reinterpret_cast<const float2*>(terms + BN + col);
                const float2 b =
                    *reinterpret_cast<const float2*>(terms + 2 * BN + col);
                const int e = (8 * nh + j) * 4;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float v0 = q_affine(acc[mh][e + h * 2], xs[mh][h], s.x,
                                      z.x);
                  float v1 = q_affine(acc[mh][e + h * 2 + 1], xs[mh][h],
                                      s.y, z.y);
                  if (has_bias) {
                    v0 = __fadd_rn(v0, b.x);
                    v1 = __fadd_rn(v1, b.y);
                  }
                  *reinterpret_cast<float2*>(out + (r0 + h * 8) * 64 + lc) =
                      make_float2(taper::epilogue(v0, ACT),
                                  taper::epilogue(v1, ACT));
                }
              }
            },
            [&] { tma_store_2d(tma_y, out, n0 + 64 * nh, m0 + 64 * mh); });
  }
  // the last stores have read their tile (and are complete) before exit
  __device__ void drain(int) {
    if (threadIdx.x % 128 == 0) bulk_wait<0>();
  }
};

template <int BITS>
__global__ void __launch_bounds__(THREADS, 1)
    q_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_q,
                   const __grid_constant__ CUtensorMap tma_y,
                   const float* __restrict__ xsum, const QTerms qt,
                   const float* __restrict__ bias, int M, int N, int K,
                   int act) {
  extern __shared__ unsigned char smem_raw[];
  // stages on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  QWork<BITS> w;
  w.tma_a = &tma_a;
  w.tma_q = &tma_q;
  w.tma_y = &tma_y;
  w.xsum = xsum, w.qt = qt, w.bias = bias;
  w.smem = smem;
  w.M = M, w.N = N, w.act = act;
  w.n_tiles = (N + BN - 1) / BN, w.m_tiles = (M + BM - 1) / BM;
  w.k_count = (K + BK - 1) / BK;
  gemm_pingpong(smem, w);
}

// ws: bf16 x [M, K], then its row sums [M] (the row pass's output).
template <int BITS>
int launch(const float* x, const void* q, const QTerms& qt,
           const float* bias, float* y, void* ws, int M, int N, int K,
           int act, cudaStream_t s) {
  using L = QLayout<BITS>;
  auto xb = static_cast<__nv_bfloat16*>(ws);
  auto xsum = reinterpret_cast<float*>(xb + (size_t)M * K);
  rows_kernel<<<(M + 7) / 8, 256, 0, s>>>(x, xb, xsum, M, K);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  CUtensorMap ta, tq, ty;
  err = tma_desc_bf16(&ta, xb, K, M, BK, BM);
  if (err != 0) return err;
  {
    // the codes [N, K BITS / 8] in boxes of 128 rows by a K tile's bytes,
    // unswizzled
    const uint64_t dims[2] = {(uint64_t)K * BITS / 8, (uint64_t)N};
    const uint32_t box[2] = {L::Q_ROW, BN};
    err = tma_desc(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, q, dims, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != 0) return err;
  {
    // y [M, N] f32 in boxes of 64 x 64
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)M};
    const uint32_t box[2] = {64, 64};
    err = tma_desc(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, y, dims, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != 0) return err;
  auto kernel = q_wgmma_kernel<BITS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  kernel<<<grid, THREADS, L::SMEM_BYTES, s>>>(ta, tq, ty, xsum, qt, bias, M,
                                              N, K, act);
  return (int)cudaGetLastError();
}

}  // namespace qlinear
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

// K12 (bits 8) / K13 (bits 4) on the wgmma route (x f32 [M, K], q int8
// [N, K] or int4 [N, K / 2], y f32 [M, N]): K % 16 == 0 (int8) or 32
// (int4), N % 4 == 0, 16-byte-aligned x, q and y; ``ws`` holds M K bf16
// and M f32 (the row pass's bf16 x and row sums).
int linear_q_wgmma(const void* x, const void* q, const QTerms& qt,
                   const void* bias, void* y, void* ws, int M, int N, int K,
                   int bits, int act, cudaStream_t s) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto yp = static_cast<float*>(y);
  if (bits == 8)
    return qlinear::launch<8>(f(x), q, qt, f(bias), yp, ws, M, N, K, act, s);
  return qlinear::launch<4>(f(x), q, qt, f(bias), yp, ws, M, N, K, act, s);
}

}  // namespace taper
