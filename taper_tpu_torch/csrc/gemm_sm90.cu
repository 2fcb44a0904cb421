// K1's bf16 GEMM for Hopper: TMA loads into a ring of 128-byte-swizzled
// shared-memory stages, warpgroup MMA (wgmma) out of them, f32
// accumulation, in the three contraction modes of the TPU kernel:
//   nt  y[M,N] = act(a[M,K] . b[N,K]^T + bias[N])   A K-major, B K-major
//   nn  y[M,N] = a[M,K] . b[K,N]                    A K-major, B N-major
//   tn  y[M,N] = a[K,M]^T . b[K,N]                  A M-major, B N-major
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit) for bf16 operands at M > 16 whose contiguous
// dimension is a multiple of 8 and whose data is 16-byte aligned (TMA's
// rules; ops/gemm.py::plan routes the rest to gemm_realign.cu): f32
// accumulation, the bf16 bias added in f32 after the last K step, then the
// none/relu/sigmoid epilogue, written as f32 or bf16.
//
// What bounds it on the H100: the transformer's training products (M =
// 16,384 tokens, K and N of 1,024 to 4,096) do hundreds of FLOPs per byte,
// so the tensor cores do; they reach their full rate only through wgmma
// fed from swizzled shared memory.
// What the design does about that:
//   * 128 x 128 output tiles, three warpgroups: one producer warp issues
//     the TMA loads of 64-deep K tiles (A 128 x 64, B 128 x 64, 32 KB a
//     stage) into a ring of STAGES stages, each with a "full" barrier that
//     the TMA completes and an "empty" barrier the consumer releases; two
//     consumer warpgroups take whole tiles in turn and run two m64n128k16
//     wgmma a k-step on each landed stage, one wgmma group in flight
//     behind the current one, so one's epilogue overlaps the other's
//     wgmma;
//   * the modes are layouts, not copies: TMA loads each operand's box from
//     its own layout, and wgmma reads a K-major or an M/N-major tile
//     through its transpose bits and descriptor (hopper.cuh, desc_sw128);
//     an M/N-major 128-wide tile is two 64-wide boxes (the 128-byte
//     swizzle's limit), LBO apart;
//   * TMA zero-fills the ragged M/N/K edges of a load and the epilogue
//     masks the ragged M/N edges of the store: nothing is padded in device
//     memory;
//   * split-K (``splits`` > 1, chosen by ops/gemm.py::plan when the tiles
//     fill less than a wave of 132 SMs): blocks of one output tile take
//     disjoint runs of whole K tiles and write f32 partials to the
//     workspace; the reduce kernel of gemm.cu sums them in split order
//     (no atomics, so every call gives the same bits), adds the bias and
//     writes;
//   * persistent: one block an SM (160 KB of stages) walks the work units
//     (tile and split), and the ring runs on from one unit to the next;
//   * registers move from the producer warpgroup to the consumers
//     (setmaxnreg);
//   * the ring, the two consumers' turns, the stage releases and the
//     staged TMA-store epilogue are hopper.cuh's gemm_pingpong skeleton,
//     which K15 and K12's wgmma route (quant_sm90.cu) share; this file
//     gives it K1's loads, products and epilogue (GemmWork).
// 128 x 256 tiles and a bank-conflict-free staging tile are later work.
#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace taper {

// csrc/gemm.cu: y = act(sum of the splits + bias), in split order
int splitk_reduce(const float* ws, const void* bias, void* y, int out_dtype,
                  int M, int N, int splits, int act, cudaStream_t s);

namespace {

using namespace hopper;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 5;
constexpr int TILE_BYTES = BM * BK * 2;        // A or B tile: 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;     // a 64-wide M/N-major box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int OUT_OFFSET = STAGES * STAGE_BYTES;  // the output tile
constexpr int OUT_BYTES = BM * BN * 4;         // two 64-row f32 halves
constexpr int BAR_OFFSET = OUT_OFFSET + OUT_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + (2 * STAGES + 2) * 8 + 1024;
constexpr int THREADS = 384;                   // producer + 2 consumers

template <typename OutT>
__device__ __forceinline__ void store2(OutT* y, size_t i, float v0,
                                       float v1, bool both, bool pair) {
  if (pair) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(y + i) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(y + i) =
          __floats2bfloat162_rn(v0, v1);
    }
  } else {
    y[i] = from_f32<OutT>(v0);
    if (both) y[i + 1] = from_f32<OutT>(v1);
  }
}

// 64 rows of a consumer warpgroup's output tile through shared memory
// (``tile``, row-major) and a TMA store at rows ``m0`` (staged_store): the
// fragment, plus bias and the epilogue ACT unless ``raw``.  ``bar``: the
// warpgroup's named barrier.
template <typename T, int ACT>
__device__ __forceinline__ void epilogue_tile(
    unsigned char* tile, const float (&acc)[64], int r0, int n0, int N,
    const __nv_bfloat16* __restrict__ bias, int bar, int z, int m0,
    const CUtensorMap* tma_y, bool raw) {
  const int lane = threadIdx.x % 32;
  T* out = reinterpret_cast<T*>(tile);
  staged_store(
      bar,
      [&] {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = j * 8 + (lane % 4) * 2;
          float b0 = 0.0f, b1 = 0.0f;
          if (!raw && bias != nullptr && n0 + col < N) {
            b0 = __bfloat162float(bias[n0 + col]);
            if (n0 + col + 1 < N) b1 = __bfloat162float(bias[n0 + col + 1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
            if (!raw) {
              v0 = epilogue(v0 + b0, ACT);
              v1 = epilogue(v1 + b1, ACT);
            }
            store2(out, (size_t)(r0 + h * 8) * BN + col, v0, v1, true, true);
          }
        }
      },
      [&] {
        if (raw)
          tma_store_3d(tma_y, tile, n0, m0, z);
        else
          tma_store_2d(tma_y, tile, n0, m0);
      });
}

// K1 on the skeleton of hopper.cuh (gemm_pingpong).  A_K: a is K-major
// ([M, K]: modes nt, nn), else M-major ([K, M]: tn).  B_K: b is K-major
// ([N, K]: nt), else N-major ([K, N]: nn, tn).  A work unit is one output
// tile and one run of ``k_per_split`` K tiles (split z of ``splits``), N
// tiles fastest; a consumer takes a whole 128 x 128 tile (two m64n128
// wgmma a k-step).  The output goes out through ``tma_y`` where
// ``tma_out`` (its rows a multiple of 16 bytes): the warpgroup writes 64
// rows at a time (bias and epilogue applied, or the raw f32 partial of a
// split, 3-D [splits, M, N]) to its staging tile and one thread hands them
// to a TMA store, which drains while the warpgroup goes on; otherwise each
// thread stores its fragment directly.
template <bool A_K, bool B_K, typename OutT>
struct GemmWork {
  static constexpr int STAGES = taper::STAGES, STAGE_BYTES = taper::STAGE_BYTES;
  static constexpr int STAGE_TX = STAGE_BYTES, BAR_OFFSET = taper::BAR_OFFSET;
  static constexpr bool WIDEN = false;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  const CUtensorMap* tma_a;
  const CUtensorMap* tma_b;
  const CUtensorMap* tma_y;
  const __nv_bfloat16* bias;
  OutT* y;
  float* part;
  unsigned char* smem;
  int M, N, act, k_per_split, splits, n_tiles, m_tiles, k_count;
  bool tma_out;
  // the unit's tile and its first K tile (the producer's and the
  // consumer's own copies)
  int n0, m0, z, kt0;
  float acc[2][64];  // rows [64 mh, 64 mh + 64) of the tile

  __device__ int units() const { return n_tiles * m_tiles * splits; }
  __device__ int k_tiles(int u) const {
    const int kt0 = u / (n_tiles * m_tiles) * k_per_split;
    return min(k_count, kt0 + k_per_split) - kt0;
  }
  __device__ void prefetch() const {
    tma_prefetch_desc(tma_a);
    tma_prefetch_desc(tma_b);
  }
  __device__ void locate(int u) {
    n0 = (u % n_tiles) * BN;
    m0 = (u / n_tiles % m_tiles) * BM;
    z = u / (n_tiles * m_tiles);
    kt0 = z * k_per_split;
  }
  __device__ void load(unsigned char* sa, uint64_t* bar, int i) const {
    const int k0 = (kt0 + i) * BK;
    unsigned char* sb = sa + TILE_BYTES;
    if (A_K) {
      tma_load_2d(sa, tma_a, bar, k0, m0);
    } else {
      tma_load_2d(sa, tma_a, bar, m0, k0);
      tma_load_2d(sa + HALF_BYTES, tma_a, bar, m0 + 64, k0);
    }
    if (B_K) {
      tma_load_2d(sb, tma_b, bar, k0, n0);
    } else {
      tma_load_2d(sb, tma_b, bar, n0, k0);
      tma_load_2d(sb + HALF_BYTES, tma_b, bar, n0 + 64, k0);
    }
  }
  __device__ void start(int u, int) {
    locate(u);
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        acc[mh][e] = 0.0f;
        fence_operand(acc[mh][e]);
      }
  }
  __device__ void mma(unsigned char* stage) {
    const uint32_t sa = smem_u32(stage);
    const uint32_t sb = sa + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db =
          B_K ? desc_sw128(sb + kk * 32, 16, 1024)
              : desc_sw128(sb + kk * 16 * 128, HALF_BYTES, 1024);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
        const uint64_t da =
            A_K ? desc_sw128(sa + mh * 64 * 128 + kk * 32, 16, 1024)
                : desc_sw128(sa + mh * HALF_BYTES + kk * 16 * 128,
                             HALF_BYTES, 1024);
        wgmma_m64n128k16<A_K ? 0 : 1, B_K ? 0 : 1>(acc[mh], da, db);
      }
    }
  }
  __device__ void fence_acc() {
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[mh][e]);
  }
  // epilogue: each m64n128 fragment, pairs of columns per register pair
  // (rows r0 and r0 + 8 of register pairs 2 (2 j) and 2 (2 j + 1)), one
  // instantiation an activation (the choice made once, not per element)
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
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool split = part != nullptr;
    const bool even = (N % 2) == 0;
    unsigned char* tile = smem + OUT_OFFSET + c * (OUT_BYTES / 2);
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      if (tma_out) {
        if (split)
          epilogue_tile<float, kNone>(tile, acc[mh], r0, n0, N, nullptr,
                                      1 + c, z, m0 + mh * 64, tma_y, true);
        else
          epilogue_tile<OutT, ACT>(tile, acc[mh], r0, n0, N, bias, 1 + c, z,
                                   m0 + mh * 64, tma_y, false);
        continue;
      }
      const int row0 = m0 + mh * 64 + r0;
      float* pout = split ? part + (size_t)z * M * N : nullptr;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + (lane % 4) * 2;
        if (col >= N) continue;
        const bool both = col + 1 < N;
        float b0 = 0.0f, b1 = 0.0f;
        if (!split && bias != nullptr) {
          b0 = __bfloat162float(bias[col]);
          if (both) b1 = __bfloat162float(bias[col + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + h * 8;
          if (row >= M) continue;
          const size_t at = (size_t)row * N + col;
          float v0 = acc[mh][j * 4 + h * 2];
          float v1 = acc[mh][j * 4 + h * 2 + 1];
          if (split) {
            store2(pout, at, v0, v1, both, both && even);
          } else {
            v0 = epilogue(v0 + b0, ACT);
            v1 = epilogue(v1 + b1, ACT);
            store2(y, at, v0, v1, both, both && even);
          }
        }
      }
    }
  }
  // the last stores have read their tile (and are complete) before exit
  __device__ void drain(int) {
    if (tma_out && threadIdx.x % 128 == 0) bulk_wait<0>();
  }
};

template <bool A_K, bool B_K, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap tma_y,
                      const __nv_bfloat16* __restrict__ bias,
                      OutT* __restrict__ y, float* __restrict__ part, int M,
                      int N, int K, int act, int k_per_split, int splits,
                      bool tma_out) {
  extern __shared__ unsigned char smem_raw[];
  // stages on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  GemmWork<A_K, B_K, OutT> w;
  w.tma_a = &tma_a;
  w.tma_b = &tma_b;
  w.tma_y = &tma_y;
  w.bias = bias;
  w.y = y;
  w.part = part;
  w.smem = smem;
  w.M = M, w.N = N, w.act = act;
  w.k_per_split = k_per_split, w.splits = splits;
  w.n_tiles = (N + BN - 1) / BN, w.m_tiles = (M + BM - 1) / BM;
  w.k_count = (K + BK - 1) / BK;
  w.tma_out = tma_out;
  gemm_pingpong(smem, w);
}

template <bool A_K, bool B_K, typename OutT>
int launch(const void* a, const void* b, const void* bias, void* y,
           float* ws, int M, int N, int K, int act, int splits,
           cudaStream_t s) {
  CUtensorMap ta, tb;
  // a: [M, K] or [K, M]; b: [N, K] or [K, N], each in boxes 64 wide along
  // its contiguous dimension (K-major: 128 rows, M/N-major: 64 K rows)
  int err = A_K ? tma_desc_bf16(&ta, a, K, M, BK, BM)
                : tma_desc_bf16(&ta, a, M, K, 64, BK);
  if (err == 0)
    err = B_K ? tma_desc_bf16(&tb, b, K, N, BK, BN)
              : tma_desc_bf16(&tb, b, N, K, 64, BK);
  if (err != 0) return err;
  const int k_tiles = (K + BK - 1) / BK;
  const int per = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per - 1) / per;
  // the output through TMA where its rows are whole 16-byte units: y as
  // [M, N] in boxes of 64 x 128, a split's partials as [splits, M, N]
  CUtensorMap ty;
  const bool f32_out = splits > 1 || sizeof(OutT) == 4;
  const bool tma_out = N % (f32_out ? 4 : 8) == 0;
  if (tma_out) {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)M, (uint64_t)splits};
    const uint32_t box[3] = {BN, 64, 1};
    err = f32_out ? tma_desc(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             splits > 1 ? 3 : 2, splits > 1 ? ws : y, dims,
                             box, CU_TENSOR_MAP_SWIZZLE_NONE)
                  : tma_desc(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, y,
                             dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  } else {
    memset(&ty, 0, sizeof(ty));
  }
  auto kernel = gemm_wgmma_kernel<A_K, B_K, OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long units =
      (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  const int grid = (int)std::min<long long>(units, sm_count());
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      ta, tb, ty, static_cast<const __nv_bfloat16*>(bias),
      static_cast<OutT*>(y), splits > 1 ? ws : nullptr, M, N, K, act, per,
      splits, tma_out);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return splitk_reduce(ws, bias, y, sizeof(OutT) == 4 ? kFloat32 : kBFloat16,
                       M, N, splits, act, s);
}

template <typename OutT>
int by_mode(const void* a, const void* b, const void* bias, void* y,
            float* ws, int M, int N, int K, int mode, int act, int splits,
            cudaStream_t s) {
  if (mode == 0)
    return launch<true, true, OutT>(a, b, bias, y, ws, M, N, K, act, splits,
                                    s);
  if (mode == 1)
    return launch<true, false, OutT>(a, b, nullptr, y, ws, M, N, K, kNone,
                                     splits, s);
  return launch<false, false, OutT>(a, b, nullptr, y, ws, M, N, K, kNone,
                                    splits, s);
}

}  // namespace

int gemm_wgmma(const void* a, const void* b, const void* bias, void* y,
               void* ws, int M, int N, int K, int mode, int out_dtype,
               int act, int splits, cudaStream_t s) {
  float* w = static_cast<float*>(ws);
  if (out_dtype == kBFloat16)
    return by_mode<__nv_bfloat16>(a, b, bias, y, w, M, N, K, mode, act,
                                  splits, s);
  return by_mode<float>(a, b, bias, y, w, M, N, K, mode, act, splits, s);
}

}  // namespace taper
