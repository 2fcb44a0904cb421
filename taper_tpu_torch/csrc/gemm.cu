// K1: GEMM in the three contraction modes of the TPU kernel:
//   nt  y[M,N] = act(a[M,K] . b[N,K]^T + bias[N])   (linear forward)
//   nn  y[M,N] = a[M,K] . b[K,N]                    (linear backward dX)
//   tn  y[M,N] = a[K,M]^T . b[K,N]                  (linear backward dW)
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit in modes "nt", "nn" and "tn"): f32 accumulation,
// bias added in f32 after the last K step, then the none/relu/sigmoid
// epilogue, written as f32 (as _gemm_jit) or, on request, rounded once to
// bf16.  As in _MODES (gemm.py:76-80), every operand is read in its
// natural layout: no transpose is materialised.  Bias and epilogue apply
// in mode nt only.
//
// One C entry point, taper_gemm, runs the kernel that ops/gemm.py::plan
// chose (its route) with its K split:
//   * wgmma (bf16, M > 16, TMA-aligned): csrc/gemm_sm90.cu;
//   * decode (bf16 nt at M <= 16): csrc/gemm_decode.cu, its K split over a
//     thread-block cluster;
//   * realign (other bf16: operands TMA cannot take, and modes nn and tn
//     at M <= 16): csrc/gemm_realign.cu, 16-byte windows realigned on
//     chip;
//   * f32: the FMA tile kernel below.  The port keeps TF32 off, so f32
//     stays on the CUDA cores.  Its path shapes are skinny: long-M
//     products with N of 10 to 512 (the forward and dX of the sort task,
//     ResNet-8's patch GEMMs, the CNN and the MLP), which the memory rate
//     or the FMA rate bounds (ResNet-8's nt moves 46 MB, 0.0138 ms at 3.35
//     TB/s), and weight gradients with a small output over a long K (the
//     sort task's dW [128, 128] over K = 8,192, ResNet-8's [32..64,
//     16..288] over K = 16,384..65,536), which only stream their operands
//     fast enough with every SM's loads in flight.  What the design does:
//       - tiles sized to the output (ops/gemm.py::f32_plan: 128 x 32 for
//         N <= 32, 64 x 64 for wider outputs that fill the card, 64 x 32,
//         and 32 x 32 for small outputs), each thread 8 x 4 or 4 x 4
//         outputs, so no thread computes padding at N = 32 or M = 32 and
//         each 16-byte shared load feeds 16-32 FMAs; the 32 x 32 tile
//         splits each K tile over 2 or 4 groups of 64 threads, summed in
//         group order, so that a small output's short chain of K steps
//         still has 128-256 threads a block;
//       - a ring of 3-4 K tiles (16, 32 or 64 deep; 16 for K under 64) in
//         flight through 16-byte cp.async copies (4-byte ones for rows
//         that are not whole chunks), each operand staged in its own
//         layout: a K-major operand (A in modes nt and nn, B in nt) as
//         rows of BK + 4 floats, read along K without bank conflicts;
//       - split-K on the 32 x 32 tile when the output has fewer tiles than
//         SMs: four blocks an SM, all resident (a cooperative launch), each
//         split's f32 partial to a workspace, then a grid barrier and a sum
//         by every warp of the grid in a fixed order (gemm_f32_kernel), in
//         the same launch.
// Ragged M/N/K edges are masked in the kernels (zero-filled loads); nothing
// is padded in device memory.  Split-K sums in a fixed order and adds no
// partial by atomics, so each call gives the same bits.
#include <algorithm>

#include "common.cuh"

namespace taper {

// csrc/gemm_sm90.cu
int gemm_wgmma(const void* a, const void* b, const void* bias, void* y,
               void* ws, int M, int N, int K, int mode, int out_dtype,
               int act, int splits, cudaStream_t s);

// csrc/gemm_decode.cu
int gemm_decode(const void* x, const void* w, const void* bias, void* y,
                int M, int N, int K, int out_dtype, int act, int splits,
                cudaStream_t s);

// csrc/gemm_realign.cu
int gemm_realign(const void* a, const void* b, const void* bias, void* y,
                 int M, int N, int K, int lda, int ldb, int mode,
                 int out_dtype, int act, int windows, cudaStream_t s);

// The wgmma route's split-K reduce (below): y = act(sum of the splits +
// bias)
int splitk_reduce(const float* ws, const void* bias, void* y, int out_dtype,
                  int M, int N, int splits, int act, cudaStream_t s);

// route codes shared with ROUTES in taper_tpu_torch/ops/gemm.py
enum Route : int { kWgmma = 0, kRealign = 1, kDecode = 2, kF32 = 3 };

// ---------------------------------------------------------------------------
// f32 FMA tile kernel, all modes, split-K summed in the same launch
// ---------------------------------------------------------------------------

// The row padding of the staged tiles.
constexpr int F_PAD = 4;

// One tile shape: BM x BN outputs a block, TM x TN a thread.  Threads are
// TX = BN / TN columns by BM / TM rows; each aligned group of 8 lanes
// (one phase of a 16-byte shared load) shares its rows, so the A loads
// broadcast, and spans 8 consecutive B columns or rows, so the B loads
// hit 8 distinct 16-byte bank groups.  A_MK: a is [M, K] (modes nt, nn),
// staged as As[m][k]; else [K, M] (tn), staged as As[k][m].  B_NK: b is
// [N, K] (nt), staged as Bs[n][k]; else [K, N], as Bs[k][n].  A K-major
// row is BK + F_PAD floats (20, 36 or 68: an odd number of 16-byte bank
// groups), so 8 consecutive rows read at one k fall in 8 distinct groups.
// STAGES K tiles of BK make the ring; KG groups of TG threads each take
// BK / KG of every K tile, and group 0 adds the others' sums in order.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_,
          int KG_, bool A_MK, bool B_NK>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int BK = BK_, STAGES = STAGES_, KG = KG_;
  // TG threads cover the tile; KG such groups split each K tile
  static constexpr int TX = BN / TN, TG = (BM / TM) * TX, NT = TG * KG;
  static constexpr int LDK = BK + F_PAD;  // a K-major row
  static constexpr int LDA = A_MK ? LDK : BM + F_PAD;
  static constexpr int LDB = B_NK ? LDK : BN + F_PAD;
  static constexpr int A_ELEMS = A_MK ? BM * LDK : BK * LDA;
  static constexpr int STAGE = A_ELEMS + (B_NK ? BN * LDK : BK * LDB);
  static constexpr size_t SMEM = sizeof(float) * STAGE * STAGES;
  static_assert(TX >= 8 && TM % 4 == 0 && TN % 4 == 0, "see above");
  static_assert(BK % (4 * KG) == 0 &&
                    (KG - 1) * TG * TM * TN <= STAGE * STAGES,
                "a group's K steps are whole; the groups' sums fit");
  // column j of a thread: interleaved by TX where B is K-major (its rows
  // at one k), else in 4-wide chunks interleaved by TX (16-byte loads)
  static __device__ __forceinline__ int col(int tx, int j) {
    return B_NK ? tx + j * TX : ((j / 4) * TX + tx) * 4 + j % 4;
  }
};

// Starts the copy of one operand's K tile (R rows or columns of M or N
// from mn0, BK of K from k0) into shared memory in the operand's own
// layout, zero-filled past the ragged edges.  ``vec``: the contiguous
// dimension is a multiple of 4 and the base 16-byte aligned, so 16-byte
// copies are all in or all out; else 4-byte copies.
template <int R, int BK, bool K_FAST, int NT>
__device__ __forceinline__ void f32_copy_tile(float* S, const float* g,
                                              int mn0, int MN, int k0, int K,
                                              bool vec) {
  constexpr int ROWS = K_FAST ? R : BK, COLS = K_FAST ? BK : R;
  constexpr int LD = COLS + F_PAD;
  const int rows = K_FAST ? MN : K, cols = K_FAST ? K : MN;
  const int r0 = K_FAST ? mn0 : k0, c0 = K_FAST ? k0 : mn0;
  if (vec) {
    constexpr int CPR = COLS / 4;
#pragma unroll 4
    for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
      const int r = c / CPR, cc = (c % CPR) * 4;
      const int gr = r0 + r, gc = c0 + cc;
      const bool in = gr < rows && gc < cols;
      cp_async16(S + r * LD + cc, in ? g + (size_t)gr * cols + gc : g, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, cc = e % COLS;
      const int gr = r0 + r, gc = c0 + cc;
      const bool in = gr < rows && gc < cols;
      cp_async4(S + r * LD + cc, in ? g + (size_t)gr * cols + gc : g, in);
    }
  }
}

// Every block of a split call waits here until all of the grid has
// arrived.  The grid is launched cooperatively, so all its blocks are
// resident at once.  sync[0] counts arrivals, sync[1] departures; the
// last block to leave sets both back to 0 for the next call.
__device__ __forceinline__ void grid_barrier(int* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int blocks = gridDim.x * gridDim.y * gridDim.z;
    __threadfence();  // this block's partial before its arrival
    atomicAdd(sync, 1);
    while (*reinterpret_cast<volatile int*>(sync) < blocks) __nanosleep(64);
    __threadfence();
    if (atomicAdd(sync + 1, 1) == blocks - 1) sync[0] = sync[1] = 0;
  }
  __syncthreads();
}

// Block (x, y, z) computes the output tile (y, x) over the K tiles [z *
// k_per_split, (z + 1) * k_per_split).  Unsplit (gridDim.z == 1) it adds
// the bias, applies the epilogue and writes y.  Split, it writes its f32
// partial to ws[z]; after a grid barrier every warp of the grid sums 4-wide
// chunks of the output over the splits, G lanes a chunk, lane l the splits
// l, l + G, ... in order, then the G lanes in a butterfly (the same bits
// on each), and adds the bias and the epilogue: a fixed order, whatever
// order the blocks ran in (gemm_reference_split in ops/gemm.py repeats
// it).
template <class L, bool A_MK, bool B_NK>
__global__ void __launch_bounds__(L::NT)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ ws, int* __restrict__ sync, int M,
                    int N, int K, int act, int k_per_split, bool vec_a,
                    bool vec_b) {
  constexpr int BM = L::BM, BN = L::BN, TM = L::TM, TN = L::TN;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(16) float f32_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // the thread's K group and its place in the tile
  const int g = L::KG == 1 ? 0 : threadIdx.x / L::TG;
  const int t = L::KG == 1 ? threadIdx.x : threadIdx.x % L::TG;
  const int tx = t % L::TX, ty = t / L::TX;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * k_per_split;
  const int nk = min(k_tiles, kt0 + k_per_split) - kt0;

  auto load = [&](int i) {
    float* As = f32_smem + (i % STAGES) * L::STAGE;
    const int k0 = (kt0 + i) * BK;
    f32_copy_tile<BM, BK, A_MK, L::NT>(As, a, m0, M, k0, K, vec_a);
    f32_copy_tile<BN, BK, B_NK, L::NT>(As + L::A_ELEMS, b, n0, N, k0, K,
                                       vec_b);
  };

  float acc[TM][TN] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // one group per stage, empty ones included
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed
    __syncthreads();              // ... for every thread; stage i-1 free
    if (i + STAGES - 1 < nk) load(i + STAGES - 1);
    cp_async_commit();
    const float* As = f32_smem + (i % STAGES) * L::STAGE;
    const float* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int kk = g * (BK / L::KG); kk < (g + 1) * (BK / L::KG); kk += 4) {
      float av[TM][4], bv[TN][4];  // four k steps of the thread's operands
      if constexpr (A_MK) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (ty * TM + r) * L::LDA + kk);
          av[r][0] = v.x, av[r][1] = v.y, av[r][2] = v.z, av[r][3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < TM; r += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                As + (kk + j) * L::LDA + ty * TM + r);
            av[r][j] = v.x, av[r + 1][j] = v.y, av[r + 2][j] = v.z,
            av[r + 3][j] = v.w;
          }
      }
      if constexpr (B_NK) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + L::col(tx, c) * L::LDB + kk);
          bv[c][0] = v.x, bv[c][1] = v.y, bv[c][2] = v.z, bv[c][3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < TN; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + (kk + j) * L::LDB + L::col(tx, c));
            bv[c][j] = v.x, bv[c + 1][j] = v.y, bv[c + 2][j] = v.z,
            bv[c + 3][j] = v.w;
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(av[r][j], bv[c][j], acc[r][c]);
    }
  }
  cp_async_wait<0>();
  if constexpr (L::KG > 1) {
    // groups 1.. hand their sums to group 0 through the (spent) stages,
    // which adds them in group order
    __syncthreads();
    float* red = f32_smem;
    if (g > 0)
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          red[((g - 1) * TM * TN + r * TN + c) * L::TG + t] = acc[r][c];
    __syncthreads();
    if (g == 0)
      for (int h = 1; h < L::KG; ++h)
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] += red[((h - 1) * TM * TN + r * TN + c) * L::TG + t];
  }

  // the thread's outputs into `out`: y, with the bias and the epilogue,
  // or this split's partial; 16-byte stores where B is N-major and rows
  // are whole chunks
  const bool split = gridDim.z > 1;
  const size_t MN = (size_t)M * N;
  float* out = split ? ws + blockIdx.z * MN : y;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty * TM + r;
    if (gm >= M || g > 0) continue;
#pragma unroll
    for (int c = 0; c < TN; c += B_NK ? 1 : 4) {
      constexpr int W = B_NK ? 1 : 4;
      const int gn = n0 + L::col(tx, c);
      float v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        v[e] = acc[r][c + e];
        if (!split && gn + e < N) {
          if (bias != nullptr) v[e] += bias[gn + e];
          v[e] = epilogue(v[e], act);
        }
      }
      float* dst = out + (size_t)gm * N + gn;
      if constexpr (W == 4) {
        if (N % 4 == 0) {
          if (gn < N)
            *reinterpret_cast<float4*>(dst) =
                make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (gn + e < N) dst[e] = v[e];
    }
  }
  if (!split) return;

  grid_barrier(sync);
  // G lanes a chunk (the splits' count rounded up to a power of two, at
  // most 32), 32 / G chunks a warp at once, U such rounds in flight
  constexpr int U = 4;
  const int splits = gridDim.z;
  const int G = splits >= 32 ? 32 : 1 << (32 - __clz(splits - 1));
  const int lane = threadIdx.x % 32, gl = lane % G;
  const long long per_pass = (long long)(32 / G) * U;
  const long long warp = ((long long)(blockIdx.z * gridDim.y + blockIdx.y) *
                              gridDim.x + blockIdx.x) * (L::NT / 32) +
                         threadIdx.x / 32;
  const long long grid_warps =
      (long long)gridDim.x * gridDim.y * gridDim.z * (L::NT / 32);
  const long long chunks = (MN + 3) / 4;
  const bool vec = MN % 4 == 0;
  for (long long base = warp * per_pass; base < chunks;
       base += grid_warps * per_pass) {
    float v[U][4] = {};
    long long c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) c[u] = base + u * (32 / G) + lane / G;
    for (int z = gl; z < splits; z += G) {
      const float* p = ws + z * MN;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c[u] >= chunks) continue;
        if (vec) {
          const float4 q =
              __ldcg(reinterpret_cast<const float4*>(p + 4 * c[u]));
          v[u][0] += q.x, v[u][1] += q.y, v[u][2] += q.z, v[u][3] += q.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * c[u] + i < (long long)MN)
              v[u][i] += __ldcg(p + 4 * c[u] + i);
        }
      }
    }
    // the butterfly within each group of G lanes: every lane of the group
    // ends with the same sums
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[u][i] += __shfl_xor_sync(0xffffffffu, v[u][i], off);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long e = 4 * c[u] + i;
        if (i % G != gl || c[u] >= chunks || e >= (long long)MN) continue;
        float r = v[u][i];
        if (bias != nullptr) r += bias[e % N];
        y[e] = epilogue(r, act);
      }
  }
}

template <class L, bool A_MK, bool B_NK>
int launch_gemm_f32(const float* a, const float* b, const float* bias,
                    float* y, float* ws, int* sync, int M, int N, int K,
                    int act, int splits, cudaStream_t s) {
  auto kernel = gemm_f32_kernel<L, A_MK, B_NK>;
  if (L::SMEM > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const int k_tiles = (K + L::BK - 1) / L::BK;
  int per = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per - 1) / per;
  const int a_cols = A_MK ? K : M, b_cols = B_NK ? K : N;
  bool vec_a = a_cols % 4 == 0 && (uintptr_t)a % 16 == 0;
  bool vec_b = b_cols % 4 == 0 && (uintptr_t)b % 16 == 0;
  dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
  if (splits == 1) {
    kernel<<<grid, L::NT, L::SMEM, s>>>(a, b, bias, y, ws, sync, M, N, K,
                                        act, per, vec_a, vec_b);
    return (int)cudaGetLastError();
  }
  // split: every block resident at once (the grid barrier), or refused
  if (ws == nullptr || sync == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&a,   &b, &bias, &y,   &ws,    &sync,  &M,
                  &N,   &K, &act,  &per, &vec_a, &vec_b};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                              dim3(L::NT), args, L::SMEM, s);
  return (int)cudaGetLastError();  // also clears a refused launch
}

// The f32 route with the tile ops/gemm.py::f32_plan chose (codes shared
// with F32_TILES there).
template <bool A_MK, bool B_NK>
int gemm_f32(const void* a_, const void* b_, const void* bias_, void* y_,
             void* ws_, int* sync, int M, int N, int K, int act,
             int splits, int tile, cudaStream_t s) {
  auto a = static_cast<const float*>(a_), b = static_cast<const float*>(b_);
  auto bias = static_cast<const float*>(bias_);
  auto y = static_cast<float*>(y_);
  auto ws = static_cast<float*>(ws_);
#define TAPER_F32_TILE(BM, BN, TM, TN, BK, STAGES, KG)                      \
  launch_gemm_f32<F32Tile<BM, BN, TM, TN, BK, STAGES, KG, A_MK, B_NK>,      \
                  A_MK, B_NK>(a, b, bias, y, ws, sync, M, N, K, act,        \
                              splits, s)
  switch (tile) {
    case 0: return TAPER_F32_TILE(128, 32, 8, 4, 16, 4, 1);
    case 1: return TAPER_F32_TILE(64, 64, 8, 4, 32, 4, 1);
    case 2: return TAPER_F32_TILE(32, 32, 4, 4, 64, 3, 2);
    case 3: return TAPER_F32_TILE(64, 32, 4, 4, 32, 4, 1);
    case 4: return TAPER_F32_TILE(32, 32, 4, 4, 16, 4, 1);
    case 5: return TAPER_F32_TILE(32, 32, 4, 4, 64, 3, 4);
  }
#undef TAPER_F32_TILE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// split-K reduce of the wgmma route: y = act(sum over splits, in split
// order, + bias), bf16 bias, f32 or bf16 out
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* __restrict__ ws,
                         const __nv_bfloat16* __restrict__ bias,
                         OutT* __restrict__ y, int M, int N, int splits,
                         int act) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int sp = 1; sp < splits; ++sp) v += ws[(size_t)sp * total + i];
    if (bias != nullptr) v += to_f32(bias[i % N]);
    y[i] = from_f32<OutT>(epilogue(v, act));
  }
}

int splitk_reduce(const float* ws, const void* bias, void* y, int out_dtype,
                  int M, int N, int splits, int act, cudaStream_t s) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 16);
  auto b = static_cast<const __nv_bfloat16*>(bias);
  if (out_dtype == kFloat32)
    splitk_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        ws, b, static_cast<float*>(y), M, N, splits, act);
  else
    splitk_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        ws, b, static_cast<__nv_bfloat16*>(y), M, N, splits, act);
  return (int)cudaGetLastError();
}

}  // namespace taper

using namespace taper;

// K1 in ``mode`` (0 nt, 1 nn, 2 tn; codes shared with MODES in
// taper_tpu_torch/ops/gemm.py) on the route ops/gemm.py::plan chose, split
// ``splits`` ways over K (``ws``: splits * M * N f32 of workspace when
// splits > 1, except on the decode route, whose splits are a cluster's
// blocks).  ``lda``, ``ldb``: the operands' row strides in elements, their
// row widths except on the realign route.  The f32 route takes its tile
// shape (``tile``, a code of F32_TILES) and, split, ``sync``: two int32 of
// grid-barrier state, zero before the call and zero again after it; the
// realign route takes its operands' staging in ``tile`` (bit 0: a through
// windows, bit 1: b).  ``bias`` and ``act`` in mode nt only; ``out_dtype``
// f32, or bf16 for bf16 operands.
extern "C" int taper_gemm(const void* a, const void* b, const void* bias,
                          void* y, void* ws, void* sync, int M, int N,
                          int K, int lda, int ldb, int mode, int dtype,
                          int out_dtype, int act, int route, int splits,
                          int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || mode < 0 || mode > 2 || splits < 1 ||
      (splits > 1 && ws == nullptr && route != kDecode) ||
      (mode != 0 && (bias != nullptr || act != kNone)))
    return (int)cudaErrorInvalidValue;
  const bool dense = lda == (mode == 2 ? M : K) && ldb == (mode == 0 ? K : N);
  if (!dense && (route != kRealign || dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    if (route != kF32 || out_dtype != kFloat32)
      return (int)cudaErrorInvalidValue;
    int* bar = static_cast<int*>(sync);
    if (mode == 0)
      return gemm_f32<true, true>(a, b, bias, y, ws, bar, M, N, K, act,
                                  splits, tile, s);
    if (mode == 1)
      return gemm_f32<true, false>(a, b, nullptr, y, ws, bar, M, N, K,
                                   kNone, splits, tile, s);
    return gemm_f32<false, false>(a, b, nullptr, y, ws, bar, M, N, K,
                                  kNone, splits, tile, s);
  }
  if (dtype != kBFloat16 ||
      (out_dtype != kFloat32 && out_dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (route == kWgmma)
    return gemm_wgmma(a, b, bias, y, ws, M, N, K, mode, out_dtype, act,
                      splits, s);
  if (route == kDecode) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    return gemm_decode(a, b, bias, y, M, N, K, out_dtype, act, splits, s);
  }
  if (splits != 1 || route != kRealign) return (int)cudaErrorInvalidValue;
  return gemm_realign(a, b, bias, y, M, N, K, lda, ldb, mode, out_dtype, act,
                      tile, s);
}

extern "C" const char* taper_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
