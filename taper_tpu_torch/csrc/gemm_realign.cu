// K1's route for bf16 operands that TMA cannot take (rows that are not
// whole 16-byte units, a misaligned base, a row stride other than the row
// width), and for bf16 modes nn and tn at M <= 16, in the three
// contraction modes of the TPU kernel:
//   nt  y[M,N] = act(a[M,K] . b[N,K]^T + bias[N])   A K-major, B K-major
//   nn  y[M,N] = a[M,K] . b[K,N]                    A K-major, B N-major
//   tn  y[M,N] = a[K,M]^T . b[K,N]                  A M-major, B N-major
//
// Replaces the TPU kernel taper_tpu/ops/pallas/gemm.py::_linear_kernel
// (launched by _gemm_jit) on those operands (ops/gemm.py::plan, route
// "realign"): f32 accumulation, the bf16 bias added in f32 after the last
// K step, then the none/relu/sigmoid epilogue, written as f32 or bf16.
//
// What bounds it on the H100: at the shapes it takes (a K of 1,001: [512,
// 1001] . [1000, 1001]^T, 1.0 GFLOP, 1 us at the bf16 peak; 5 MB, 1.5 us
// at 3.35 TB/s) neither the tensor cores nor the memory rate do: the
// chain of K steps does, each a round trip to L2 or DRAM unless several
// are in flight.  A copy of 2-byte elements one by one (the first design,
// a WMMA tile) waits on every load before its shared-memory store, so its
// ring of stages overlapped nothing.
// What the design does about that:
//   * every load is a 16-byte cp.async; each operand is staged by what its
//     own alignment allows (ops/gemm.py::staging judges each alone): an
//     operand whose rows are whole 16-byte chunks from a 16-byte-aligned
//     base streams straight into the tile the MMA reads; any other one
//     copies, for each tile row, the BK / 8 + 1 16-byte-aligned windows
//     that enclose the row's segment into a raw stage of the ring, and
//     one pass inside the block shifts each row by its own offset of 0-7
//     elements (__byte_perm on 32-bit words) into the MMA's tile while the
//     next stages' copies are in flight.  An odd K (rows alternate in
//     offset), a misaligned view (every row shares one) and a row stride
//     are one mechanism;
//   * the pass zeroes every element past the matrix's rows or columns (a
//     window past a row's end holds the next row, or any bytes, NaN
//     included); a window that reaches past the tensor's last byte copies
//     only the bytes inside it (cp.async's source size) and zero-fills
//     the rest, so no byte past the tensor is read.  Rounding a
//     misaligned base down to 16 bytes stays in its allocation (PyTorch's
//     allocations are 256-byte aligned);
//   * mma.sync m16n8k16 from ldmatrix (.trans for the M/N-major tiles):
//     the product is not what bounds it, and the per-row shift writes a
//     plain row-major tile, which ldmatrix reads in either layout without
//     bank conflicts (rows padded by one 16-byte chunk, the raw window);
//   * 64 x 64 output tiles of 8 warps (32 x 16 each), 64 deep, a ring of 4
//     stages, two blocks an SM (92 KB each): the race shape's 512 x 1,000
//     output is 128 blocks of 8 warps;
//   * the epilogue adds the bias and applies the activation to the
//     accumulator fragments in registers and stores pairs where the output
//     row allows.
#include <algorithm>

#include "common.cuh"

namespace taper {

namespace {

constexpr int BM = 64, BN = 64, BK = 64, STAGES = 4;
constexpr int WARPS_M = 2, WARPS_N = 4, THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 32 x 16
constexpr int FM = WM / 16, FN = WN / 8;             // m16n8 fragments
// Every staged tile, either layout, is 64 rows of 64 elements; a row has
// room for its 9 raw windows (64 + 8 elements), which also keeps ldmatrix's
// 8 rows in 8 distinct 16-byte bank groups (144 bytes apart).
constexpr int LD = 64 + 8;
constexpr int TILE = 64 * LD;     // elements
constexpr int STAGE = 2 * TILE;   // A, then B
constexpr int CHUNKS = 64 / 8;    // 16-byte chunks of a tile row
constexpr int WINDOWS = CHUNKS + 1;
// the ring, then the realigned A and B tiles
constexpr size_t SMEM_BYTES = (size_t)(STAGES * STAGE + 2 * TILE) * 2;

// One operand as it lies: row-major [rows, cols] with a row stride of
// ``ld`` elements; ``end``: the address of the byte after its last
// element; ``win``: staged through windows (else streamed).
struct Operand {
  const __nv_bfloat16* p;
  int rows, cols, ld;
  uintptr_t end;
  bool win;
};

// 16-byte global->shared copy of the first ``bytes`` (0-16) bytes at
// ``src`` (16-byte aligned), the rest zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, uintptr_t src,
                                             int bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// A thread's share of staging one operand, set up once: its load slots
// (up to 3 of the tile's 64 x 9 windows, or 2 of its 64 x 8 chunks) and
// its 2 realign slots (chunks of the realigned tile).  The K tiles are 64
// deep, a multiple of 8, so a tile row's offset from the 16-byte grid is
// the same in every K tile, and each slot's address moves by one fixed
// step a tile (a K-major row by 128 bytes, an M/N-major tile by 64 rows).
struct Staging {
  uintptr_t w[3];   // a load slot's address at K tile 0
  int dst[3];       // its element offset in the tile
  int lim[3];       // it copies at K tile kt while 64 kt < lim
  int o[2];         // a realign slot's row offset from the grid, 0-7
  int rlim[2];      // its row holds data at K tile kt while 64 kt < rlim
  int valid[2];     // its chunk's elements inside the row at K tile 0
};

constexpr int NONE = -(1 << 30);  // a limit no K tile is under
constexpr int ALL = 1 << 30;      // a limit every K tile is under

// The thread's slots of the operand whose 64-row tile starts at M/N index
// ``mn0`` (K_MAJOR: the tile's rows are M/N indices, else K indices).
template <bool K_MAJOR>
__device__ __forceinline__ Staging stage_setup(const Operand& op, int mn0) {
  Staging st;
  const int width = op.win ? WINDOWS : CHUNKS;
  // a tile row's limit and its address (row r, the tile's first column)
  auto row = [&](int r, int& lim, uintptr_t& at) {
    const int gr = K_MAJOR ? mn0 + r : r, c0 = K_MAJOR ? 0 : mn0;
    lim = K_MAJOR ? (gr < op.rows ? ALL : NONE) : op.rows - r;
    at = reinterpret_cast<uintptr_t>(op.p + (size_t)gr * op.ld + c0);
  };
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int c = threadIdx.x + s * THREADS;
    const int r = c / width, j = c % width;
    st.dst[s] = r * LD + 8 * j;
    st.lim[s] = NONE;
    st.w[s] = 0;
    if (c >= 64 * width) continue;
    row(r, st.lim[s], st.w[s]);
    if (op.win) {
      st.w[s] = (st.w[s] & ~uintptr_t(15)) + 16 * j;
    } else {
      st.w[s] += 16 * j;
      // the chunk's columns: K-major, past the row's end from some K tile
      // on; M/N-major, inside or outside in every tile
      const int cols = K_MAJOR ? op.cols - 8 * j
                               : (mn0 + 8 * j < op.cols ? ALL : NONE);
      st.lim[s] = min(st.lim[s], cols);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = threadIdx.x + s * THREADS;
    const int r = c / CHUNKS, q = c % CHUNKS;
    uintptr_t at;
    row(r, st.rlim[s], at);
    st.o[s] = (int)((at >> 1) & 7);
    st.valid[s] = op.cols - (K_MAJOR ? 0 : mn0) - 8 * q;
  }
  return st;
}

// Starts the copy of K tile ``kt`` of the operand into ``S``: streamed,
// 16-byte chunks all in or all out; or, windowed, each row's 9 aligned
// windows from the one that holds its first element, cut at the tensor's
// end (rows past the matrix are not copied: the realign pass zeroes them).
template <bool K_MAJOR>
__device__ __forceinline__ void stage_load(const Staging& st,
                                           const Operand& op,
                                           __nv_bfloat16* S, int kt) {
  const uintptr_t step = K_MAJOR ? 2 * BK : (uintptr_t)2 * BK * op.ld;
  const uintptr_t base = reinterpret_cast<uintptr_t>(op.p) & ~uintptr_t(15);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bool in = BK * kt < st.lim[s];
    const uintptr_t w = st.w[s] + kt * step;
    if (op.win) {
      if (!in) continue;
      const intptr_t left = (intptr_t)(op.end - w);
      const int bytes = left >= 16 ? 16 : left > 0 ? (int)left : 0;
      cp_async16_n(S + st.dst[s], bytes > 0 ? w : base, bytes);
    } else if (s < 2) {  // 512 chunks: two a thread, all in or all out
      cp_async16_n(S + st.dst[s], in ? w : base, in ? 16 : 0);
    }
  }
}

// The 8 elements that start ``o`` (0-7) elements into the 16 of ``lo``,
// ``hi``.
__device__ __forceinline__ uint4 shift_window(uint4 lo, uint4 hi, int o) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = o >> 1;
  uint32_t s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    s[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  // an odd offset takes the high half of one word and the low of the next
  const uint32_t sel = (o & 1) ? 0x5432 : 0x3210;
  return make_uint4(__byte_perm(s[0], s[1], sel), __byte_perm(s[1], s[2], sel),
                    __byte_perm(s[2], s[3], sel),
                    __byte_perm(s[3], s[4], sel));
}

// ``v`` with its elements from ``valid`` (1-7) on set to zero.
__device__ __forceinline__ uint4 keep_first(uint4 v, int valid) {
  uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = 2 * i + 1 < valid ? x[i] : 2 * i < valid ? x[i] & 0xFFFFu : 0u;
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// The realign pass over K tile ``kt``: the raw windows in ``S`` into the
// row-major tile ``D``, each row shifted by its own offset, every element
// past the matrix's rows or columns zero.
template <bool K_MAJOR>
__device__ __forceinline__ void stage_realign(const Staging& st,
                                              __nv_bfloat16* D,
                                              const __nv_bfloat16* S,
                                              int kt) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = threadIdx.x + s * THREADS;
    const int at = (c / CHUNKS) * LD + 8 * (c % CHUNKS);
    const int valid = st.valid[s] - (K_MAJOR ? BK * kt : 0);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (BK * kt < st.rlim[s] && valid > 0) {
      v = shift_window(*reinterpret_cast<const uint4*>(S + at),
                       *reinterpret_cast<const uint4*>(S + at + 8),
                       st.o[s]);
      if (valid < 8) v = keep_first(v, valid);
    }
    *reinterpret_cast<uint4*>(D + at) = v;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A . B: one mma.sync m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float v0, float v1,
                                       bool both, bool pair) {
  if (pair) {
    if constexpr (sizeof(OutT) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  p[0] = from_f32<OutT>(v0);
  if (both) p[1] = from_f32<OutT>(v1);
}

// A_K: a is K-major ([M, K]: modes nt, nn), else M-major ([K, M]: tn).
// B_K: b is K-major ([N, K]: nt), else N-major ([K, N]: nn, tn).  Block
// (x, y) computes the output tile (y, x); warp (wm, wn) its 32 x 16 part.
template <bool A_K, bool B_K, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_realign_kernel(const Operand a, const Operand b,
                        const __nv_bfloat16* __restrict__ bias,
                        OutT* __restrict__ y, int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char realign_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(realign_smem);
  __nv_bfloat16* a_fix = smem + STAGES * STAGE;
  __nv_bfloat16* b_fix = a_fix + TILE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int k_tiles = (K + BK - 1) / BK;

  const Staging sa = stage_setup<A_K>(a, m0), sb = stage_setup<B_K>(b, n0);
  auto load = [&](int kt) {
    __nv_bfloat16* S = smem + (kt % STAGES) * STAGE;
    stage_load<A_K>(sa, a, S, kt);
    stage_load<B_K>(sb, b, S + TILE, kt);
  };

  float acc[FM][FN][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s);
    cp_async_commit();  // one group per stage, empty ones included
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread; stage kt-1 and the fixes free
    if (kt + STAGES - 1 < k_tiles) load(kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % STAGES) * STAGE;
    const __nv_bfloat16* Bs = As + TILE;
    if (a.win || b.win) {
      if (a.win) {
        stage_realign<A_K>(sa, a_fix, As, kt);
        As = a_fix;
      }
      if (b.win) {
        stage_realign<B_K>(sb, b_fix, Bs, kt);
        Bs = b_fix;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[FM][4], bf[4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wm * WM + i * 16;
        if constexpr (A_K)
          ldsm_x4(af[i], As + (m + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             kk + (lane >> 4) * 8);
        else
          ldsm_x4_t(af[i], As + (kk + (lane & 7) + (lane >> 4) * 8) * LD +
                               m + ((lane >> 3) & 1) * 8);
      }
      // both n8 blocks of the warp's 16 columns: bf[0..1] and bf[2..3]
      const int n = wn * WN;
      if constexpr (B_K)
        ldsm_x4(bf, Bs + (n + (lane & 7) + (lane >> 4) * 8) * LD + kk +
                        ((lane >> 3) & 1) * 8);
      else
        ldsm_x4_t(bf, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          n + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          mma16816(acc[i][j], af[i], bf[2 * j], bf[2 * j + 1]);
    }
  }
  cp_async_wait<0>();

  // the fragments (rows g and g + 8, columns 2 t and 2 t + 1 of each
  // m16n8 block) through the bias and the epilogue, pairs stored where N
  // is even
  const int g = lane / 4, t = lane % 4;
  const bool even = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const int col = n0 + wn * WN + j * 8 + 2 * t;
    if (col >= N) continue;
    const bool both = col + 1 < N;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[col]);
      if (both) b1 = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (bias != nullptr) v0 += b0, v1 += b1;
        store2(y + (size_t)row * N + col, epilogue(v0, act),
               epilogue(v1, act), both, both && even);
      }
  }
}

template <bool A_K, bool B_K, typename OutT>
int launch(const Operand& a, const Operand& b, const void* bias, void* y,
           int M, int N, int K, int act, cudaStream_t s) {
  auto kernel = gemm_realign_kernel<A_K, B_K, OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      a, b, static_cast<const __nv_bfloat16*>(bias), static_cast<OutT*>(y),
      M, N, K, act);
  return (int)cudaGetLastError();
}

// The operand ``[rows, cols]`` at ``p`` (row stride ``ld``), windowed or
// streamed; false where it cannot stream as asked.
bool operand(Operand& op, const void* p, int rows, int cols, int ld,
             bool win) {
  op.p = static_cast<const __nv_bfloat16*>(p);
  op.rows = rows, op.cols = cols, op.ld = ld, op.win = win;
  op.end = reinterpret_cast<uintptr_t>(op.p + (size_t)(rows - 1) * ld + cols);
  return ld >= cols &&
         (win || (ld % 8 == 0 && cols % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(p) % 16 == 0));
}

template <typename OutT>
int by_mode(const void* a, const void* b, const void* bias, void* y, int M,
            int N, int K, int lda, int ldb, int mode, int act, int windows,
            cudaStream_t s) {
  Operand oa, ob;
  const bool wa = windows & 1, wb = windows & 2;
  bool ok = mode == 2 ? operand(oa, a, K, M, lda, wa)
                      : operand(oa, a, M, K, lda, wa);
  ok = ok && (mode == 0 ? operand(ob, b, N, K, ldb, wb)
                        : operand(ob, b, K, N, ldb, wb));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch<true, true, OutT>(oa, ob, bias, y, M, N, K, act, s);
  if (mode == 1)
    return launch<true, false, OutT>(oa, ob, nullptr, y, M, N, K, kNone, s);
  return launch<false, false, OutT>(oa, ob, nullptr, y, M, N, K, kNone, s);
}

}  // namespace

// K1 on the realign route: row strides ``lda``, ``ldb`` (elements);
// ``windows``: bit 0 stages a through windows, bit 1 b (ops/gemm.py
// staging), the others stream.
int gemm_realign(const void* a, const void* b, const void* bias, void* y,
                 int M, int N, int K, int lda, int ldb, int mode,
                 int out_dtype, int act, int windows, cudaStream_t s) {
  if (out_dtype == kBFloat16)
    return by_mode<__nv_bfloat16>(a, b, bias, y, M, N, K, lda, ldb, mode,
                                  act, windows, s);
  return by_mode<float>(a, b, bias, y, M, N, K, lda, ldb, mode, act, windows,
                        s);
}

}  // namespace taper
