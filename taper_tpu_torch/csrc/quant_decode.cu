// K12 and K13 on the register-widening mma.sync kernel: the weight-only
// products over int8 codes q[N, K] (K12) or int4 codes packed two to a byte
// [N, K/2] (K13, the even element in the low nibble), f32 out:
//   y[m,n] = scale[n] acc[m,n] - xsum[m] (scale[n] zp[n]) (+ bias[n])
//            (+ relu | sigmoid),
//   acc[m,n] = sum_k bf16(x[m,k]) q[n,k],  xsum[m] = sum_k x[m,k]
// over the unrounded f32 activations (quant.py:57), each epilogue step
// rounded (common.cuh's q_epilogue); a per-tensor scale or zero point is
// read with a stride of 0, a per-channel one with 1 (QTerms).
//
// Replaces the TPU kernels taper_tpu/ops/pallas/quant.py::_q8_kernel (:41,
// launched by _linear_q8_jit) and _q4_kernel (:159, _linear_q4_jit) at the
// shapes ops/quant.py::plan_q routes here: "decode" (M <= 16, the codes'
// rows whole 16-byte units (int8 K % 16 == 0, int4 K % 32 == 0) from
// 16-byte-aligned bases: every projection of a quantized model's decode
// step, one row a slot) and "mma" (every shape quant_sm90.cu's TMA kernel
// cannot take: a ragged K, a misaligned base, or, at M > 16, rows of N f32
// that are not whole 16-byte units, as the PTQ example's 10-way head).
//
// What bounds it on the H100: at decode, bytes.  2 M FLOP a code against
// one byte (int8) or half of one (int4), so the bound is the codes over the
// memory rate (the quantized model's up projection, 8,192 x 2,048 int8: 16
// MB, 5 us).  The design is K1's decode route's (gemm_decode.cu), its
// loader and epilogue changed:
//   * swap A and B: the weight codes are the M side of mma.sync m16n8k16
//     (bf16 in, f32 accumulate), the activations its N side (one n8 tile
//     for groups of 8 rows, two for 16; rows past M read as zeros, no
//     load);
//   * a thread loads 16 contiguous bytes of a code row, 16 int8 or 32 int4
//     codes, and widens them in registers straight into A fragments, as
//     exact bf16 integers (|code| <= 128 fits bf16's 8-bit significand):
//     int8 by widen4 (a byte as the mantissa of 2^23, the bias
//     subtracted in f32), int4 by a nibble as the mantissa of bf16 128
//     less 136 in bf16.  No shared memory stands between the loads and
//     the tensor cores.  The fragment slots take the codes in the order
//     the widening gives (int8: pairs of neighbours; int4: elements i and
//     i + 4 of each 32-bit word), and the activations' B words pair the
//     same k, so the sum over K is unchanged;
//   * the thread loads the 16 or 32 f32 activations of those k, rounds
//     them to bf16 for the B words (quant.py:53) and adds the unrounded
//     values to its row sums in a fixed order;
//   * a block of 8 warps covers 32 weight rows and one group of 8 or 16
//     activation rows (grid y: ops/quant.py::mma_rows sizes the group);
//     its warps take interleaved K steps (64 codes deep for int8, 128 for
//     int4); K is split over a thread-block cluster of ``splits`` blocks
//     (ops/quant.py::decode_splits, M <= 16 only), whose partial sums and
//     row sums meet in rank 0's shared memory in a fixed order (warps, then
//     ranks), behind one cluster barrier; rank 0 applies the epilogue.  One
//     launch, no workspace, the same bits on every call;
//   * the odd shapes (VEC false) load each 16-byte unit in pieces as wide
//     as the row's base allows (codes 16, 8, 4, 2 or 1 bytes, activations
//     4, 2 or 1 floats: the widest power of two dividing both the row's
//     length and the base address), each piece wholly inside the row or
//     zero-filled past its end, so a ragged last unit reads zeros for codes
//     and activations alike.  The aligned shapes (VEC) keep one 16-byte
//     load a unit.
#include "common.cuh"
#include "hopper.cuh"

namespace taper {

namespace {

using hopper::cluster_arrive;
using hopper::cluster_rank;
using hopper::cluster_wait;
using hopper::mma16816;
using hopper::smem_u32;
using hopper::st_cluster_f32;

constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kRows = 32;      // weight rows (output columns) a block
constexpr int kMaxSplits = 8;  // the largest portable cluster

// Eight int4 codes of a word (element i in bits 4i..4i+3, two's
// complement) as four bf16 pairs, pair i holding elements i and i + 4
// (the lower in the low half): each nibble, biased to unsigned, becomes
// the mantissa of bf16 128 (exact below 128) and 136 is subtracted in
// bf16, exactly.
__device__ __forceinline__ uint4 widen8(uint32_t w) {
  const uint32_t u = w ^ 0x88888888u;
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = ((u >> (4 * i)) & 0x000F000Fu) | 0x43004300u;
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
    const uint32_t bias = 0x43084308u;  // bf16 136, twice
    b = __hsub2(b, *reinterpret_cast<const __nv_bfloat162*>(&bias));
    r[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// A thread's share of a warp step for BITS-bit codes: 16 bytes of a code
// row, kPer codes from column k0, as 2 kProducts A words (words 2p and 2p
// + 1 fill fragment slots 2t, 2t + 1 and 2t + 8, 2t + 9 of product p);
// word w pairs the thread's elements first(w) and first(w) + kGap.
template <int BITS>
struct Codes;
template <>
struct Codes<8> {
  static constexpr int kStep = 64, kProducts = 4, kUnroll = 2, kGap = 1;
  __device__ static constexpr int first(int w) { return 2 * w; }
  __device__ static void widen(uint32_t (&a)[8], const uint4& c) {
    const uint32_t in[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v = widen4(in[i]);
      a[2 * i] = v.x;
      a[2 * i + 1] = v.y;
    }
  }
};
template <>
struct Codes<4> {
  static constexpr int kStep = 128, kProducts = 8, kUnroll = 1, kGap = 4;
  __device__ static constexpr int first(int w) { return 8 * (w / 4) + w % 4; }
  __device__ static void widen(uint32_t (&a)[16], const uint4& c) {
    const uint32_t in[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = widen8(in[i]);
      a[4 * i] = v.x;
      a[4 * i + 1] = v.y;
      a[4 * i + 2] = v.z;
      a[4 * i + 3] = v.w;
    }
  }
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&b);
}

// 16 bytes of a code row at ``p`` (``valid`` bytes of the row from ``p``
// on, at least 16 where VEC), in pieces of ``qw`` bytes (16, 8, 4, 2 or
// 1), each wholly inside the row or zero.
template <bool VEC>
__device__ __forceinline__ uint4 load_codes(const uint8_t* p, int valid,
                                            int qw) {
  if (VEC || qw == 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (qw == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (8 * h < valid) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + h);
        w[2 * h] = v.x, w[2 * h + 1] = v.y;
      }
  } else if (qw == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (4 * h < valid) w[h] = __ldg(reinterpret_cast<const uint32_t*>(p) + h);
  } else if (qw == 2) {
#pragma unroll
    for (int h = 0; h < 8; ++h)
      if (2 * h < valid)
        w[h / 2] |= (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(p) + h)
                    << (16 * (h % 2));
  } else {
#pragma unroll
    for (int h = 0; h < 16; ++h)
      if (h < valid) w[h / 4] |= (uint32_t)__ldg(p + h) << (8 * (h % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// PER activations of a row at ``p`` (``valid`` of the row from ``p`` on, at
// least PER where VEC), in pieces of ``xw`` floats (4, 2 or 1), each wholly
// inside the row or zero.
template <bool VEC, int PER>
__device__ __forceinline__ void load_acts(float (&e)[PER], const float* p,
                                          int valid, int xw) {
  if (VEC || (xw == 4 && valid >= PER)) {
#pragma unroll
    for (int v = 0; v < PER / 4; ++v) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + v);
      e[4 * v] = f.x, e[4 * v + 1] = f.y, e[4 * v + 2] = f.z,
      e[4 * v + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) e[i] = 0.0f;
  if (xw == 4) {
#pragma unroll
    for (int v = 0; v < PER / 4; ++v)
      if (4 * v < valid) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + v);
        e[4 * v] = f.x, e[4 * v + 1] = f.y, e[4 * v + 2] = f.z,
        e[4 * v + 3] = f.w;
      }
  } else if (xw == 2) {
#pragma unroll
    for (int v = 0; v < PER / 2; ++v)
      if (2 * v < valid) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(p) + v);
        e[2 * v] = f.x, e[2 * v + 1] = f.y;
      }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i < valid) e[i] = __ldg(p + i);
  }
}

// Block (x, y): weight rows [32 (x / splits), + 32), cluster rank x %
// splits, which takes K steps [rank * per, (rank + 1) * per) of ceil(K /
// kStep), and activation rows [8 NT y, + 8 NT) (NT n8 tiles).  qw, xw:
// the code and activation load widths (VEC: 16 bytes, 4 floats, whole
// units).
template <int BITS, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    linear_q_mma_kernel(const float* __restrict__ x,
                        const uint8_t* __restrict__ q, const QTerms qt,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int M, int N, int K, int act,
                        int splits, int qw, int xw) {
  using C = Codes<BITS>;
  constexpr int kPer = C::kStep / 4;        // codes a thread loads a row
  // steps whose loads a warp keeps in flight (one at NT 2: registers)
  constexpr int kUnroll = NT == 1 ? C::kUnroll : 1;
  constexpr int kWords = 2 * C::kProducts;  // A words of those codes
  // each warp's partial [16 M, 32 rows] and row sums; in rank 0, every
  // rank's block sums, then the row sums
  __shared__ float red[kWarps][16][kRows];
  __shared__ float xred[kWarps][16];
  __shared__ float gather[kMaxSplits][16 * kRows + 16];
  __shared__ float xsum[16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = splits > 1 ? (int)cluster_rank() : 0;
  // the cluster's first phase: every block has started (rank 0's shared
  // memory is there to be written); waited for after the products
  if (splits > 1) cluster_arrive<false>();
  const int n0 = blockIdx.x / splits * kRows, m0 = blockIdx.y * 8 * NT;
  const int steps = (K + C::kStep - 1) / C::kStep;
  const int per = (steps + splits - 1) / splits;
  const int lo = rank * per, hi = min(steps, lo + per);
  const int row_bytes = K * BITS / 8;

  float acc[2][NT][4], xs[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xs[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * kUnroll) {
    // the loads of up to kUnroll steps first, then their products
    uint4 cv[kUnroll][2][2];
    float xv[kUnroll][NT][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      const int col = s < hi ? s * C::kStep + kPer * t : K;  // K: nothing
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = n0 + 16 * i + 8 * r + g;
          cv[u][i][r] = row < N && col < K
                            ? load_codes<VEC>(
                                  q + (size_t)row * row_bytes + col * BITS / 8,
                                  row_bytes - col * BITS / 8, qw)
                            : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int m = m0 + 8 * j + g;
        if (m < M && col < K) {
          load_acts<VEC>(xv[u][j], x + (size_t)m * K + col, K - col, xw);
        } else {
#pragma unroll
          for (int k = 0; k < kPer; ++k) xv[u][j][k] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t a[2][2][kWords], b[NT][kWords];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) C::widen(a[i][r], cv[u][i][r]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* e = xv[u][j];
#pragma unroll
        for (int k = 0; k < kPer; ++k) xs[j] += e[k];  // unrounded
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          b[j][w] = bf16_pair(e[C::first(w)], e[C::first(w) + C::kGap]);
      }
#pragma unroll
      for (int p = 0; p < C::kProducts; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma16816(acc[i][j], a[i][0][2 * p], a[i][1][2 * p],
                     a[i][0][2 * p + 1], a[i][1][2 * p + 1], b[j][2 * p],
                     b[j][2 * p + 1]);
    }
  }

  // the warp's partial: d0, d1 at (weight row g, activation rows 2t, 2t +
  // 1) of each m16 x n8 tile, d2, d3 at weight row g + 8; its row sums
  // over the four lanes of a row, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][8 * j + 2 * t + (e & 1)][16 * i + g + 8 * (e >> 1)] =
            acc[i][j][e];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float sum = xs[j];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) xred[warp][8 * j + g] = sum;
  }
  __syncthreads();

  // the block's sums in warp order (entry i: activation row m0 + i / 32,
  // weight row i % 32; thread i < 8 NT: row m0 + i's sum), then the
  // cluster's in rank order by rank 0
  constexpr int kEntries = 8 * NT * kRows;
  float v[kEntries / kThreads];
#pragma unroll
  for (int i = 0; i < kEntries / kThreads; ++i) {
    const int at = threadIdx.x + i * kThreads;
    float sum = red[0][at / kRows][at % kRows];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) sum += red[wp][at / kRows][at % kRows];
    v[i] = sum;
  }
  const bool has_row = threadIdx.x < 8 * NT;
  float rs = 0.0f;  // row threadIdx.x's sum
  if (has_row) {
    rs = xred[0][threadIdx.x];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) rs += xred[wp][threadIdx.x];
  }
  if (splits > 1) {
    cluster_wait();
    if (rank != 0) {
      // into rank 0's gather[rank]; the release below publishes them
#pragma unroll
      for (int i = 0; i < kEntries / kThreads; ++i)
        st_cluster_f32(smem_u32(&gather[rank][threadIdx.x + i * kThreads]),
                       0, v[i]);
      if (has_row)
        st_cluster_f32(smem_u32(&gather[rank][16 * kRows + threadIdx.x]), 0,
                       rs);
      cluster_arrive<true>();
      return;
    }
    cluster_arrive<true>();
    cluster_wait();  // every rank's sums are in gather
#pragma unroll
    for (int i = 0; i < kEntries / kThreads; ++i)
      for (int r = 1; r < splits; ++r)
        v[i] += gather[r][threadIdx.x + i * kThreads];
    if (has_row)
      for (int r = 1; r < splits; ++r)
        rs += gather[r][16 * kRows + threadIdx.x];
  }
  if (has_row) xsum[threadIdx.x] = rs;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kEntries / kThreads; ++i) {
    const int at = threadIdx.x + i * kThreads;
    const int ml = at / kRows, m = m0 + ml, n = n0 + at % kRows;
    if (m < M && n < N)
      y[(size_t)m * N + n] =
          q_epilogue(v[i], xsum[ml], qt.s(n), qt.z(n), bias, n, act);
  }
}

template <int BITS, int NT, bool VEC>
int launch(const float* x, const uint8_t* q, const QTerms& qt,
           const float* bias, float* y, int M, int N, int K, int act,
           int splits, int qw, int xw, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kRows - 1) / kRows * splits),
                     (unsigned)((M + 8 * NT - 1) / (8 * NT)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one block: no cluster
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, linear_q_mma_kernel<BITS, NT, VEC>, x, q, qt, bias, y, M, N, K,
      act, splits, qw, xw);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BITS, bool VEC>
int launch_rows(const float* x, const uint8_t* q, const QTerms& qt,
                const float* bias, float* y, int M, int N, int K, int act,
                int splits, int rows, int qw, int xw, cudaStream_t s) {
  return rows == 8 ? launch<BITS, 1, VEC>(x, q, qt, bias, y, M, N, K, act,
                                          splits, qw, xw, s)
                   : launch<BITS, 2, VEC>(x, q, qt, bias, y, M, N, K, act,
                                          splits, qw, xw, s);
}

}  // namespace

// K12 (bits 8) / K13 (bits 4) on the mma.sync kernel: any M in groups of
// ``rows`` (8 or 16) activation rows, K split over a cluster of
// ``splits`` (1..8) blocks.  ``decode`` (the decode route) takes only the
// aligned shapes at M <= 16: K a multiple of 16 (int8) or 32 (int4), x and
// q 16-byte aligned.  Otherwise any K (even for int4) and any base (x
// 4-byte aligned).
int linear_q_mma(const float* x, const uint8_t* q, const QTerms& qt,
                 const float* bias, float* y, int M, int N, int K, int bits,
                 int act, int splits, int rows, bool decode,
                 cudaStream_t s) {
  if (splits < 1 || splits > kMaxSplits || (rows != 8 && rows != 16) ||
      (uintptr_t)x % 4)
    return (int)cudaErrorInvalidValue;
  // the widest loads both the rows' length and the base allow
  const int row_bytes = K * bits / 8;
  int qw = 16, xw = 4;
  while (qw > 1 && (row_bytes % qw || (uintptr_t)q % qw)) qw /= 2;
  while (xw > 1 && (K % xw || (uintptr_t)x % (4 * xw))) xw /= 2;
  const bool vec = qw == 16 && xw == 4;
  if (decode && (M > 16 || !vec)) return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return vec ? launch_rows<8, true>(x, q, qt, bias, y, M, N, K, act,
                                      splits, rows, qw, xw, s)
               : launch_rows<8, false>(x, q, qt, bias, y, M, N, K, act,
                                       splits, rows, qw, xw, s);
  return vec ? launch_rows<4, true>(x, q, qt, bias, y, M, N, K, act, splits,
                                    rows, qw, xw, s)
             : launch_rows<4, false>(x, q, qt, bias, y, M, N, K, act, splits,
                                     rows, qw, xw, s);
}

}  // namespace taper
