// Direct stride-1 convolution over NCHW activations and OIHW weights, f32:
//   conv_fwd  y[n,o,y,x] = act(b[o] + sum_{c,i,j} w[o,c,i,j] *
//                                   x[n,c,y+i-ph,x+j-pw])
//             (also the input gradient: run on the output gradient with
//              the flipped, in/out-swapped weights and padding k-1-p; the
//              kernel reads the forward's weights in that order itself)
//   conv_dw   dw[o,c,i,j] = sum_{n,y,x} g[n,o,y,x] * x[n,c,y+i-ph,x+j-pw]
// Reads outside the image are zero (the padding).
//
// Replaces the TPU kernels taper_tpu/ops/pallas/conv_direct.py::_fwd_kernel
// (launched by _conv_fwd_nhwc) and ::_dw_kernel (launched by
// _conv_dw_nhwc).  The TPU version pads the input in device memory,
// transposes it to NHWC and assembles a [pixels, C*kh*kw] patch scratch in
// VMEM before one MXU dot.  Here padding is a zero-filling copy, the NCHW
// tensor is read as given, and no patch matrix exists anywhere.
//
// What bounds it on the H100: the reference CNN's and ResNet-8's
// convolutions (C and O of 1 to 128, 3x3, 7x7 to 32x32 planes, batch 256)
// carry 0.1 to 3.7 GFLOP each over a few MB of activations: FLOP bound in
// f32, where the card has 67 TFLOP/s of FMA outside the tensor cores (no
// TF32: the contract is f32 in, f32 out, f32 accumulation).  The first
// layer (C = 1) is bound by the 25.7 MB of its output (forward) or of its
// output gradient (weight gradient).  So the designs keep the FMA pipes
// fed: every shared-memory load feeds 15 to 22 FMAs, copies run ahead of
// the FMAs (cp.async, two stages), and tiles follow the layer's channels
// so that no lane computes a channel the layer does not have.  Measured
// on the H100 (PERF.md): the FMA loops reach ~40-50% of the FMA peak, and
// 4-byte cp.async copies move about one float a cycle an SM, so copies
// are 16 or 8 bytes wide wherever the rows' widths allow.
//
//   * conv_fwd, 3x3 (conv_fwd3_kernel<ROWS>).  A block owns up to 64
//     output channels (OT, the layer's O rounded up to a power of two, at
//     least 8) and a tile of th output rows x 4*TSR columns; each thread
//     computes ROWS (1 or 2) row segments of 4 consecutive pixels x 8
//     output channels (32 or 64 accumulators).  Per input channel it loads
//     the ROWS + 2 halo rows of its segment into registers once (a float4
//     and a float2 each) and applies the three horizontal taps from
//     registers, against two float4 broadcast loads of 8 weights a tap:
//     576 FMAs for 26 loads at two rows.  Two rows where the layer has
//     outputs enough for 12 warps an SM, else one.  Input channels arrive
//     8 at a time (a chunk) through a two-stage cp.async ring: chunk c+1's
//     halo and weights are in flight while chunk c computes.  Weights
//     arrive as the rows they are in memory (coalesced) and are transposed
//     in shared memory to [c][tap][o]; the input gradient (flipped = 1)
//     reads w[c][o][8 - tap] there, so no flipped copy of the weights is
//     ever made.  Where the padding keeps the size (H == Ho) a tile's rows
//     run on across images (an odd plane gets a zero row after it, so a
//     thread's two rows never span two images); a row above or below its
//     image reads a zero row of the stage.  th is chosen on the host from
//     the shapes and the SM count: the fewest cycles on the busiest SM,
//     counting each block's FMAs and its staged floats.
//   * conv_dw, 3x3 (conv_dw3_kernel<PW>).  A block owns all of O (up to
//     128), a group of CG input channels and all 9 taps, over the output
//     pixels of whole images (a split).  Each thread accumulates 8 output
//     channels x 1 input channel x 9 taps (72 accumulators) over a share
//     of the quads (4 consecutive output pixels of a row) of each band of
//     RB output rows: per quad it loads the 3x6 input window into
//     registers (three aligned float4s a row, PW picking the six) and, per
//     output channel, one float4 of g: 288 FMAs for 17 loads.  g
//     ([o][row][x], as in memory) and the input halo ([c][rows+2][cols+8],
//     input column 0 on a 16-byte boundary, pitches padded against bank
//     conflicts) arrive by cp.async in a two-stage ring of bands, 16 bytes
//     a copy where a row is a multiple of 4 floats, 8 where it is even.
//     Threads that share (o, c) but took other quads add their sums in a
//     fixed order at the end; each split writes its partial to [splits, O,
//     C*9] and split_sum adds the splits in a fixed order.  No atomics:
//     the result is the same bits from run to run.
//   * Other filter sizes (not on any path of the port) keep the first
//     port's kernels: conv_fwd_kernel (an implicit GEMM over 128 pixels x
//     32 output channels) and conv_dw_kernel (a 64 x 64 tile of [O] x
//     [C*kh*kw] over masked patch gathers), with the same flip and the
//     same split by whole images.  conv_fwd_kernel<3, 3, false> also takes
//     the first layer (C = 1), which writes 25.7 MB for 0.2 GFLOP: bound by
//     its output, where the chunked ring has nothing to overlap and the
//     first port's kernel is as fast.
#include "common.cuh"

namespace taper {
namespace {

// q = n / d for every 32-bit n, with a divisor fixed on the host
// (Granlund and Montgomery): one multiply-high, an add and a shift.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  unsigned un = static_cast<unsigned>(n);
  return static_cast<int>(
      (static_cast<unsigned long long>(__umulhi(un, f.m)) + un) >> f.s);
}

// 4-byte global->shared copy that zero-fills when `in` is false (src must
// still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool in) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = in ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// ---------------------------------------------------------------- K3a, 3x3

constexpr int kFwdChunk = 8;  // input channels a stage carries

struct FwdPlan {
  int OT, log_ot;   // output channels a block (8..64, a power of two)
  int TSR;          // 4-pixel segments a tile row
  int thread_rows;  // output rows a thread computes (1 or 2)
  int th;           // output rows a tile (a multiple of rows)
  int units;        // th / rows * TSR: (rows, segment)s a block, per 8 o
  int cross;        // tiles run over the rows of consecutive images
  int Hv;           // rows an image there: Ho, then zero rows to a multiple
                    // of rows
  int col_tiles, row_tiles;  // row_tiles: tiles an image (cross == 0)
  int Wpad;         // staged row pitch (floats, a multiple of 4)
  int plane;        // floats a staged channel: th + 2 halo rows, 1 zero row
  int CC;           // channels a stage
  int threads;
  FastDiv d_wpad, d_hv, d_tsr, d_units;
};

// Floats of one stage: CC halo planes, then the raw weight rows (for the
// forward OT rows of CC*9 + 1; for the input gradient CC rows of OT*9).
__host__ __device__ inline int fwd_stage_floats(const FwdPlan& p) {
  return p.CC * p.plane + p.CC * 9 * p.OT + p.OT;
}

template <int ROWS>
__global__ void __launch_bounds__(256, 2)
    conv_fwd3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int N, int C, int H, int W, int O, int ph, int pw,
                     int Ho, int Wo, int act, int flipped, FwdPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int OT = p.OT, plane = p.plane, CC = p.CC, Wpad = p.Wpad;
  const int sf = fwd_stage_floats(p);
  float* ws = smem + 2 * sf;  // [CC * 9][OT], transposed weights

  // The tile: output rows [r0, r0 + rows) counted over N * Hv (within one
  // image unless cross), columns [xt0, xt0 + 4 * TSR), channels from o0.
  const int ct = blockIdx.x % p.col_tiles, rt = blockIdx.x / p.col_tiles;
  const int xt0 = ct * p.TSR * 4;
  const int Hv = p.cross ? p.Hv : Ho;
  int r0, rows, n0 = 0, y0 = 0;
  if (p.cross) {
    r0 = rt * p.th;
    rows = min(p.th, N * Hv - r0);
  } else {
    n0 = rt / p.row_tiles;
    y0 = (rt - n0 * p.row_tiles) * p.th;
    r0 = n0 * Ho + y0;
    rows = min(p.th, Ho - y0);
  }
  const int o0 = blockIdx.y * OT;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;

  // This thread: 8 output channels (cg) x the segment seg of the ROWS
  // output rows from ROWS * rp of the tile.  They never span two images:
  // Hv and th are multiples of ROWS.
  const int cg = fdiv(tid, p.d_units);
  const int q = tid - cg * p.units;
  const int rp = fdiv(q, p.d_tsr), seg = q - rp * p.TSR;
  const int rr = ROWS * rp;
  const bool live = cg * 8 < OT && rr < rows;
  const int r = r0 + (live ? rr : 0);
  const int n = r / Hv, yy = r - n * Hv;
  // Per halo row of the thread: the staged row, or the zero row (th + 2)
  // where the input row lies outside this image.
  int hoff[ROWS + 2];
#pragma unroll
  for (int i = 0; i < ROWS + 2; ++i) {
    int iy = yy - ph + i;
    bool ok = live && iy >= 0 && iy < H;
    hoff[i] = (ok ? rr + i : p.th + 2) * Wpad + seg * 4;
  }

  // zero rows of both stages
  for (int e = tid; e < 2 * CC * Wpad; e += nthreads) {
    int k = fdiv(e, p.d_wpad), col = e - k * Wpad;
    int st = k / CC, ci = k - st * CC;
    smem[st * sf + ci * plane + (p.th + 2) * Wpad + col] = 0.0f;
  }

  auto issue = [&](int c0, float* st) {
    const int cc = min(CC, C - c0);
    // the halo: th + 2 input rows x Wpad columns from column xt0 - pw
    const int hp = (p.th + 2) * Wpad;
    for (int e = tid; e < hp; e += nthreads) {
      int sr = fdiv(e, p.d_wpad), col = e - sr * Wpad;
      int xc = xt0 - pw + col;
      bool ok = xc >= 0 && xc < W;
      int nn = n0, iy = y0 - ph + sr;
      if (p.cross) {
        int L = r0 - ph + sr;  // input row over N * Hv (H == Ho)
        ok = ok && L >= 0 && L < N * Hv;
        nn = ok ? fdiv(L, p.d_hv) : 0;
        iy = L - nn * Hv;
        ok = ok && iy < H;
      } else {
        ok = ok && iy >= 0 && iy < H;
      }
      const float* src =
          ok ? x + ((static_cast<size_t>(nn) * C + c0) * H + iy) * W + xc : x;
      for (int ci = 0; ci < CC; ++ci) {
        bool in = ok && ci < cc;
        cp_async4(st + ci * plane + e,
                  in ? src + static_cast<size_t>(ci) * H * W : x, in);
      }
    }
    // the weights, row by row as they lie in memory
    float* raw = st + CC * plane;
    if (!flipped) {  // w[o][c][tap]: per o, cc * 9 contiguous floats
      const int rp = CC * 9 + 1;
      for (int row = warp; row < OT; row += nwarps) {
        int o = o0 + row;
        if (o >= O) break;
        const float* src = w + (static_cast<size_t>(o) * C + c0) * 9;
        for (int e = lane; e < cc * 9; e += 32)
          cp_async4(raw + row * rp + e, src + e, true);
      }
    } else {  // w[c][o][tap]: per c, min(OT, O - o0) * 9 contiguous floats
      const int span = min(OT, O - o0) * 9;
      for (int ci = warp; ci < cc; ci += nwarps) {
        const float* src = w + (static_cast<size_t>(c0 + ci) * O + o0) * 9;
        for (int e = lane; e < span; e += 32)
          cp_async4(raw + ci * OT * 9 + e, src + e, true);
      }
    }
  };

  // ws[(ci * 9 + tap) * OT + oo] = w'[o0 + oo][c0 + ci][tap]; consecutive
  // lanes take consecutive oo: the writes are conflict-free, and the reads
  // stride by an odd count of floats (CC * 9 + 1, or 9).
  auto transpose = [&](const float* raw, int cc) {
    const int rp = CC * 9 + 1;
    for (int e = tid; e < cc * 9 * OT; e += nthreads) {
      int oo = e & (OT - 1), k = e >> p.log_ot;
      float v = 0.0f;
      if (o0 + oo < O) {
        if (flipped) {
          int ci = k / 9, tap = k - ci * 9;
          v = raw[(ci * OT + oo) * 9 + 8 - tap];
        } else {
          v = raw[oo * rp + k];
        }
      }
      ws[e] = v;
    }
  };

  float acc[ROWS][4][8];
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.0f;

  const int nchunks = (C + CC - 1) / CC;
  issue(0, smem);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    float* st = smem + (k & 1) * sf;
    if (k + 1 < nchunks) {
      issue((k + 1) * CC, smem + ((k + 1) & 1) * sf);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cc = min(CC, C - k * CC);
    transpose(st + CC * plane, cc);
    __syncthreads();
    const float* wb = ws + min(cg, OT / 8 - 1) * 8;  // warp padding: in range
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = st + ci * plane;
      const float* wc = wb + ci * 9 * OT;
      // halo row i (and i + 1) feeds filter row i of output row 0 (and 1)
      float h[2][6];
      auto load = [&](float* v, int i) {
        float4 a = *reinterpret_cast<const float4*>(xc + hoff[i]);
        float2 b = *reinterpret_cast<const float2*>(xc + hoff[i] + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x,
        v[5] = b.y;
      };
      load(h[0], 0);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (ROWS == 2)
          load(h[(i + 1) & 1], i + 1);
        else if (i > 0)
          load(h[i & 1], i);
        const float* top = h[i & 1];
        const float* bot = h[(i + 1) & 1];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4* wk =
              reinterpret_cast<const float4*>(wc + (i * 3 + j) * OT);
          float4 w0 = wk[0], w1 = wk[1];
          float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              acc[0][pp][kk] = fmaf(top[pp + j], wv[kk], acc[0][pp][kk]);
              if (ROWS == 2)
                acc[ROWS - 1][pp][kk] =
                    fmaf(bot[pp + j], wv[kk], acc[ROWS - 1][pp][kk]);
            }
        }
      }
    }
    __syncthreads();  // the stage and ws are free for the next chunk
  }

  if (!live) return;
  const int xb = xt0 + seg * 4;
  const bool vec = (Wo & 3) == 0 && xb + 3 < Wo;
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    if (rr + a >= rows || yy + a >= Ho) break;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      int o = o0 + cg * 8 + kk;
      if (o < O) {
        float bo = bias != nullptr ? bias[o] : 0.0f;
        float v[4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          v[pp] = epilogue(acc[a][pp][kk] + bo, act);
        float* out =
            y + ((static_cast<size_t>(n) * O + o) * Ho + yy + a) * Wo + xb;
        if (vec) {
          *reinterpret_cast<float4*>(out) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            if (xb + pp < Wo) out[pp] = v[pp];
        }
      }
    }
  }
}

// Host tiling of conv_fwd3_kernel with `rows` output rows a thread.  th
// minimises the busiest SM's cycles: ceil(blocks / SMs) blocks, each
// with its FMAs (threads * C * 9 * 32 * rows over 128 lanes, idle lanes
// of the last warp included) and its staged floats (every weight of its
// OT channels and th + 2 halo rows a channel, ~4 floats a cycle).
FwdPlan fwd3_plan(int N, int C, int H, int O, int Ho, int Wo, int rows) {
  FwdPlan p{};
  p.thread_rows = rows;
  p.OT = 8;
  while (p.OT < O && p.OT < 64) p.OT *= 2;
  p.log_ot = 0;
  while ((1 << p.log_ot) < p.OT) ++p.log_ot;
  const int OG = p.OT / 8, max_units = 256 / OG;
  const int SR = (Wo + 3) / 4;
  p.col_tiles = (SR + max_units - 1) / max_units;
  p.TSR = (SR + p.col_tiles - 1) / p.col_tiles;
  p.cross = Ho == H && p.col_tiles == 1;
  p.Hv = (Ho + rows - 1) / rows * rows;
  p.Wpad = (p.TSR * 4 + 2 + 3) / 4 * 4;
  const int o_tiles = (O + p.OT - 1) / p.OT;
  const long R = static_cast<long>(N) * p.Hv;
  const long sms = sm_count();
  double best = -1.0;
  for (int units = 1; units * p.TSR <= max_units; ++units) {
    int th = rows * units;
    if (!p.cross && th >= Ho + rows) break;
    long tiles;
    int row_tiles = 0;
    if (p.cross) {
      tiles = (R + th - 1) / th;
    } else {
      row_tiles = (Ho + th - 1) / th;
      th = (Ho + row_tiles - 1) / row_tiles;
      th = (th + rows - 1) / rows * rows;
      tiles = static_cast<long>(N) * row_tiles;
    }
    long blocks = tiles * p.col_tiles * o_tiles;
    long threads = (OG * th / rows * p.TSR + 31) / 32 * 32;
    double fma = static_cast<double>(threads) * C * 9 * 32 * rows / 128;
    double staged = static_cast<double>(C) * (9 * p.OT + (th + 2) * p.Wpad);
    double cost = static_cast<double>((blocks + sms - 1) / sms) *
                  (fma + staged / 4);
    if (best < 0 || cost < best) {
      best = cost;
      p.th = th;
      p.row_tiles = row_tiles;
    }
  }
  p.units = p.th / rows * p.TSR;
  p.threads = (OG * p.units + 31) / 32 * 32;
  p.plane = (p.th + 3) * p.Wpad;
  p.CC = C < kFwdChunk ? C : kFwdChunk;
  p.d_wpad = make_div(p.Wpad);
  p.d_hv = make_div(p.Hv);
  p.d_tsr = make_div(p.TSR);
  p.d_units = make_div(p.units);
  return p;
}

// Two rows a thread (half the shared loads a FMA) where the layer has
// outputs enough for 12 warps an SM at two rows, else one.
FwdPlan fwd3_plan(int N, int C, int H, int O, int Ho, int Wo) {
  double per_sm = static_cast<double>(N) * Ho * ((Wo + 3) / 4) *
                  ((O + 7) / 8) / 2 / sm_count();
  return fwd3_plan(N, C, H, O, Ho, Wo, per_sm >= 384 ? 2 : 1);
}

// ----------------------------------------------- K3a, other filter sizes

constexpr int kFwdThreads = 128;  // 4 warps
constexpr int kFwdPix = 128;      // output pixels per tile, 4 per lane
constexpr int kFwdOut = 32;       // output channels per tile, 8 per warp

// KH_/KW_ > 0 fix the filter size at compile time; 0 reads kh/kw.
// FLIP reads the forward's w[c][o] flipped (the input gradient).
template <int KH_, int KW_, bool FLIP>
__global__ void __launch_bounds__(kFwdThreads)
    conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int N, int C, int H, int W, int O, int kh_, int kw_,
                    int ph, int pw, int Ho, int Wo, int nb, int th, int tw,
                    int cc, int act) {
  const int kh = KH_ > 0 ? KH_ : kh_;
  const int kw = KW_ > 0 ? KW_ : kw_;
  const int taps = kh * kw;
  const int hh = th + kh - 1, ww = tw + kw - 1;
  const int plane = nb * hh * ww;  // halo floats per input channel
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                // [cc][nb][hh][ww]
  float* ws = smem + ((cc * plane + 3) & ~3);      // [cc*taps][kFwdOut]

  const int tiles_x = (Wo + tw - 1) / tw, tiles_y = (Ho + th - 1) / th;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * tw;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * th;
  const int n0 = (t / tiles_y) * nb;
  const int o0 = blockIdx.y * kFwdOut;
  const int lane = threadIdx.x & 31;
  const int og = threadIdx.x >> 5;  // this warp's 8 output channels

  int hbase[4];
  size_t ybase[4];
  bool live[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int q = lane + 32 * p;
    int img = q / (th * tw), r = (q / tw) % th, c = q % tw;
    bool in_tile = q < nb * th * tw;
    int n = n0 + img, yy = y0 + r, xx = x0 + c;
    live[p] = in_tile && n < N && yy < Ho && xx < Wo;
    hbase[p] = in_tile ? (img * hh + r) * ww + c : 0;
    ybase[p] = live[p] ? ((size_t)n * O * Ho + yy) * Wo + xx : 0;
  }
  float acc[4][8] = {};

  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = threadIdx.x; e < cc * plane; e += kFwdThreads) {
      int q = e % ww, r = e / ww;
      int rr = r % hh;
      r /= hh;
      int img = r % nb, ci = r / nb;
      int gy = y0 - ph + rr, gx = x0 - pw + q, gn = n0 + img, gc = c0 + ci;
      xs[e] = (gn < N && gc < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? x[(((size_t)gn * C + gc) * H + gy) * W + gx]
                  : 0.0f;
    }
    // ws[(ci*taps + tap)*32 + oo] = w'[o0+oo, c0+ci, tap]: w[o][c][tap],
    // or, flipped, w[c][o][taps - 1 - tap]
    for (int e = threadIdx.x; e < cc * taps * kFwdOut; e += kFwdThreads) {
      int oo = e % kFwdOut, k = e / kFwdOut;
      int ci = k / taps, o = o0 + oo, c = c0 + ci, tap = k - ci * taps;
      float v = 0.0f;
      if (o < O && c < C)
        v = FLIP ? w[((size_t)c * O + o) * taps + (taps - 1 - tap)]
                 : w[((size_t)o * C + c) * taps + tap];
      ws[e] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < cc; ++ci) {
      const float* xc = xs + ci * plane;
      const float* wc = ws + ci * taps * kFwdOut + og * 8;
#pragma unroll
      for (int i = 0; i < kh; ++i)
#pragma unroll
        for (int j = 0; j < kw; ++j) {
          const float4* wk =
              reinterpret_cast<const float4*>(wc + (i * kw + j) * kFwdOut);
          float4 w0 = wk[0], w1 = wk[1];
          float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
          int off = i * ww + j;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float xv = xc[hbase[p] + off];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[p][k] = fmaf(xv, wv[k], acc[p][k]);
          }
        }
    }
  }

  const size_t ostride = (size_t)Ho * Wo;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int o = o0 + og * 8 + k;
    if (o >= O) break;
    float bo = bias != nullptr ? bias[o] : 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (live[p]) y[ybase[p] + o * ostride] = epilogue(acc[p][k] + bo, act);
  }
}

// Output tile of conv_fwd_kernel: nb images x th rows x tw columns, at
// most kFwdPix pixels, rows balanced across the row tiles.
void fwd_tile(int N, int Ho, int Wo, int* nb, int* th, int* tw) {
  *tw = Wo < 32 ? Wo : 32;
  int rows = kFwdPix / *tw;
  if (rows > Ho) rows = Ho;
  int row_tiles = (Ho + rows - 1) / rows;
  *th = (Ho + row_tiles - 1) / row_tiles;
  *nb = 1;
  if (*th == Ho && *tw == Wo) {
    *nb = kFwdPix / (Ho * Wo);
    if (*nb > N) *nb = N;
  }
}

// ---------------------------------------------------------------- K3b, 3x3

constexpr int kDwThreads = 256;
constexpr int kDwStageFloats = 13312;  // 52 KB: two stages, two blocks/SM
constexpr int kRedPitch = 73;          // 72 partial sums, odd pitch

struct DwPlan {
  int OG, CG, PS;    // 8-channel groups of O, input channels, quad strips
  int RB, bpi;       // output rows a band, bands an image
  int WP, XP, P;     // g row pitch, halo row pitch, halo plane pitch
  int g2;            // else, Wo even: Wo / 2 float2s of g a row, else 0
  int xv, xn;        // input rows copied xv (4, 2 or 1) floats at a time,
                     // xn = W / xv copies a row (xv > 1)
  int GO;            // floats an 8-channel group of g: 8 * RB * WP + 4
  int Q, NQ;         // quads a row, quads a band
  int stage;         // floats a stage: OG * GO + CG * P
  int ipb;           // images a split
  int run4;          // Wo % 4 == 0: RB * Wo / 4 float4s of g a channel
  FastDiv d_wp, d_rb, d_xp, d_rb2, d_q, d_bpi, d_cg, d_og, d_run4, d_g2,
      d_xn;
};

// Halo column of input column ix: ix + kXOff, so that input column 0 (and
// every fourth after it) lies on a 16-byte boundary, as in memory.
constexpr int kXOff = 4;

template <int PW>
__global__ void __launch_bounds__(kDwThreads, 2)
    conv_dw3_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ part, int N, int C, int H, int W,
                    int O, int ph, int Ho, int Wo, DwPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c0 = blockIdx.y * p.CG, cgn = min(p.CG, C - c0);
  const int n_begin = blockIdx.x * p.ipb;
  const int n_count = max(0, min(N, n_begin + p.ipb) - n_begin);
  const int nbands = n_count * p.bpi;
  const int RB = p.RB, WP = p.WP, XP = p.XP, OT = p.OG * 8;

  // This thread: input channel c, output channels og*8.., quad strip s.
  const int rest = fdiv(tid, p.d_cg), c = tid - rest * p.CG;
  const int s = fdiv(rest, p.d_og), og = rest - s * p.OG;

  auto issue = [&](int b, float* st) {
    const int bi = fdiv(b, p.d_bpi);
    const int n = n_begin + bi, y0 = (b - bi * p.bpi) * RB;
    // g rows y0 .. y0+RB-1 of every output channel: [og][o&7][r][x];
    // where Wo % 4 == 0 (WP == Wo) a channel's rows are one run of floats
    // in memory and in the stage, copied 16 bytes at a time
    if (p.run4 > 0) {
      const int valid = min(RB, Ho - y0) * Wo;
      for (int e = tid; e < OT * p.run4; e += nthreads) {
        int o = fdiv(e, p.d_run4), f = (e - o * p.run4) * 4;
        bool in = o < O && f < valid;
        const float* src =
            in ? g + ((static_cast<size_t>(n) * O + o) * Ho + y0) * Wo + f
               : g;
        cp_async16(st + (o >> 3) * p.GO + (o & 7) * RB * WP + f, src, in);
      }
    }
    if (p.g2 > 0) {  // Wo even: a row at a time, 8 bytes a copy
      for (int e = tid; e < OT * RB * p.g2; e += nthreads) {
        int t1 = fdiv(e, p.d_g2), xw = (e - t1 * p.g2) * 2;
        int o = fdiv(t1, p.d_rb), r = t1 - o * RB;
        bool in = o < O && y0 + r < Ho;
        const float* src =
            in ? g + ((static_cast<size_t>(n) * O + o) * Ho + y0 + r) * Wo + xw
               : g;
        cp_async8(st + (o >> 3) * p.GO + ((o & 7) * RB + r) * WP + xw, src,
                  in);
      }
    }
    const int gtotal = p.run4 > 0 || p.g2 > 0 ? 0 : OT * RB * WP;
    for (int e = tid; e < gtotal; e += nthreads) {
      int t1 = fdiv(e, p.d_wp), xw = e - t1 * WP;
      int o = fdiv(t1, p.d_rb), r = t1 - o * RB;
      bool in = o < O && y0 + r < Ho && xw < Wo;
      const float* src =
          in ? g + ((static_cast<size_t>(n) * O + o) * Ho + y0 + r) * Wo + xw
             : g;
      cp_async4(st + (o >> 3) * p.GO + ((o & 7) * RB + r) * WP + xw, src, in);
    }
    // the input halo: rows y0-ph .. y0-ph+RB+1, columns -kXOff ..
    // XP-1-kXOff; where W is even xv floats at a time over columns 0 ..
    // W-1 (the others stay the zeros written at the start)
    float* xs = st + p.OG * p.GO;
    if (p.xv > 1) {
      for (int e = tid; e < p.CG * (RB + 2) * p.xn; e += nthreads) {
        int t1 = fdiv(e, p.d_xn), ix = (e - t1 * p.xn) * p.xv;
        int ci = fdiv(t1, p.d_rb2), rr = t1 - ci * (RB + 2);
        int iy = y0 - ph + rr;
        bool in = ci < cgn && iy >= 0 && iy < H;
        const float* src =
            in ? x + ((static_cast<size_t>(n) * C + c0 + ci) * H + iy) * W + ix
               : x;
        float* dst = xs + ci * p.P + rr * XP + kXOff + ix;
        if (p.xv == 4)
          cp_async16(dst, src, in);
        else
          cp_async8(dst, src, in);
      }
      return;
    }
    const int xtotal = p.CG * (RB + 2) * XP;
    for (int e = tid; e < xtotal; e += nthreads) {
      int t1 = fdiv(e, p.d_xp), pos = e - t1 * XP;
      int ci = fdiv(t1, p.d_rb2), rr = t1 - ci * (RB + 2);
      int iy = y0 - ph + rr, ix = pos - kXOff;
      bool in = ci < cgn && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src =
          in ? x + ((static_cast<size_t>(n) * C + c0 + ci) * H + iy) * W + ix
             : x;
      cp_async4(xs + ci * p.P + rr * XP + pos, src, in);
    }
  };

  // the columns that the vector copies never write: zeros, once (the
  // halo's outside 0 .. W-1, g's from Wo to its pitch)
  if (p.xv > 1) {
    const int border = XP - W;
    for (int e = tid; e < 2 * p.CG * (RB + 2) * border; e += nthreads) {
      int row = e / border, k = e - row * border;
      int pos = k < kXOff ? k : k + W;
      int st = row / (p.CG * (RB + 2)), rest = row - st * p.CG * (RB + 2);
      int ci = rest / (RB + 2), rr = rest - ci * (RB + 2);
      smem[st * p.stage + p.OG * p.GO + ci * p.P + rr * XP + pos] = 0.0f;
    }
  }
  if (p.g2 > 0) {
    const int border = WP - Wo;
    for (int e = tid; e < 2 * OT * RB * border; e += nthreads) {
      int row = e / border, k = e - row * border;
      int st = row / (OT * RB), rest = row - st * OT * RB;
      int o = rest / RB, r = rest - o * RB;
      smem[st * p.stage + (o >> 3) * p.GO + ((o & 7) * RB + r) * WP + Wo +
           k] = 0.0f;
    }
  }

  float acc[8][9];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 9; ++b) acc[a][b] = 0.0f;

  if (nbands > 0) {
    issue(0, smem);
    cp_async_commit();
  }
  for (int b = 0; b < nbands; ++b) {
    const float* st = smem + (b & 1) * p.stage;
    if (b + 1 < nbands) {
      issue(b + 1, smem + ((b + 1) & 1) * p.stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* gb0 = st + og * p.GO;
    const float* xb0 = st + p.OG * p.GO + c * p.P;
    for (int qd = s; qd < p.NQ; qd += p.PS) {
      const int r = fdiv(qd, p.d_q), x0 = (qd - r * p.Q) * 4;
      // halo columns x0 + kXOff - PW .. + 5 of rows r .. r + 2, from the
      // three aligned float4s at x0, x0 + 4, x0 + 8 (PW picks which)
      const float* xb = xb0 + r * XP + x0;
      float win[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float v[12];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float4 a = *reinterpret_cast<const float4*>(xb + i * XP + 4 * k);
          v[4 * k] = a.x;
          v[4 * k + 1] = a.y;
          v[4 * k + 2] = a.z;
          v[4 * k + 3] = a.w;
        }
#pragma unroll
        for (int m = 0; m < 6; ++m) win[i][m] = v[kXOff - PW + m];
      }
      const float* gb = gb0 + r * WP + x0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float4 gv = *reinterpret_cast<const float4*>(gb + k * RB * WP);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float a = acc[k][i * 3 + j];
            a = fmaf(gv.x, win[i][j], a);
            a = fmaf(gv.y, win[i][j + 1], a);
            a = fmaf(gv.z, win[i][j + 2], a);
            a = fmaf(gv.w, win[i][j + 3], a);
            acc[k][i * 3 + j] = a;
          }
      }
    }
    __syncthreads();  // the stage is free for band b + 2
  }

  // Strips s > 0 hand their sums to strip 0, which adds them in order.
  const int pairs = p.OG * p.CG, pair = og * p.CG + c;
  float* red = smem;
  if (s > 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        red[((s - 1) * pairs + pair) * kRedPitch + k * 9 + t] = acc[k][t];
  }
  __syncthreads();
  if (s != 0 || c >= cgn) return;
  for (int ss = 1; ss < p.PS; ++ss) {
    const float* src = red + ((ss - 1) * pairs + pair) * kRedPitch;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[k][t] += src[k * 9 + t];
  }
  float* out = part + static_cast<size_t>(blockIdx.x) * O * C * 9;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int o = og * 8 + k;
    if (o < O) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
        out[(static_cast<size_t>(o) * C + c0 + c) * 9 + t] = acc[k][t];
    }
  }
}

// Plan of conv_dw3_kernel for CG input channels a block (the caller's
// channel group, ops/conv_direct.py::dw_channel_group); false where it
// does not apply (O > 128, or a row too wide for one band in a stage).
bool dw3_plan(int N, int C, int W, int O, int Ho, int Wo, int splits,
              int CG, DwPlan* out) {
  DwPlan p{};
  p.OG = (O + 7) / 8;
  if (p.OG > 16) return false;
  p.CG = CG;
  p.WP = (Wo + 3) / 4 * 4;
  p.Q = p.WP / 4;
  p.XP = p.WP + 8;
  auto size = [&](int rb, int* P, int* GO) {
    *P = (rb + 2) * p.XP;
    if ((*P / 4) % 2 == 0) *P += 4;  // P / 4 odd: channels spread on banks
    *GO = 8 * rb * p.WP + 4;         // groups of g 4 banks apart
    return p.OG * *GO + p.CG * *P;
  };
  // rows a band: the fewest rows lost to a ragged last band, then the
  // largest that fits a stage
  int best_rb = 0;
  double best_eff = 0.0;
  for (int rb = 1; rb <= Ho; ++rb) {
    int P, GO;
    if (size(rb, &P, &GO) > kDwStageFloats) break;
    int bands = (Ho + rb - 1) / rb;
    double eff = static_cast<double>(Ho) / (bands * rb);
    if (eff >= best_eff) {
      best_eff = eff;
      best_rb = rb;
    }
  }
  if (best_rb == 0) return false;
  p.RB = best_rb;
  p.bpi = (Ho + p.RB - 1) / p.RB;
  p.stage = size(p.RB, &p.P, &p.GO);
  p.NQ = p.RB * p.Q;
  p.PS = 256 / (p.OG * p.CG);
  if (p.PS > p.NQ) p.PS = p.NQ;
  if (p.PS < 1) p.PS = 1;
  p.ipb = (N + splits - 1) / splits;
  p.run4 = Wo % 4 == 0 ? p.RB * Wo / 4 : 0;
  p.d_run4 = make_div(p.run4 > 0 ? p.run4 : 1);
  p.g2 = p.run4 == 0 && Wo % 2 == 0 ? Wo / 2 : 0;
  p.d_g2 = make_div(p.g2 > 0 ? p.g2 : 1);
  p.xv = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;
  p.xn = W / p.xv;
  p.d_xn = make_div(p.xn);
  p.d_wp = make_div(p.WP);
  p.d_rb = make_div(p.RB);
  p.d_xp = make_div(p.XP);
  p.d_rb2 = make_div(p.RB + 2);
  p.d_q = make_div(p.Q);
  p.d_bpi = make_div(p.bpi);
  p.d_cg = make_div(p.CG);
  p.d_og = make_div(p.OG);
  *out = p;
  return true;
}

// ----------------------------------------------- K3b, other filter sizes

constexpr int kDwTile = 64;  // O and C*kh*kw per tile
constexpr int kDwRows = 16;  // output pixels per step

// part[z, o, k] = sum over this split's pixels of g[p, o] * patch[p, k],
// k = (c*kh + i)*kw + j (the OIHW flattening of dw).
__global__ void __launch_bounds__(256)
    conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ part, int N, int C, int H, int W,
                   int O, int kh, int kw, int ph, int pw, int Ho, int Wo,
                   int rows_per_split) {
  __shared__ float Gs[kDwRows][kDwTile + 1];  // Gs[pixel][o]
  __shared__ float Ps[kDwRows][kDwTile + 1];  // Ps[pixel][k]
  const int taps = kh * kw, CK = C * taps, hw = Ho * Wo;
  const int P = N * hw;
  const int o0 = blockIdx.y * kDwTile, k0 = blockIdx.x * kDwTile;
  const int p_begin = blockIdx.z * rows_per_split;
  const int p_end = min(P, p_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int kk = threadIdx.x % kDwRows;
  int xoff[4], di[4], dj[4];
  bool kin[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int k = k0 + threadIdx.x / kDwRows + 16 * s;
    kin[s] = k < CK;
    int c = kin[s] ? k / taps : 0, tap = k - c * taps;
    di[s] = tap / kw - ph;
    dj[s] = tap % kw - pw;
    xoff[s] = c * H * W;
  }
  float acc[4][4] = {};

  for (int p0 = p_begin; p0 < p_end; p0 += kDwRows) {
    int p = p0 + kk;
    bool pin = p < p_end;
    int n = pin ? p / hw : 0, rem = p - n * hw;
    int yy = rem / Wo, xx = rem % Wo;
    const float* gp = g + (size_t)n * O * hw + rem;
    const float* xp = x + (size_t)n * C * H * W;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      int col = threadIdx.x / kDwRows + 16 * s;
      int o = o0 + col;
      Gs[kk][col] = (pin && o < O) ? gp[(size_t)o * hw] : 0.0f;
      int iy = yy + di[s], ix = xx + dj[s];
      Ps[kk][col] = (pin && kin[s] && iy >= 0 && iy < H && ix >= 0 && ix < W)
                        ? xp[xoff[s] + iy * W + ix]
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDwRows; ++r) {
      float gv[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = Ps[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], pv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * O * CK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int o = o0 + ty + 16 * i, k = k0 + tx + 16 * j;
      if (o < O && k < CK) out[(size_t)o * CK + k] = acc[i][j];
    }
}

// dw[e] = sum_z part[z, e] in a fixed order: warp w of a block adds splits
// w, w + 8, ... for 32 consecutive entries, then lane 0's warp adds the 8
// warps' sums in warp order.
__global__ void __launch_bounds__(256)
    split_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                     int count, int splits) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (e < count)
    for (int z = warp; z < splits; z += 8)
      s += part[static_cast<size_t>(z) * count + e];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < count) {
    float t = sums[0][lane];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += sums[k][lane];
    dw[e] = t;
  }
}

}  // namespace
}  // namespace taper

using namespace taper;

extern "C" int taper_conv_fwd(const void* x, const void* w, const void* bias,
                              void* y, int N, int C, int H, int W, int O,
                              int kh, int kw, int ph, int pw, int act,
                              int flipped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int Ho = H + 2 * ph - kh + 1, Wo = W + 2 * pw - kw + 1;
  if (N <= 0 || C <= 0 || O <= 0 || kh <= 0 || kw <= 0 || Ho <= 0 ||
      Wo <= 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(w);
  auto bp = static_cast<const float*>(bias);
  auto yp = static_cast<float*>(y);
  if (kh == 3 && kw == 3 && C > 1) {
    FwdPlan p = fwd3_plan(N, C, H, O, Ho, Wo);
    size_t smem = (2 * (size_t)fwd_stage_floats(p) + (size_t)p.CC * 9 * p.OT) *
                  sizeof(float);
    auto kernel =
        p.thread_rows == 2 ? conv_fwd3_kernel<2> : conv_fwd3_kernel<1>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    long tiles = p.cross ? ((long)N * p.Hv + p.th - 1) / p.th
                         : (long)N * p.row_tiles;
    dim3 grid((unsigned)(tiles * p.col_tiles), (O + p.OT - 1) / p.OT);
    kernel<<<grid, p.threads, smem, s>>>(xp, wp, bp, yp, N, C, H, W, O, ph,
                                         pw, Ho, Wo, act, flipped, p);
    return (int)cudaGetLastError();
  }
  int nb, th, tw;
  fwd_tile(N, Ho, Wo, &nb, &th, &tw);
  // Input channels per chunk: up to 8, fewer where the halo and weight
  // slice of 8 would not fit the 48 KB of static-launch shared memory.
  int plane = nb * (th + kh - 1) * (tw + kw - 1);
  int cc = C < 8 ? C : 8;
  while (cc > 1 && (size_t)cc * (plane + kh * kw * kFwdOut) + 4 > 12288) --cc;
  size_t smem =
      (((size_t)cc * plane + 3) & ~(size_t)3) + (size_t)cc * kh * kw * kFwdOut;
  smem *= sizeof(float);
  long tiles = (long)((N + nb - 1) / nb) * ((Ho + th - 1) / th) *
               ((Wo + tw - 1) / tw);
  dim3 grid((unsigned)tiles, (O + kFwdOut - 1) / kFwdOut);
  auto kernel = kh == 3 && kw == 3
                    ? (flipped ? conv_fwd_kernel<3, 3, true>
                               : conv_fwd_kernel<3, 3, false>)
                    : (flipped ? conv_fwd_kernel<0, 0, true>
                               : conv_fwd_kernel<0, 0, false>);
  kernel<<<grid, kFwdThreads, smem, s>>>(xp, wp, bp, yp, N, C, H, W, O, kh,
                                         kw, ph, pw, Ho, Wo, nb, th, tw, cc,
                                         act);
  return (int)cudaGetLastError();
}

// part: scratch of splits * O * C*kh*kw floats; dw: [O, C, kh, kw].  Split
// z sums the images [z * ipb, (z + 1) * ipb), ipb = ceil(N / splits).  cg:
// input channels a block of the 3x3 kernel, at most C and at most 256
// threads' worth at 8 output channels a thread.
extern "C" int taper_conv_dw(const void* x, const void* g, void* part,
                             void* dw, int N, int C, int H, int W, int O,
                             int kh, int kw, int ph, int pw, int splits,
                             int cg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int Ho = H + 2 * ph - kh + 1, Wo = W + 2 * pw - kw + 1;
  if (N <= 0 || C <= 0 || O <= 0 || kh <= 0 || kw <= 0 || Ho <= 0 ||
      Wo <= 0 || ph < 0 || pw < 0 || splits <= 0 || cg <= 0 || cg > C ||
      (O <= 128 && (O + 7) / 8 * cg > kDwThreads))
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const float*>(x);
  auto gp = static_cast<const float*>(g);
  auto pp = static_cast<float*>(part);
  int CK = C * kh * kw;
  DwPlan p;
  if (kh == 3 && kw == 3 && dw3_plan(N, C, W, O, Ho, Wo, splits, cg, &p)) {
    size_t red = (size_t)(p.PS - 1) * p.OG * p.CG * kRedPitch;
    size_t floats = 2 * (size_t)p.stage > red ? 2 * (size_t)p.stage : red;
    size_t smem = floats * sizeof(float);
    auto kernel = pw == 0   ? conv_dw3_kernel<0>
                  : pw == 1 ? conv_dw3_kernel<1>
                            : conv_dw3_kernel<2>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(splits, (C + p.CG - 1) / p.CG);
    kernel<<<grid, p.OG * p.CG * p.PS, smem, s>>>(xp, gp, pp, N, C, H, W, O,
                                                  ph, Ho, Wo, p);
  } else {
    int ipb = (N + splits - 1) / splits;
    dim3 grid((CK + kDwTile - 1) / kDwTile, (O + kDwTile - 1) / kDwTile,
              splits);
    conv_dw_kernel<<<grid, 256, 0, s>>>(xp, gp, pp, N, C, H, W, O, kh, kw,
                                        ph, pw, Ho, Wo, ipb * Ho * Wo);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int count = O * CK;
  split_sum_kernel<<<(count + 31) / 32, 256, 0, s>>>(
      pp, static_cast<float*>(dw), count, splits);
  return (int)cudaGetLastError();
}
