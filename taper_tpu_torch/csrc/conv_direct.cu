// Direct stride-1 convolution over NCHW activations and OIHW weights, f32:
//   conv_fwd  y[n,o,y,x] = act(b[o] + sum_{c,i,j} w[o,c,i,j] *
//                                   x[n,c,y+i-ph,x+j-pw])
//             (also the input gradient: run on the output gradient with
//              the flipped, in/out-swapped weights and padding k-1-p)
//   conv_dw   dw[o,c,i,j] = sum_{n,y,x} g[n,o,y,x] * x[n,c,y+i-ph,x+j-pw]
// Reads outside the image are zero (the padding).
//
// Replaces the TPU kernels taper_tpu/ops/pallas/conv_direct.py::_fwd_kernel
// (launched by _conv_fwd_nhwc) and ::_dw_kernel (launched by
// _conv_dw_nhwc).  The TPU version pads the input in device memory,
// transposes it to NHWC and assembles a [pixels, C*kh*kw] patch scratch in
// VMEM before one MXU dot.  Here padding is a masked load, the NCHW tensor
// is read as given, and no patch matrix exists anywhere.
//
// What bounds it on the H100: the reference CNN's convolutions (C and O of
// 1 to 128, 3x3, 7x7 to 28x28 planes, batch 256) carry 0.1 to 3.7 GFLOP
// each, over a few MB of activations: FLOP bound in f32, where the card
// has 67 TFLOP/s of FMA outside the tensor cores (no TF32: the contract is
// f32 in, f32 out, f32 accumulation).
// What the simple design does about that:
//   * conv_fwd is an implicit GEMM.  A block owns a tile of up to 128
//     output pixels (nb images x th rows x tw columns, chosen on the host
//     so that 28x28, 14x14 and 7x7 planes waste few lanes) by 32 output
//     channels.  For each chunk of up to 8 input channels it stages the
//     input halo (th+kh-1 rows x tw+kw-1 columns per image) and the
//     matching weight slice in shared memory, then every thread
//     accumulates 4 pixels x 8 channels in registers: 32 FMAs for 4
//     shared loads of the halo and 2 broadcast float4 loads of the
//     weights.  Bias and epilogue are applied at the store.  C = 1 (the
//     first layer) takes chunks of one channel; no load assumes C % 4 == 0.
//   * 3x3 filters, the only ones the path runs, get a specialisation with
//     the tap loops unrolled; other sizes take the same code with runtime
//     loop bounds.
//   * conv_dw is a GEMM [O] x [C*kh*kw] reduced over all N*Ho*Wo output
//     pixels (200,704 at 28x28).  The TPU kernel carries that sum across a
//     sequential grid; blocks on the card run in parallel, so the pixel
//     axis is split across blocks (blockIdx.z), each writing its partial
//     sum to a [splits, O, C*kh*kw] scratch, and a second small kernel
//     adds the splits in a fixed order.  No atomics: the result is the same
//     from run to run.  The patch operand is gathered from the input with
//     masked loads inside the tile load, as conv_fwd gathers its halo.
// A tensor-core (TF32/bf16 wgmma) variant and a double-buffered halo are
// later work.
#include "common.cuh"

namespace taper {
namespace {

constexpr int kFwdThreads = 128;  // 4 warps
constexpr int kFwdPix = 128;      // output pixels per tile, 4 per lane
constexpr int kFwdOut = 32;       // output channels per tile, 8 per warp

// KH_/KW_ > 0 fix the filter size at compile time; 0 reads kh/kw.
template <int KH_, int KW_>
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

  // This lane's 4 pixels: halo offset, and where each is stored.
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
    // ws[(ci*taps + tap)*32 + oo] = w[o0+oo, c0+ci, tap]
    for (int e = threadIdx.x; e < cc * taps * kFwdOut; e += kFwdThreads) {
      int oo = e % kFwdOut, k = e / kFwdOut;
      int ci = k / taps, o = o0 + oo, c = c0 + ci;
      ws[e] = (o < O && c < C) ? w[((size_t)o * C + c) * taps + (k - ci * taps)]
                               : 0.0f;
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

  // Tile loads: this thread always loads pixel row kk = tid % 16 of the
  // step, and tile columns col = tid / 16 + 16*s (s = 0..3), so the
  // column decomposition (c, i, j) is computed once.
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

// dw[e] = sum_z part[z, e], z = 0, 1, ... in order.
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int count,
                                 int splits) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * count + e];
  dw[e] = s;
}

// Output tile of conv_fwd: nb images x th rows x tw columns, at most
// kFwdPix pixels, rows balanced across the row tiles.
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

}  // namespace
}  // namespace taper

using namespace taper;

extern "C" int taper_conv_fwd(const void* x, const void* w, const void* bias,
                              void* y, int N, int C, int H, int W, int O,
                              int kh, int kw, int ph, int pw, int act,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int Ho = H + 2 * ph - kh + 1, Wo = W + 2 * pw - kw + 1;
  if (N <= 0 || C <= 0 || O <= 0 || kh <= 0 || kw <= 0 || Ho <= 0 ||
      Wo <= 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
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
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(w);
  auto bp = static_cast<const float*>(bias);
  auto yp = static_cast<float*>(y);
  if (kh == 3 && kw == 3) {
    conv_fwd_kernel<3, 3><<<grid, kFwdThreads, smem, s>>>(
        xp, wp, bp, yp, N, C, H, W, O, kh, kw, ph, pw, Ho, Wo, nb, th, tw, cc,
        act);
  } else {
    conv_fwd_kernel<0, 0><<<grid, kFwdThreads, smem, s>>>(
        xp, wp, bp, yp, N, C, H, W, O, kh, kw, ph, pw, Ho, Wo, nb, th, tw, cc,
        act);
  }
  return (int)cudaGetLastError();
}

// part: scratch of splits * O * C*kh*kw floats; dw: [O, C, kh, kw].
extern "C" int taper_conv_dw(const void* x, const void* g, void* part,
                             void* dw, int N, int C, int H, int W, int O,
                             int kh, int kw, int ph, int pw, int splits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int Ho = H + 2 * ph - kh + 1, Wo = W + 2 * pw - kw + 1;
  if (N <= 0 || C <= 0 || O <= 0 || kh <= 0 || kw <= 0 || Ho <= 0 ||
      Wo <= 0 || ph < 0 || pw < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  int P = N * Ho * Wo, CK = C * kh * kw;
  int rows = (P + splits - 1) / splits;
  rows = (rows + kDwRows - 1) / kDwRows * kDwRows;
  dim3 grid((CK + kDwTile - 1) / kDwTile, (O + kDwTile - 1) / kDwTile,
            splits);
  conv_dw_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(part), N, C, H, W, O, kh, kw, ph, pw, Ho, Wo, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int count = O * CK;
  split_sum_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), count,
      splits);
  return (int)cudaGetLastError();
}
