// Hopper (sm_90a) building blocks for the hand-written kernels of
// taper_tpu_torch: mbarriers, TMA tile loads and their descriptors,
// wgmma shared-memory descriptors, instructions and fences, and register
// rebalancing between warpgroups, wgmma with A from registers, and the
// accumulator-fragment helpers (quad reductions, the f32 accumulator as a
// bf16 A operand).  K1's wgmma GEMM (gemm_sm90.cu) and the flash kernels
// K8, K7 and K10 (flash_sm90.cu) and K6 (flash_bwd_sm90.cu) are built on
// them.
//
// Conventions:
//   * shared-memory addresses are 32-bit (``smem_u32``);
//   * operand tiles use the 128-byte swizzle throughout: TMA writes them
//     with CU_TENSOR_MAP_SWIZZLE_128B, wgmma reads them through a
//     descriptor of layout B128, and each tile starts on a 1024-byte
//     boundary (the swizzle repeats every 8 rows of 128 bytes);
//   * a TMA box is at most 128 bytes wide (64 bf16) under that swizzle.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace taper {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes mbarrier.init visible to the other threads and to the async proxy
// (TMA); between the inits and the block's first barrier.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects ``bytes`` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity ``parity`` has completed (the barrier's
// current phase differs from it).  A phase's parity is the number of its
// earlier completions, mod 2.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA --

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Copies the box at coordinates (c0 innermost, c1) of ``map`` into shared
// memory at ``dst``; completion is reported to ``bar`` as transaction
// bytes.  Out-of-bounds elements are filled with zeros.  ``map`` must be a
// kernel parameter (``__grid_constant__``) or lie in global memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// As tma_load_2d, at coordinates (c0, c1, c2) of a rank-3 ``map``: a
// box past the middle dimension's end reads zeros, never the next index
// of the outer one.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Copies the shared-memory box at ``src`` to the box at (c0, c1) or (c0,
// c1, c2) of ``map`` in global memory (elements outside the tensor are not
// written), as one bulk group of the issuing thread.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most ``N`` bulk groups of the thread still read their
// shared-memory source (the source may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most ``N`` bulk groups of the thread are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy
// (a TMA store that reads them after a barrier).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier ``id`` (1..15; 0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives at named barrier ``id`` without waiting: the threads that wait
// there (named_bar_sync, ``count`` threads in all) see this thread's
// earlier shared-memory writes.
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- wgmma --

// Shared-memory matrix descriptor of a 128-byte-swizzled operand tile
// starting at ``addr`` (PTX ISA, "Matrix Descriptor Format"): the start
// address, the leading and stride byte offsets (16-byte units), layout
// type 1 (B128) in bits 62-63; the base offset is 0 because tiles start
// on 1024-byte boundaries.
//   * K-major (K contiguous, 64 bf16 = one 128-byte row per M/N index):
//     stride = 1024 (the next 8 rows), leading unused; the k-th 16-wide
//     slice starts 32 k bytes into the row.
//   * M/N-major (M/N contiguous, one 128-byte row per K index, 64 wide):
//     leading = the bytes between 64-wide M/N blocks, stride = 1024 (the
//     next 8 K rows); the k-th 16-deep slice starts 16 k rows further.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// Orders earlier register and shared-memory writes before the wgmma that
// follow; required before the first wgmma of a batch.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most ``N`` committed wgmma groups of the warp are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that own it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// One wgmma m64n128k16 (bf16 in, f32 accumulate) on the warpgroup's 64 x
// 128 accumulator fragment ``d`` (d = A . B + (d if ``accumulate``), A
// from ``da``, B from ``db``).  TA / TB: 0 if the operand is K-major in
// shared memory, 1 if it is M- / N-major (the instruction's transpose
// bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// One wgmma m64n64k16 with both operands in shared memory (bf16 in, f32
// accumulate) on the warpgroup's 64 x 64 fragment ``d``: d = A . B + (d if
// ``accumulate``).  TA / TB as in wgmma_m64n128k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// One wgmma m64n64k16 with A from registers: ``a`` holds the thread's
// four 32-bit registers of a 64 x 16 bf16 A fragment (acc_to_a gives
// them), B in shared memory (TB as in wgmma_m64n128k16).  d = A . B + (d
// if ``accumulate``).  The registers of ``a`` are read asynchronously:
// they must not change before the wgmma group that holds it is waited
// for.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// One wgmma m64n128k16 with A from registers: ``a`` holds the thread's
// four 32-bit registers of a 64 x 16 bf16 A fragment (acc_to_a gives
// them), B in shared memory (TB as in wgmma_m64n128k16).  d = A . B + (d
// if ``accumulate``).  The registers of ``a`` are read asynchronously:
// they must not change before the wgmma group that holds it is waited
// for.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}


// -- accumulator fragments --
//
// A warpgroup's m64nN f32 accumulator: thread t of warp w holds rows
// r = 16 w + (lane / 4) and r + 8 and, in each 8-column block j, columns
// 8 j + 2 (lane % 4) and one more: element e sits at row offset
// frag_row(e) and column frag_col(e, lane % 4).  The four threads of a
// quad (lanes 4 i .. 4 i + 3) hold a row between them.

__device__ __forceinline__ constexpr int frag_row(int e) {
  return 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ constexpr int frag_col(int e, int quad_lane) {
  return 8 * (e >> 2) + 2 * quad_lane + (e & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the special-function unit alone (ex2.approx.ftz: about 2 ulp,
// a result below 2^-126 flushed to 0); exp2f adds a range fix-up to it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, ``lo`` in the low half (rounded to
// nearest even).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN f32 accumulator as the bf16 A operands of the N / 16 k16 slices
// of a following product whose K dimension is this N.  For 16-bit types
// the two layouts line up, so no shuffle is needed: the A fragment of
// slice k holds (row g, cols 16 k + 2 q + {0, 1}), (row g + 8, the same),
// (row g, + 8), (row g + 8, + 8) for quad lane q, which are accumulator
// elements 8 k .. 8 k + 7 in order (PTX ISA, "Register Fragments and
// Shared Memory Matrix Layouts" of wgmma: the A fragment of .bf16 and the
// D fragment of .f32).  The card tests hold a product through it against
// a plain one (taper_wgmma_frag_test).
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[k][i] = pack_bf16x2(acc[8 * k + 2 * i], acc[8 * k + 2 * i + 1]);
}

// The byte offset of element (row, col) of a [rows, 64] bf16 box written
// by TMA under the 128-byte swizzle (the 16-byte chunk index XOR row % 8),
// the box starting on a 1024-byte boundary.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// -- warpgroup register rebalancing --

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- host: TMA descriptors --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library needs no -lcuda); null if the driver has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A TMA descriptor of the dense row-major tensor at ``ptr`` with ``rank``
// dimensions ``dims`` (innermost first; the innermost contiguous, its
// bytes a multiple of 16, ``ptr`` 16-byte aligned), read or written in
// boxes ``box``.  Loads outside the tensor read zeros; stores outside it
// are dropped.  Returns 0 or a cudaError_t code.
inline int tma_desc(CUtensorMap* map, CUtensorMapDataType type, int elem,
                    int rank, const void* ptr, const uint64_t* dims,
                    const uint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdims[3], strides[2];
  cuuint32_t gbox[3], elem_strides[3] = {1, 1, 1};
  uint64_t stride = (uint64_t)elem;
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    stride *= dims[i];
    if (i + 1 < rank) strides[i] = stride;  // bytes to the next index
  }
  CUresult r = fn(map, type, rank, const_cast<void*>(ptr), gdims, strides,
                  gbox, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// An operand tile's descriptor: the row-major bf16 matrix ``[outer,
// inner]`` (``inner`` a multiple of 8) in boxes of ``box_outer`` rows of
// ``box_inner`` (<= 64) elements under the 128-byte swizzle.
inline int tma_desc_bf16(CUtensorMap* map, const void* ptr, uint64_t inner,
                         uint64_t outer, uint32_t box_inner,
                         uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint32_t box[2] = {box_inner, box_outer};
  return tma_desc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, ptr, dims,
                  box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A rank-3 operand descriptor: the dense bf16 tensor ``[outer, mid,
// inner]`` in boxes of ``box_mid`` x ``box_inner`` (<= 64) elements under
// the 128-byte swizzle.  Loads past ``mid`` read zeros and stores past it
// are dropped, for each outer index alone (a 2-D ``[outer * mid, inner]``
// descriptor would reach into the next outer index's rows).
inline int tma_desc_bf16_3d(CUtensorMap* map, const void* ptr,
                            uint64_t inner, uint64_t mid, uint64_t outer,
                            uint32_t box_inner, uint32_t box_mid) {
  const uint64_t dims[3] = {inner, mid, outer};
  const uint32_t box[3] = {box_inner, box_mid, 1};
  return tma_desc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, ptr, dims,
                  box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper
}  // namespace taper
