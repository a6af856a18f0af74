// The tensor-core and copy instructions (inline PTX) and the shared-memory
// tile helpers of the fused sparse attention bodies: on mma.sync (sm_80 and
// later) K5's float32 instance (block_sparse_causal.cu); on Hopper's wgmma,
// TMA, mbarriers and setmaxnreg (sm_90a, the second half of this file) the
// bf16 instances of the forward and the backward, the float32 instances of
// the backward in three bf16 terms (block_sparse_diff.cu: dq for K3 and K7,
// dk/dv for K4 and K8), and (the last part, in TF32) the other float32
// instances of the forward (block_sparse_causal.cu: K1, K2, K6, K9a-c).
// The second half also holds the tile layouts that TMA writes and wgmma
// reads (`Panels` for bf16, `TPanels` for float32) and the tensor maps that
// describe them (`tile_map`, `f32_map`).
//
// Fragments of mma.sync m16n8k8 (TF32), with g = lane / 4 and t4 = lane % 4:
// A (16 x 8) holds rows g and g + 8 at k = t4 and t4 + 4; B (8 x 8) holds
// k = t4 and t4 + 4 of column g; C (16 x 8) holds rows g and g + 8 at
// columns 2·t4 and 2·t4 + 1. Every float32 product of these kernels permutes
// its reduction index inside each 8-wide step, k = t4 and t4 + 4 standing for
// columns 2·t4 and 2·t4 + 1. So a C fragment is an A fragment as it stands
// (P·V takes P from S, dq takes dS, dk and dv take dSᵀ and Pᵀ), and an
// operand read along its rows is read as float2.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sea {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `N` has landed (for this thread)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a·b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; 2^0 == 1)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the bf16 pairs hi = (bf16(x0), bf16(x1)) and lo = the bf16 of what is left
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The bf16 pairs of x0 and x1 in three terms, x = t1 + t2 + t3 to about
// 2^-27 of x: t1 = bf16_rn(x), t2 = bf16_rn(x − t1), t3 = bf16_rn(x − t1 −
// t2). Each bf16 keeps 8 significant bits and each subtraction is exact (its
// operands lie within a factor of 2 of each other), so t2 is at most 2^-9 of
// x and t3 at most 2^-18; six bf16 products of the terms (all but t2·t3,
// t3·t2 and t3·t3, each under 2^-26 of a·b) keep float32's accuracy.
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& t1, uint32_t& t2,
                                            uint32_t& t3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const float2 af = __bfloat1622float2(a);
  const float r0 = __fsub_rn(x0, af.x), r1 = __fsub_rn(x1, af.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 c = __floats2bfloat162_rn(__fsub_rn(r0, bf.x), __fsub_rn(r1, bf.y));
  t1 = *reinterpret_cast<const uint32_t*>(&a);
  t2 = *reinterpret_cast<const uint32_t*>(&b);
  t3 = *reinterpret_cast<const uint32_t*>(&c);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), by integer operations on its bits: adding half of TF32's last
// place to the magnitude and clearing the 13 dropped bits gives cvt.rna's
// bits on every finite x. cvt.rna compiles to a longer sequence that also
// sorts out NaN and infinity (FSETP and SEL in the SASS), which the mma.sync
// bodies, splitting only finite values, need not pay (PERF.md).
__device__ __forceinline__ uint32_t to_tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32 (to about 2^-22 of x), each part rounded as cvt.rna
// rounds it
__device__ __forceinline__ void split_tf32_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32_rna(x);
  lo = to_tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// The split TF32 A fragment of one 8-wide step from the pairs (k = t4,
// k = t4 + 4) of row g (x0) and row g + 8 (x1): two float2 reads of an
// operand's rows, or a C fragment as (c[0], c[1]) and (c[2], c[3]).
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32_rna(x0.x, hi[0], lo[0]);
  split_tf32_rna(x1.x, hi[1], lo[1]);
  split_tf32_rna(x0.y, hi[2], lo[2]);
  split_tf32_rna(x1.y, hi[3], lo[3]);
}

// c += a·b in float32 accuracy ("3xTF32"): b = (b0 at k = t4, b1 at k =
// t4 + 4) split here, a split by the caller; a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, small terms first, a_lo·b_lo dropped (about 2^-21 of a
// product).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32_rna(b0, bh0, bl0);
  split_tf32_rna(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 64 rows of D elements into shared rows of `ld`, 16 bytes a thread and copy,
// THREADS threads taking whole copies in turn.
template <int D, int THREADS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* __restrict__ src,
                                          int tid) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per copy
  constexpr int CPR = D / EPC;              // copies per row
  static_assert(64 * CPR % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < 64 * CPR / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int c = i / CPR, d = (i % CPR) * EPC;
    cp_async16(dst + c * ld + d, src + (long)c * D + d);
  }
}

// The 16-byte copies and the float2 reads and stores need every tensor
// operand on 16 bytes (each row of a head then is, D being 64).
template <typename... P>
inline bool misaligned(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) & 15u) != 0;
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): TMA, mbarriers, wgmma and setmaxnreg, for the bodies on
// wgmma (block_sparse_causal.cu, `causal_wgmma_kernel` and
// `causal_tf32_wgmma_kernel`; block_sparse_diff.cu, `causal_dq_wgmma_kernel`,
// `causal_dkv_wgmma_kernel` and their float32 twins
// `causal_dq_f32_wgmma_kernel` and `causal_dkv_f32_wgmma_kernel`).
//
// Shared-memory operands are tiles of 64 rows cut into panels of PW columns
// (bf16), each panel rows x PW·2 bytes, row-major, in the swizzled layout
// that TMA writes and wgmma's descriptors read: 128-byte rows with the
// 128-byte swizzle (PW = 64; D = 64 and 128) or 32-byte rows with the 32-byte
// swizzle (PW = 16; D = 80, whose 160-byte rows no 64-column box tiles, and
// D = 32, whose 64-byte rows take two such panels). The
// swizzle XORs address bits 4.. with bits 7.. of the shared address itself,
// so every panel starts on its swizzle atom (1024 or 256 bytes).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the barriers' initialisation visible to the async proxy (TMA) and to the
// block's other threads (with the __syncthreads that follows)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2-D tensor map (columns c, rows r) into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c,
                                            int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, completing
// on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A wgmma operand descriptor: the start address, the leading and stride
// byte offsets and the swizzle (1: 128 bytes, 3: 32 bytes). K-major (the
// reduction index along the rows' bytes): SBO is the step between 8-row
// groups and LBO is unused. MN-major (transposed): LBO is the step between
// PW-wide column panels and SBO the step between 8-row groups of the
// reduction index.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t swizzle) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3fffu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no use of them across the fences and waits.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for the A fragments of a wgmma product from registers
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// the `threads` threads (whole warps) that name barrier `id` (1-15; 0 is
// __syncthreads') wait for each other
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the warpgroup's register budget lowered (the producer) or raised (the
// consumers); every warp of the warpgroup executes it
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Accumulator and A-fragment layouts (m64nNk16, per warp w of the
// warpgroup, g = lane / 4, t4 = lane % 4): d[4·j + i] holds row 16·w + g +
// 8·(i / 2) at column 8·j + 2·t4 + i % 2, as mma.sync's C fragments do; the
// register A of k-step kk is (rows g, g + 8; columns 16·kk + 2·t4 (+ 1),
// + 8), which is the pair (d[8·kk + 0..1], d[8·kk + 2..3], d[8·kk + 4..5],
// d[8·kk + 6..7]) of a 64-column accumulator as it stands.

// d (+)= a·b, m64n64k16: a (64 x 16) and b (16 x 64, K-major, i.e. the rows of
// Kᵀ's transpose) from shared memory through their descriptors; `accumulate`
// 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a·b, m64n32k16: a (64 x 16) from registers (the A fragment), b (16 x 32)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n64k16: a (64 x 16) from registers (the A fragment), b (16 x 64)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n80k16: a (64 x 16) from registers (the A fragment), b (16 x 80)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n128k16: a (64 x 16) from registers (the A fragment), b (16 x 128)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// d += a·b with N = D, the P·V product of the bf16 body; a width without an
// instruction here does not compile
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(d, a, db);
  } else {
    static_assert(D == 128, "wgmma_rs: no m64nDk16 instruction for this head width");
    wgmma_rs_n128(d, a, db);
  }
}

// A 64-row bf16 tile of D columns in shared memory: NP panels of PW columns,
// each 64 rows of ROW bytes, in the swizzled layout TMA writes and wgmma's
// descriptors read (see above: PW = 64 under the 128-byte swizzle at D = 64
// and 128, PW = 16 under the 32-byte one at D = 32 and 80). A tile starts on
// 1024 bytes. At D = 32 the tile is two 16-column panels, width 80's layout
// cut to two panels, not one 32-column panel under the 64-byte swizzle:
// `wgmma_desc`, `tile_map` and `swizzled` know the 128- and 32-byte swizzles
// only, and both have run on the card.
template <int D>
struct Panels {
  static constexpr int PW = D % 64 == 0 ? 64 : 16;
  static constexpr int NP = D / PW;
  static constexpr uint32_t SWIZZLE = PW == 64 ? 1u : 3u;
  static constexpr int ROW = 2 * PW;  // bytes of a panel's row
  static constexpr int PANEL = 64 * ROW;
  static constexpr int TILE = NP * PANEL;  // 64 rows x D bf16
  static_assert(D % 16 == 0 && TILE % 1024 == 0, "head width");

  // k-step kk (16 columns) of a tile read K-major: the reduction index runs
  // along its rows (A of Q·Kᵀ, and its B, Kᵀ's rows)
  __device__ static uint64_t kdesc(uint32_t tile, int kk) {
    return wgmma_desc(tile + (16 * kk / PW) * PANEL + (16 * kk % PW) * 2, 16, 8 * ROW, SWIZZLE);
  }
  // k-step kk (16 rows) of a tile read MN-major as B: the reduction index
  // runs down its rows, N along them, its panels LBO apart (V of P·V)
  __device__ static uint64_t mndesc(uint32_t tile, int kk) {
    return wgmma_desc(tile + 16 * kk * ROW, PANEL, 8 * ROW, SWIZZLE);
  }
};

// The tensor map of a (rows, D) bf16 tensor in boxes of 64 rows by one panel
// of PW columns, swizzled as `Panels<D>` lays a tile out.
// cuTensorMapEncodeTiled is the driver's; it is looked up through the
// runtime, so that no library needs -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

template <int D>
cudaError_t tile_map(CUtensorMap* map, const void* ptr, long rows) {
  using P = Panels<D>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)P::PW, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            P::PW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// TF32 on wgmma, for the float32 forward body (block_sparse_causal.cu,
// `causal_tf32_wgmma_kernel`). wgmma reads TF32 operands K-major only (the
// reduction index along the rows' bytes), from shared memory or, for A, from
// registers; its m64nNk8 A fragment (per warp w, g = lane / 4, t4 = lane %
// 4) holds rows 16·w + g and + 8 at k = t4 (registers 0, 1) and k = t4 + 4
// (2, 3), as mma.sync m16n8k8's does. So P·V takes P from its accumulators
// as `split_a` orders them (k = t4 standing for column 2·t4, k = t4 + 4 for
// 2·t4 + 1), and V is read as Vᵀ whose keys sit in the same order within
// each group of 8 (`KEY_AT`).
// ---------------------------------------------------------------------------

// the key that k-position p of an 8-wide TF32 k-step stands for
__device__ __forceinline__ int key_at(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// The byte offset `o` within a panel of ROW-byte rows as TMA's swizzle
// places it: the 16-byte chunk index (bits 4..) XORed with the bits from 7
// up, three of them for 128-byte rows, one for 32-byte rows (a panel starts
// on its swizzle atom, so the offset's bits are the address's).
template <int ROW>
__device__ __forceinline__ uint32_t swizzled(uint32_t o) {
  return o ^ ((o >> 3) & (ROW == 128 ? 0x70u : 0x10u));
}

// generic-proxy writes to shared memory (the split of Q) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a·b, m64n64k8 in TF32: a (64 x 8) and b (8 x 64) from shared memory, both
// K-major; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a·b, m64n32k8 in TF32: a (64 x 8) from registers (the A fragment), b (8 x
// 32) from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n64k8 in TF32: a (64 x 8) from registers (the A fragment), b (8 x
// 64) from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n80k8 in TF32: a (64 x 8) from registers (the A fragment), b (8 x
// 80) from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b, m64n128k8 in TF32: a (64 x 8) from registers (the A fragment), b (8 x
// 128) from shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a·b with N = D, the P·V product of the float32 body; a width without
// an instruction here does not compile
template <int D>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (D == 32) {
    wgmma_tf32_rs_n32(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_tf32_rs_n64(d, a, db);
  } else if constexpr (D == 80) {
    wgmma_tf32_rs_n80(d, a, db);
  } else {
    static_assert(D == 128, "wgmma_tf32_rs: no m64nDk8 instruction for this head width");
    wgmma_tf32_rs_n128(d, a, db);
  }
}

// A float32 tile of ROWS rows and COLS columns in shared memory, read
// K-major (COLS the reduction index) by the TF32 wgmmas: NP panels of PW
// columns, each ROWS rows of ROW bytes, in the swizzled layout TMA writes:
// 32-column panels under the 128-byte swizzle where COLS is a multiple of
// 32, else (COLS = 80, whose 320-byte rows no 128-byte box tiles) 8-column
// ones under the 32-byte swizzle. The bytes are those of `Panels` at twice
// the columns, so the descriptors are the bf16 tiles' too.
template <int ROWS, int COLS>
struct TPanels {
  static constexpr int PW = COLS % 32 == 0 ? 32 : 8;
  static constexpr int NP = COLS / PW;
  static constexpr uint32_t SWIZZLE = PW == 32 ? 1u : 3u;
  static constexpr int ROW = 4 * PW;  // bytes of a panel's row
  static constexpr int PANEL = ROWS * ROW;
  static constexpr int TILE = NP * PANEL;
  static_assert(COLS % 8 == 0 && ROWS % 8 == 0 && PANEL % 1024 == 0, "tile shape");

  // k-step kk (8 columns) of the tile read K-major, as A or as B
  __device__ static uint64_t kdesc(uint32_t tile, int kk) {
    return wgmma_desc(tile + (8 * kk / PW) * PANEL + (8 * kk % PW) * 4, 16, 8 * ROW, SWIZZLE);
  }
};

// The tensor map of a (rows, cols) float32 tensor in boxes of 64 rows by one
// panel of PW columns, swizzled as `TPanels` lays a tile out.
template <int PW>
cudaError_t f32_map(CUtensorMap* map, const void* ptr, long rows, long cols) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)PW, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            PW == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sea
