// The tensor-core and copy instructions (inline PTX, sm_80 and later) and the
// shared-memory tile helpers of the fused sparse attention bodies on
// mma.sync: the forward (block_sparse_causal.cu: K1, K2, K5, K6, K9a-c) and
// the backward (block_sparse_diff.cu: dq for K3 and K7, dk/dv for K4 and K8).
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a·b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32 (to about 2^-22 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
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

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), by integer operations on its bits: adding half of TF32's last
// place to the magnitude and clearing the 13 dropped bits gives cvt.rna's
// bits on every finite x. cvt.rna compiles to a longer sequence that also
// sorts out NaN and infinity (FSETP and SEL in the SASS), which the backward
// bodies, splitting only finite values, need not pay (PERF.md).
__device__ __forceinline__ uint32_t to_tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// split_tf32 by to_tf32_rna: the same bits on finite x
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

}  // namespace sea
