// Tensor-core building blocks shared by the port's kernels for Hopper
// (sm_90a): cp.async staging, ldmatrix fragments and mma.sync.m16n8k16
// (bf16 x bf16 -> f32). Included by flash_attention.cu (K3-K5) and
// paged_attention.cu (K1's tensor-core route); every function is a
// device inline, so each translation unit keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt_mma {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// async copy of 16 (4) bytes global -> shared; bytes past `src_bytes`
// (all of them when it is 0) are written as zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 2^x on the SFU (ex2.approx.ftz: results below 2^-126 flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a · b: a 16x16 bf16 (row-major fragment), b 16x8 bf16 (column-
// major fragment), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A operand of one k16 step from two adjacent n8 accumulator blocks
// (c0: columns 0-7, c1: columns 8-15), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Fragments from a shared [rows][LD] bf16 tile (lane-dependent addresses):
// A operand: rows r0..r0+15 x columns c0..c0+15
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, smem_addr(t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8));
}

// B operands of two n8 blocks whose n index runs along the tile's rows
// n0..n0+15 and k along columns c0..c0+15: b[0..1] for rows n0..n0+7,
// b[2..3] for n0+8..n0+15
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t,
                                       int n0, int c0, int lane) {
  ldsm_x4(b, smem_addr(t + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                       ((lane >> 3) & 1) * 8));
}

// B operands from the transposed view: k along the tile's rows
// k0..k0+15, n along columns n0..n0+15 (b[0..1]: n0..n0+7, b[2..3]: the
// next 8)
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t,
                                        int k0, int n0, int lane) {
  ldsm_x4_t(b, smem_addr(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         n0 + (lane >> 4) * 8));
}

}  // namespace pt_mma
