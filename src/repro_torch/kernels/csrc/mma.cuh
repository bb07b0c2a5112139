// Tensor-core and async-copy helpers of the port's mma.sync kernels
// (flash_attention.cu): 16-byte cp.async copies into
// shared memory and their commit / wait groups, ldmatrix fragment loads,
// and mma.sync m16n8k16 bf16 with f32 accumulators.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A 16 x 16 (row):  a[0] (row g, cols 2 t4, 2 t4 + 1), a[1] row g + 8,
//                     a[2] row g, cols + 8, a[3] row g + 8, cols + 8
//   B 16 x 8 (col):   b0 (k 2 t4, 2 t4 + 1, col g), b1 k + 8
//   C 16 x 8 (f32):   c[0], c[1] (row g, cols 2 t4, 2 t4 + 1), c[2], c[3]
//                     row g + 8
// The C layout of two neighbouring n-tiles, rounded to bf16 pairs, is the
// A layout of one k-step: a product's result feeds the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

// 16-byte global->shared copy; with ``full`` false it writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 values rounded to nearest bf16, packed low first
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

}  // namespace repro_torch
