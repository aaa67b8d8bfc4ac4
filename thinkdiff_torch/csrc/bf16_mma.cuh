// The bf16 mma.sync step of the weight-only int8 GEMV (int8_gemv.cu) and
// the paged decode attention (paged_decode.cu): mma.sync m16n8k16 bf16 x
// bf16 -> f32, the packing of two values into one 32-bit fragment
// register, and ldmatrix (plain and .trans) of four 8 x 8 bf16 matrices.
//
// Fragment layout (g = lane / 4, t = lane % 4): A (16 x 16, row-major)
// a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same cols), a2 = (row g,
// cols 2t+8, 2t+9), a3 = (row g+8, same); B (16 x 8) b0 = (rows 2t, 2t+1,
// col g), b1 = (rows 2t+8, 2t+9, col g); C (16 x 8) c0, c1 = (row g, cols
// 2t, 2t+1), c2, c3 = (row g+8, same). So the C tiles n and n+1 of one
// 16-row strip are the A fragment of one k16 step, without a shuffle.
// ldmatrix: lanes 8i..8i+7 give the row addresses (16 bytes each) of
// matrix i, which lands in register i; lane (g, t) receives row g,
// elements 2t, 2t+1 (.trans: rows 2t, 2t+1 of element g).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

}  // namespace
