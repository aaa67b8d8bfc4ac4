// The bf16 tensor-core step of the weight-only int8 GEMV (int8_gemv.cu):
// mma.sync m16n8k16 bf16 x bf16 -> f32 and the packing of two values into
// one 32-bit fragment register.
//
// Fragment layout (g = lane / 4, t = lane % 4): A (16 x 16, row-major)
// a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same cols), a2 = (row g,
// cols 2t+8, 2t+9), a3 = (row g+8, same); B (16 x 8) b0 = (rows 2t, 2t+1,
// col g), b1 = (rows 2t+8, 2t+9, col g); C (16 x 8) c0, c1 = (row g, cols
// 2t, 2t+1), c2, c3 = (row g+8, same). So the C tiles n and n+1 of one
// 16-row strip are the A fragment of one k16 step, without a shuffle.
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
