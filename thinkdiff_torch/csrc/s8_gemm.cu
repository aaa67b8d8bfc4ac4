// w8a8 GEMM forward for Hopper: y = bf16(float(xq @ Wq) * sx[row] * s[col]).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_fwd_kernel` (wrapper `_s8_matmul_fused`): every w8a8 projection of
// the Qwen2-VL language model (qkv, o, gate_up, down) and of the frozen
// flan-t5-xxl decoder in the aligner's training step.
//
// What bounds it on an H100: at prefill and training rows (R = B*T,
// thousands) the int8 tensor-core rate (1,979 TOP/s dense); at decode (R =
// batch, <= 32) the bytes of the int8 weight, read once (3.35 TB/s).
// Design: s8_wgmma.cuh's kernel (wgmma s32.s8.s8 on a TMA ring, split-K
// where the tiles are short of a wave) with A = xq (R, K) and B = the
// weight's (N, K) row-major storage, both K-contiguous; the epilogue
// applies float(acc) * sx[r] * s[c] in that order and writes bf16.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "s8_wgmma.cuh"

// xq (R, K) int8 row-major; sx (R,) f32; wt (N, K) int8 row-major (the
// transposed copy of the (K, N) weight); s (N,) f32; y (R, N) bf16; ws an
// int32 (split, R, N) workspace when split > 1, else null. K and N are
// multiples of 16, the bases 16-byte aligned. The plan (block_m, block_n,
// stages, split) is ops/int8_matmul.py's s8_gemm_plan(R, K, N). Launches
// on `stream`; returns a CUDA error code (or 1000 + a refused tensor map's
// CUresult).
extern "C" int thinkdiff_s8_gemm(const void* xq, const void* sx, const void* wt,
                                 const void* s, void* y, void* ws, int R, int K,
                                 int N, int block_m, int block_n, int stages,
                                 int split, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return s8_wgmma(xq, wt, static_cast<const float*>(sx),
                  static_cast<const float*>(s), y, ws, R, N, K, block_m,
                  block_n, stages, split, static_cast<cudaStream_t>(stream));
}

// The int32 mode (a contraction sharded over ranks, whose partial sums the
// caller adds exactly before it applies the scales once): acc an int32
// (split, R, N) buffer whose plane 0 receives the exact sums xq @ Wq; no
// scale is read. Same plan and operands as thinkdiff_s8_gemm otherwise.
extern "C" int thinkdiff_s8_gemm_i32(const void* xq, const void* wt, void* acc,
                                     int R, int K, int N, int block_m,
                                     int block_n, int stages, int split,
                                     void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return s8_wgmma(xq, wt, nullptr, nullptr, nullptr, acc, R, N, K, block_m,
                  block_n, stages, split, static_cast<cudaStream_t>(stream),
                  true);
}
