// w8a8 input gradient for Hopper: dx = bf16(float(gq @ Wq^T) * sg[row]).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_bwd_kernel` (wrapper `_s8_matmul_fused_bwd`): the input gradient of
// every frozen w8a8 projection of the flan-t5-xxl decoder and of the
// lm_head chunks in the aligner's training step (gq is dy with the weight's
// column scales folded in, requantized per row; ops/quant.py).
//
// What bounds it on an H100: at the training rows (R = 1024, 512 for an
// lm_head chunk) the int8 tensor-core rate (1,979 TOP/s dense).
// Design: s8_wgmma.cuh's kernel (wgmma s32.s8.s8 on a TMA ring, split-K
// where the tiles are short of a wave) with the contraction over N: A = gq
// (R, N) and B = the weight as a (K, N) row-major copy that the training
// model makes once when its weights are loaded (models/qdense.py; the
// serving path keeps only the (N, K) copy the forward reads). Both are
// N-contiguous, the K-major layout 8-bit wgmma reads. The epilogue is
// float(acc) * sg[r], rounded to bf16 once, as the Pallas kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "s8_wgmma.cuh"

// gq (R, N) int8 row-major; sg (R,) f32; w (K, N) int8 row-major; dx (R, K)
// bf16; ws an int32 (split, R, K) workspace when split > 1, else null. N
// is a multiple of 16 and K of 8, the bases 16-byte aligned. The plan
// (block_m, block_n, stages, split) is ops/int8_matmul.py's
// s8_gemm_plan(R, N, K). Launches on `stream`; returns a CUDA error code
// (or 1000 + a refused tensor map's CUresult).
extern "C" int thinkdiff_s8_gemm_bwd(const void* gq, const void* sg,
                                     const void* w, void* dx, void* ws, int R,
                                     int K, int N, int block_m, int block_n,
                                     int stages, int split, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return s8_wgmma(gq, w, static_cast<const float*>(sg), nullptr, dx, ws, R, K,
                  N, block_m, block_n, stages, split,
                  static_cast<cudaStream_t>(stream));
}

// The int32 mode: acc an int32 (split, R, K) buffer whose plane 0 receives
// the exact sums gq @ Wq^T (no row scale), for a contraction over N that
// is sharded over ranks and added by the caller before it scales.
extern "C" int thinkdiff_s8_gemm_bwd_i32(const void* gq, const void* w,
                                         void* acc, int R, int K, int N,
                                         int block_m, int block_n, int stages,
                                         int split, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || K % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return s8_wgmma(gq, w, nullptr, nullptr, nullptr, acc, R, K, N, block_m,
                  block_n, stages, split, static_cast<cudaStream_t>(stream),
                  true);
}
