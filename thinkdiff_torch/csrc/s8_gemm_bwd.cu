// w8a8 input gradient for Hopper: dx = bf16(float(gq @ Wq^T) * sg[row]).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_bwd_kernel` (wrapper `_s8_matmul_fused_bwd`): the input gradient of
// every frozen w8a8 projection of the flan-t5-xxl decoder and of the
// lm_head chunks in the aligner's training step (gq is dy with the weight's
// column scales folded in, requantized per row; ops/quant.py).
//
// What bounds it on an H100: at the training rows (R = 1024, 512 for an
// lm_head chunk) the int8 tensor-core rate (1,979 TOP/s dense) for the
// wide projections, the bytes of the int8 weight for the narrow ones.
// Design: the 128x128 int32 tile of s8_tile.cuh (mma.sync m16n8k32 s8 x s8
// -> s32, exact int32 sum) with the contraction over N. The tile wants both
// operands N-contiguous and int8 has no transposing ldmatrix, so the
// weight is read from a (K, N) row-major copy that the training model makes
// once when its weights are loaded (models/qdense.py; the serving path
// keeps only the (N, K) copy the forward reads). The int32 tile never
// leaves registers; the epilogue is float(acc) * sg[r], rounded to bf16
// once, as the Pallas kernel's.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "s8_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
s8_gemm_bwd_kernel(const int8_t* __restrict__ gq, const float* __restrict__ sg,
                   const int8_t* __restrict__ w, __nv_bfloat16* __restrict__ dx,
                   int R, int K, int N) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;

  int acc[MT][NT][4];
  // rows of gq (R, N) against rows of w (K, N): contraction over N
  s8_tile_product(acc, As, Bs, gq, m0, R, w, k0, K, N);

  // c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g+8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + i * 16 + g + half * 8;
      if (r >= R) continue;
      const float srow = sg[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = k0 + wn + j * 8 + t * 2;
        if (c >= K) continue;  // K is even, so c + 1 < K as well
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * K + c) =
            __floats2bfloat162_rn((float)acc[i][j][half * 2 + 0] * srow,
                                  (float)acc[i][j][half * 2 + 1] * srow);
      }
    }
  }
}

}  // namespace

// gq (R, N) int8 row-major; sg (R,) f32; w (K, N) int8 row-major; dx (R, K)
// bf16. N is a multiple of 16 and K is even. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int thinkdiff_s8_gemm_bwd(const void* gq, const void* sg,
                                     const void* w, void* dx, int R, int K,
                                     int N, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || K % 2 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((K + BN - 1) / BN, (R + BM - 1) / BM);
  s8_gemm_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(gq), static_cast<const float*>(sg),
      static_cast<const int8_t*>(w), static_cast<__nv_bfloat16*>(dx), R, K, N);
  return (int)cudaGetLastError();
}
