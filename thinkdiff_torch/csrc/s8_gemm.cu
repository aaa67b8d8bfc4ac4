// w8a8 GEMM forward for Hopper: y = bf16(float(xq @ Wq) * sx[row] * s[col]).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_fwd_kernel` (wrapper `_s8_matmul_fused`): every w8a8 projection of
// the Qwen2-VL language model (qkv, o, gate_up, down).
//
// What bounds it on an H100: at prefill (R = B*T rows, thousands) the
// int8 tensor-core rate (1,979 TOP/s dense); at decode (R = batch, <= 32)
// the bytes of the int8 weight, read once (3.35 TB/s).
// Design: the 128x128 int32 tile of s8_tile.cuh (mma.sync m16n8k32 s8 x s8
// -> s32, exact int32 sum). Both operands are K-contiguous (x row-major, W
// read as its transposed (N, K) copy). The int32 tile never leaves
// registers; the epilogue applies float(acc) * sx[r] * s[c] in that order
// and writes bf16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "s8_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
s8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ wt, const float* __restrict__ s,
               __nv_bfloat16* __restrict__ y, int R, int K, int N) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID
  const int t = lane % 4;  // threadID_in_group
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;

  int acc[MT][NT][4];
  s8_tile_product(acc, As, Bs, xq, m0, R, wt, n0, N, K);

  // epilogue: c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g+8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + i * 16 + g + half * 8;
      if (r >= R) continue;
      const float srow = sx[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn + j * 8 + t * 2;
        if (c >= N) continue;  // N is even, so c + 1 < N as well
        float v0 = (float)acc[i][j][half * 2 + 0] * srow * s[c];
        float v1 = (float)acc[i][j][half * 2 + 1] * srow * s[c + 1];
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// xq (R, K) int8 row-major; sx (R,) f32; wt (N, K) int8 row-major (the
// transposed copy of the (K, N) weight); s (N,) f32; y (R, N) bf16.
// K and N are multiples of 16. Launches on `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_s8_gemm(const void* xq, const void* sx, const void* wt,
                                 const void* s, void* y, int R, int K, int N,
                                 void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  s8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wt), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(y), R, K, N);
  return (int)cudaGetLastError();
}
