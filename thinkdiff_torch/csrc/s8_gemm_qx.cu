// w8a8 GEMM forward with the activation quantization inside the kernel:
//   sx[r] = max(max_k |x[r, k]|, 1e-30) * fl(1 / 127)
//   xq[r, k] = clip(round_half_even(x[r, k] / sx[r]), -127, 127)
//   y = out(float(xq @ Wq) * sx[r] * s[col])
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_fwd_qx_kernel` (wrapper `_s8_matmul_fused_qx`), the op that skips the
// separate per-row absmax pre-pass of a w8a8 projection (ops/quant.py
// `_absmax_quant_rows` + s8_gemm.cu). No model path of either package calls
// it; the JAX package keeps it as the record of the attempt.
//
// What bounds it on an H100: the int8 tensor-core rate (1,979 TOP/s dense)
// at the flan-t5-xxl training shapes (R = 1024, K = 4096), plus the
// re-reading of the unquantized x, which each block does once per K tile.
// Design: the 128 x 128 int32 tile of s8_tile.cuh with its own A loader. A
// block first computes the scales of its 128 rows (one warp per 16 rows,
// f32 absmax over K), then quantizes each (128 x 64) x tile as it is staged
// into shared memory; the int8 copy of x never exists in HBM. A 128 x 4096
// int8 copy would not fit in shared memory (512 KB), hence the per-tile
// quantization. Each quantum equals the plain version's on the card: x / sx
// is an IEEE division (__fdiv_rn) and the rounding rintf (half to even);
// the row scale is max(amax, 1e-30) * fl(1 / 127), because that is what
// `clamp(amax, 1e-30) / 127.0` computes on a CUDA tensor (PyTorch's CUDA
// division by a Python scalar multiplies by the scalar's f32 reciprocal;
// on the CPU it divides, which can differ by one ulp).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "s8_tile.cuh"

namespace {

// 16 consecutive x values (bf16 or f32) of one row as f32
template <bool XF32>
__device__ __forceinline__ void load16(float (&v)[16], const void* x, size_t off) {
  if constexpr (XF32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = p[i];
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(x) + off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 raw = p[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * i + 2 * j] = __low2float(h[j]);
        v[8 * i + 2 * j + 1] = __high2float(h[j]);
      }
    }
  }
}

template <bool XF32, bool OUTF32>
__global__ void __launch_bounds__(THREADS)
s8_gemm_qx_kernel(const void* __restrict__ x, const int8_t* __restrict__ wt,
                  const float* __restrict__ s, void* __restrict__ y, int R,
                  int K, int N) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ float sx[BM];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // per-row scales: warp w takes rows w, w + 8, ...; lanes stride over K
  for (int r = warp; r < BM; r += THREADS / 32) {
    float amax = 0.f;
    if (m0 + r < R) {
      for (int k = lane * 16; k < K; k += 32 * 16) {
        float v[16];
        load16<XF32>(v, x, (size_t)(m0 + r) * K + k);
#pragma unroll
        for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sx[r] = __fmul_rn(fmaxf(amax, 1e-30f), __frcp_rn(127.0f));
  }
  __syncthreads();

  // stage the int8 tile of rows m0.., k0..k0+BK from x, quantized per row
  const float* row_scale = sx;  // captured as a pointer, not a copy
  auto load_a = [=](int8_t* smem, int k0) {
    constexpr int CHUNKS = BM * BK / 16;
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c / (BK / 16);
      const int kc = (c % (BK / 16)) * 16;
      uint32_t packed[4] = {0, 0, 0, 0};
      if (m0 + r < R && k0 + kc < K) {
        float v[16];
        load16<XF32>(v, x, (size_t)(m0 + r) * K + k0 + kc);
        const float sr = row_scale[r];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], sr)), -127.f), 127.f);
          packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (i % 4));
        }
      }
      *reinterpret_cast<uint4*>(smem + r * LDS + kc) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  };

  int acc[MT][NT][4];
  s8_tile_product_with(acc, As, Bs, load_a, wt, n0, N, K);

  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm + i * 16 + g + half * 8;
      const int r = m0 + rl;
      if (r >= R) continue;
      const float srow = sx[rl];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn + j * 8 + t * 2;
        if (c >= N) continue;  // N is even, so c + 1 < N as well
        const float v0 = (float)acc[i][j][half * 2 + 0] * srow * s[c];
        const float v1 = (float)acc[i][j][half * 2 + 1] * srow * s[c + 1];
        if constexpr (OUTF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(y) + (size_t)r * N + c) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(y) + (size_t)r * N + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

}  // namespace

// x (R, K) bf16 (x_f32 = 0) or f32 row-major, unquantized; wt (N, K) int8
// row-major (the transposed storage of the (K, N) weight); s (N,) f32; y (R,
// N) bf16 (y_f32 = 0) or f32. K and N are multiples of 16. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_s8_gemm_qx(const void* x, const void* wt,
                                    const void* s, void* y, int R, int K,
                                    int N, int x_f32, int y_f32,
                                    void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wt);
  auto sc = static_cast<const float*>(s);
  if (x_f32 && y_f32)
    s8_gemm_qx_kernel<true, true><<<grid, THREADS, 0, st>>>(x, w, sc, y, R, K, N);
  else if (x_f32)
    s8_gemm_qx_kernel<true, false><<<grid, THREADS, 0, st>>>(x, w, sc, y, R, K, N);
  else if (y_f32)
    s8_gemm_qx_kernel<false, true><<<grid, THREADS, 0, st>>>(x, w, sc, y, R, K, N);
  else
    s8_gemm_qx_kernel<false, false><<<grid, THREADS, 0, st>>>(x, w, sc, y, R, K, N);
  return (int)cudaGetLastError();
}
