// Fused lm_head + sampling for Hopper: token ids = argmax over the vocab of
//   float(xq @ Wq) * sx[row] * s[col] * inv_T + pad_bias[col]
//   + blocked[row] * eos_bias[col] (+ Gumbel noise keyed on (seed, row, col)),
// without writing the (B, V) logits to device memory.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/fused_sample.py
// `_fused_sample_kernel` (wrapper `fused_lm_sample`): the token sampler of
// the paged decode step and of the chunked-prefill first token under
// `sampler: gumbel` (2B: B <= 256 rows, D = 1536, V = 151936 padded to a
// multiple of the pack's block).
//
// What bounds it on an H100: at B = 256 both the int8 weight stream (D x Vp
// bytes, 236 MB for the 2B pack: ~70 us at 3.35 TB/s) and the int8 products
// (2 B D Vp = 121 G ops: ~61 us at 1,979 TOP/s) are near the limit; the
// (B, Vp) logits never leave registers.
// Design: pass 1 is the int8 tile of s8_tile.cuh, shared with s8_gemm_qx.cu
// (128 x 128 tiles, 8 warps of mma.sync m16n8k32 s8 x s8 -> s32, W read
// K-contiguous from the pack's (Vp, D) storage) with an argmax epilogue:
// each element gets the
// bias/noise arithmetic with explicitly rounded f32 operations in the order
// of the plain version (no FMA contraction, so the plain PyTorch version on
// the same inputs gives identical ids), then each row's (max, lowest column)
// is reduced within the thread, the quad and the block and written to
// scratch, one entry per (row, column tile). Row tiles are the fast grid
// axis, so the blocks that share a weight tile run together and read it
// once from device memory. Blocks run in no order, so pass 2 (one warp per
// row) reduces the column tiles, keeping the lowest column on ties at every
// level: first-occurrence argmax, as jnp.argmax and the TPU kernel give.
// The noise is a counter-based hash of (seed, row, global column), so the
// draw depends on neither the tile size nor the padding. Later work: cp.async
// or TMA pipelining and wgmma for the product.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "s8_tile.cuh"

namespace {

// lowbias32 (a bijection of 32-bit words)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Gumbel(0, 1) from the hash of (seed, row, col): u = (top 24 bits + 0.5)
// * 2^-24, clamped below 1 (for top bits 2^24 - 1 the f32 sum rounds to
// 2^24, which would give u = 1 and g = +inf); g = -log(-log(u)).
__device__ __forceinline__ float gumbel(uint32_t s0, uint32_t s1, int row, int col) {
  const uint32_t key = ((uint32_t)row << 20) | (uint32_t)col;
  const uint32_t bits = mix32(mix32(key ^ s0) ^ s1);
  const float u = fminf(__fmul_rn(__fadd_rn((float)(bits >> 8), 0.5f),
                                  5.9604644775390625e-08f),
                        0.99999994039535522f);
  return -logf(-logf(u));
}

// a beats b: larger value, or the same value at a lower column
__device__ __forceinline__ bool better(float va, int ca, float vb, int cb) {
  return va > vb || (va == vb && ca < cb);
}

struct Params {
  const int8_t* xq;        // (B, K)
  const float* sx;         // (B,)
  const int8_t* wt;        // (Vp, K)
  const float* scale;      // (Vp,)
  const float* pad_bias;   // (Vp,)
  const float* eos_bias;   // (Vp,)
  const float* blocked;    // (B,)
  const int* seed;         // (2,)
  float* part_val;         // (B, n_tiles)
  int* part_col;           // (B, n_tiles)
  int B, K, Vp;
  float inv_temp;
  int noise;
};

__global__ void __launch_bounds__(THREADS) fused_sample_tiles(const Params p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ float red_v[WARPS_N][BM];
  __shared__ int red_c[WARPS_N][BM];

  const int m0 = blockIdx.x * BM;  // row tiles on the fast axis
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;

  int acc[MT][NT][4];
  s8_tile_product(acc, As, Bs, p.xq, m0, p.B, p.wt, n0, p.Vp, p.K);

  const uint32_t s0 = (uint32_t)p.seed[0], s1 = (uint32_t)p.seed[1];
  // c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g+8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm + i * 16 + g + half * 8;  // row within the tile
      const int r = m0 + rl;
      float best_v = -INFINITY;
      int best_c = 0x7fffffff;
      if (r < p.B) {
        const float srow = p.sx[r];
        const float blk = p.blocked[r];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wn + j * 8 + t * 2 + e;
            float v = __fmul_rn(__fmul_rn((float)acc[i][j][half * 2 + e], srow),
                                p.scale[c]);
            v = __fadd_rn(__fadd_rn(__fmul_rn(v, p.inv_temp), p.pad_bias[c]),
                          __fmul_rn(blk, p.eos_bias[c]));
            if (p.noise) v = __fadd_rn(v, gumbel(s0, s1, r, c));
            if (better(v, c, best_v, best_c)) {
              best_v = v;
              best_c = c;
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, o);
        const int oc = __shfl_xor_sync(0xffffffffu, best_c, o);
        if (better(ov, oc, best_v, best_c)) {
          best_v = ov;
          best_c = oc;
        }
      }
      if (t == 0) {
        red_v[warp % WARPS_N][rl] = best_v;
        red_c[warp % WARPS_N][rl] = best_c;
      }
    }
  }
  __syncthreads();
  for (int rl = threadIdx.x; rl < BM; rl += THREADS) {
    const int r = m0 + rl;
    if (r >= p.B) continue;
    float bv = red_v[0][rl];
    int bc = red_c[0][rl];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) {
      if (better(red_v[w][rl], red_c[w][rl], bv, bc)) {
        bv = red_v[w][rl];
        bc = red_c[w][rl];
      }
    }
    const size_t o = (size_t)r * gridDim.y + blockIdx.y;
    p.part_val[o] = bv;
    p.part_col[o] = bc;
  }
}

// pass 2: one warp per row over the column tiles
__global__ void fused_sample_reduce(const float* __restrict__ part_val,
                                    const int* __restrict__ part_col,
                                    int* __restrict__ ids, int B, int n_tiles) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;
  float bv = -INFINITY;
  int bc = 0x7fffffff;
  for (int j = lane; j < n_tiles; j += 32) {
    const float v = part_val[(size_t)row * n_tiles + j];
    const int c = part_col[(size_t)row * n_tiles + j];
    if (better(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (lane == 0) ids[row] = bc;
}

}  // namespace

// xq (B, K) int8; sx (B,) f32; wt (Vp, K) int8 row-major (the K-contiguous
// storage of the (K, Vp) lm_head); scale, pad_bias, eos_bias (Vp,) f32;
// blocked (B,) f32; seed (2,) int32 on the device; part_val (B, Vp/128) f32
// and part_col (B, Vp/128) int32 scratch; ids (B,) int32 out. K % 16 == 0,
// Vp % 128 == 0, B < 4096, Vp <= 2^20. Launches both passes on `stream`;
// returns cudaGetLastError().
extern "C" int thinkdiff_fused_sample(
    const void* xq, const void* sx, const void* wt, const void* scale,
    const void* pad_bias, const void* eos_bias, const void* blocked,
    const void* seed, void* part_val, void* part_col, void* ids, int B, int K,
    int Vp, float inv_temp, int noise, void* stream) {
  if (B <= 0 || B >= 4096 || K <= 0 || K % 16 != 0 || Vp <= 0 ||
      Vp % BN != 0 || Vp > (1 << 20))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.sx = static_cast<const float*>(sx);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.pad_bias = static_cast<const float*>(pad_bias);
  p.eos_bias = static_cast<const float*>(eos_bias);
  p.blocked = static_cast<const float*>(blocked);
  p.seed = static_cast<const int*>(seed);
  p.part_val = static_cast<float*>(part_val);
  p.part_col = static_cast<int*>(part_col);
  p.B = B;
  p.K = K;
  p.Vp = Vp;
  p.inv_temp = inv_temp;
  p.noise = noise;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = Vp / BN;
  dim3 grid((B + BM - 1) / BM, n_tiles);
  fused_sample_tiles<<<grid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS_PER_BLOCK = 8;
  fused_sample_reduce<<<(B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                        32 * ROWS_PER_BLOCK, 0, st>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_col),
      static_cast<int*>(ids), B, n_tiles);
  return (int)cudaGetLastError();
}
