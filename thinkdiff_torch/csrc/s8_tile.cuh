// The int8 tensor-core tile of the fused lm_head sampler (fused_sample.cu,
// #8) and the quantize-in-kernel w8a8 GEMM (s8_gemm_qx.cu, #12): a 128 x
// 128 int32 block of A @ B^T for int8 A (rows, K) and B (cols, K), both
// K-contiguous, so each kernel keeps only its own epilogue (and, for
// s8_gemm_qx.cu, its own A loader). The w8a8 GEMMs #2 and #7 moved to
// wgmma on a TMA ring (s8_wgmma.cuh).
//
// 8 warps of mma.sync m16n8k32 s8 x s8 -> s32, so the products run on the
// tensor cores and the int32 sum is exact (no f32 rounding of partial sums:
// K=8960 x 127^2 exceeds f32's 2^24). A 16-byte vector load fills a smem
// row and each mma fragment is one 32-bit smem read. Later work: the
// s8_wgmma.cuh design for these two as well.
#pragma once

#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows of A per block
constexpr int BN = 128;          // rows of B (output columns) per block
constexpr int BK = 64;           // bytes of K per smem stage
constexpr int LDS = BK + 16;     // padded smem row (bytes): conflict-free fragment reads
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M; // 64 rows per warp
constexpr int WN = BN / WARPS_N; // 32 columns per warp
constexpr int MT = WM / 16;      // m16 tiles per warp
constexpr int NT = WN / 8;       // n8 tiles per warp

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a (rows x BK) int8 tile, K-contiguous, from a (n_rows, K) matrix.
// Out-of-range rows and K columns are zero-filled (K is a multiple of 16).
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* g,
                                          int row0, int n_rows, int k0, int K) {
  constexpr int CHUNKS = BM * BK / 16;  // 16-byte chunks per tile (BM == BN)
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    int r = c / (BK / 16);
    int kc = (c % (BK / 16)) * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows && k0 + kc < K) {
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * K + k0 + kc);
    }
    *reinterpret_cast<uint4*>(smem + r * LDS + kc) = val;
  }
}

// The block's int32 tile of A @ b[n0:n0+BN]^T over all of K, staged through
// As and Bs (BM * LDS and BN * LDS bytes of shared memory); `load_a(As, k0)`
// stages the (BM x BK) A tile at k0 as load_tile does. This thread's share:
// acc[i][j] holds c0,c1 at (row wm + 16i + g, cols wn + 8j + 2t, +1) and
// c2,c3 at row + 8, with g = lane / 4, t = lane % 4 and the warp's corner
// wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN.
template <typename LoadA>
__device__ __forceinline__ void s8_tile_product_with(
    int (&acc)[MT][NT][4], int8_t* As, int8_t* Bs, LoadA load_a,
    const int8_t* b, int n0, int n_b, int K) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID
  const int t = lane % 4;  // threadID_in_group
  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a(As, k0);
    load_tile(Bs, b, n0, n_b, k0, K);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* base = As + (wm + i * 16 + g) * LDS + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* base = Bs + (wn + j * 8 + g) * LDS + ks + t * 4;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }
}

// The block's int32 tile of a[m0:m0+BM] @ b[n0:n0+BN]^T over all of K, both
// int8 and K-contiguous (see s8_tile_product_with).
__device__ __forceinline__ void s8_tile_product(
    int (&acc)[MT][NT][4], int8_t* As, int8_t* Bs, const int8_t* a, int m0,
    int n_a, const int8_t* b, int n0, int n_b, int K) {
  s8_tile_product_with(
      acc, As, Bs,
      [=](int8_t* smem, int k0) { load_tile(smem, a, m0, n_a, k0, K); },
      b, n0, n_b, K);
}

}  // namespace
