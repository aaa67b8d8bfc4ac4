// w8a8 GEMM forward for Hopper: y = bf16(float(xq @ Wq) * sx[row] * s[col]).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_fwd_kernel` (wrapper `_s8_matmul_fused`): every w8a8 projection of
// the Qwen2-VL language model (qkv, o, gate_up, down).
//
// What bounds it on an H100: at prefill (R = B*T rows, thousands) the
// int8 tensor-core rate (1,979 TOP/s dense); at decode (R = batch, <= 32)
// the bytes of the int8 weight, read once (3.35 TB/s).
// Design: 128x128 output tiles, 8 warps of mma.sync m16n8k32 s8 x s8 -> s32,
// so the products run on the tensor cores and the int32 sum is exact (no
// f32 rounding of partial sums: K=8960 x 127^2 exceeds f32's 2^24). Both
// operands are K-contiguous (x row-major, W read as its transposed (N, K)
// copy), so a 16-byte vector load fills a smem row and each mma fragment is
// one 32-bit smem read. The int32 tile never leaves registers; the epilogue
// applies float(acc) * sx[r] * s[c] in that order and writes bf16. Later
// work: cp.async/TMA double buffering and wgmma for the prefill rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows of x per block
constexpr int BN = 128;          // output columns per block
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
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile(As, xq, m0, R, k0, K);
    load_tile(Bs, wt, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* base = As + (wm + i * 16 + g) * LDS + ks + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* base = Bs + (wn + j * 8 + g) * LDS + ks + t * 4;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

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
