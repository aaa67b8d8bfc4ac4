// Weight-only int8 GEMM for Hopper at any row count, forward and input
// gradient, with the weight streamed as int8 from HBM:
//   forward:        y  = out(f32(bf16(x) @ bf16(Wq)) * s[col])
//   input gradient: dx = out(f32(bf16(g * s) @ bf16(Wq)^T))
//
// Replaces the Pallas TPU kernels thinkdiff_tpu/ops/int8_matmul.py
// `_wide_fwd_kernel` (wrapper `_int8_matmul_wide_fwd`) and `_wide_bwd_kernel`
// (wrapper `_int8_matmul_wide_bwd`), the two halves of the `int8_matmul_wide`
// op (a frozen weight: no dW). No model path of either package calls the op.
//
// What bounds it on an H100: at the flan-t5-xxl shapes (R = 1024 rows, K or
// N = 10240) the bf16 tensor-core rate (989 TFLOP/s dense); the int8 weight
// is read once per 128-row strip.
// Design: a 128 x 128 f32 tile of 8 warps of mma.sync m16n8k16 bf16 x bf16
// -> f32, K (or N) in steps of 32. Both kernels read the weight from the
// (N, K) row-major storage QDense keeps (kernel_q is its transpose view) and
// convert each int8 tile to bf16 exactly as it lands in shared memory, so no
// bf16 copy of the weight exists in HBM. The forward's B operand is then
// K-contiguous, as the mma fragment wants; the input gradient contracts over
// N, for which the same tile is N-major, and bf16's transposing ldmatrix
// (which int8 lacks) turns it into fragments. The forward casts x to bf16 as
// it is staged and scales the f32 tile by s[col]; the input gradient stages
// bf16(f32(g) * s[n]), the Pallas kernel's rounding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int WBM = 128;        // rows per block
constexpr int WBN = 128;        // output columns per block
constexpr int WBK = 32;         // contraction per step
constexpr int LDA = WBK + 8;    // A tile pitch (bf16): conflict-free fragment reads
constexpr int LDB = WBN + 8;    // transposed B tile pitch (bf16), 272 bytes
constexpr int WWARPS_N = 4;
constexpr int WTHREADS = 256;
constexpr int WWM = 64;         // rows per warp
constexpr int WWN = 32;         // columns per warp
constexpr int WMT = WWM / 16;
constexpr int WNT = WWN / 8;

// 16 int8 -> 16 bf16 (two uint4), exactly (see int8_gemv.cu)
__device__ __forceinline__ uint32_t s8pair_to_bf16(uint32_t u, int sel) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | sel)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 | sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__device__ __forceinline__ void s8x16_to_bf16(uint4 w, uint4& lo, uint4& hi) {
  const uint32_t a = w.x ^ 0x80808080u, b = w.y ^ 0x80808080u;
  const uint32_t c = w.z ^ 0x80808080u, d = w.w ^ 0x80808080u;
  lo = make_uint4(s8pair_to_bf16(a, 0), s8pair_to_bf16(a, 2),
                  s8pair_to_bf16(b, 0), s8pair_to_bf16(b, 2));
  hi = make_uint4(s8pair_to_bf16(c, 0), s8pair_to_bf16(c, 2),
                  s8pair_to_bf16(d, 0), s8pair_to_bf16(d, 2));
}

// 8 consecutive values of a bf16 or f32 row, times f32 scales sc (or 1),
// rounded to bf16 (one uint4). ok = false gives zeros.
template <bool F32, bool SCALE>
__device__ __forceinline__ uint4 load8_bf16(const void* p, size_t off,
                                            const float* sc, bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  float v[8];
  if constexpr (F32) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
    const float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + off);
    if constexpr (!SCALE) return raw;  // already the bf16 it would round to
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __low2float(h[i]);
      v[2 * i + 1] = __high2float(h[i]);
    }
  }
  if constexpr (SCALE) {
    const float4 s0 = reinterpret_cast<const float4*>(sc)[0];
    const float4 s1 = reinterpret_cast<const float4*>(sc)[1];
    v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
    v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragments of the warp's four m16 tiles at contraction offset ks of a
// (rows x LDA) bf16 tile: a0 (row g, cols 2t..), a1 (row g+8), a2 (row g,
// cols 2t+8..), a3 (row g+8, cols 2t+8..)
__device__ __forceinline__ void a_frags(uint32_t (&af)[WMT][4],
                                        const __nv_bfloat16* As, int wm,
                                        int ks, int g, int t) {
#pragma unroll
  for (int i = 0; i < WMT; ++i) {
    const __nv_bfloat16* base = As + (wm + i * 16 + g) * LDA + ks + 2 * t;
    af[i][0] = *reinterpret_cast<const uint32_t*>(base);
    af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA);
    af[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDA + 8);
  }
}

template <bool OUTF32>
__device__ __forceinline__ void store2(void* y, size_t i, float v0, float v1) {
  if constexpr (OUTF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(y) + i) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// y (R, N) = (bf16(x) @ bf16(W)) * s; x (R, K), W read from wt (N, K).
template <bool F32>
__global__ void __launch_bounds__(WTHREADS)
int8_wide_fwd_kernel(const void* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ s, void* __restrict__ y,
                     int R, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[WBM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[WBN * LDA];  // [n][k]

  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WWARPS_N) * WWM, wn = (warp % WWARPS_N) * WWN;

  float acc[WMT][WNT][4];
#pragma unroll
  for (int i = 0; i < WMT; ++i)
#pragma unroll
    for (int j = 0; j < WNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += WBK) {
    // x: 128 rows x 32 k in chunks of 8 (K is a multiple of 16)
    for (int c = threadIdx.x; c < WBM * WBK / 8; c += WTHREADS) {
      const int r = c / (WBK / 8), kc = (c % (WBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDA + kc) = load8_bf16<F32, false>(
          x, (size_t)(m0 + r) * K + k0 + kc, nullptr,
          m0 + r < R && k0 + kc < K);
    }
    // W: 128 columns x 32 k of int8, one 16-byte chunk a thread
    for (int c = threadIdx.x; c < WBN * WBK / 16; c += WTHREADS) {
      const int n = c / (WBK / 16), kc = (c % (WBK / 16)) * 16;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (n0 + n < N && k0 + kc < K)
        w = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)(n0 + n) * K + k0 + kc));
      uint4 lo, hi;
      s8x16_to_bf16(w, lo, hi);
      *reinterpret_cast<uint4*>(Bs + n * LDA + kc) = lo;
      *reinterpret_cast<uint4*>(Bs + n * LDA + kc + 8) = hi;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WBK; ks += 16) {
      uint32_t af[WMT][4];
      a_frags(af, As, wm, ks, g, t);
#pragma unroll
      for (int j = 0; j < WNT; ++j) {
        // b0 = (k 2t, 2t+1; col g), b1 = (k 2t+8, 2t+9; col g)
        const __nv_bfloat16* base = Bs + (wn + j * 8 + g) * LDA + ks + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 8);
#pragma unroll
        for (int i = 0; i < WMT; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < WMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + i * 16 + g + h * 8;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < WNT; ++j) {
        const int c = n0 + wn + j * 8 + 2 * t;
        if (c >= N) continue;  // N is even, so c + 1 < N as well
        store2<F32>(y, (size_t)r * N + c, acc[i][j][2 * h] * s[c],
                    acc[i][j][2 * h + 1] * s[c + 1]);
      }
    }
}

// dx (R, K) = bf16(g * s) @ bf16(W)^T; g (R, N), W read from wt (N, K).
template <bool F32>
__global__ void __launch_bounds__(WTHREADS)
int8_wide_bwd_kernel(const void* __restrict__ gr, const int8_t* __restrict__ wt,
                     const float* __restrict__ s, void* __restrict__ dx,
                     int R, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[WBM * LDA];  // [r][n]
  __shared__ __align__(16) __nv_bfloat16 Bs[WBK * LDB];  // [n][k]

  const int m0 = blockIdx.y * WBM, c0 = blockIdx.x * WBN;  // c: columns of dx (k)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WWARPS_N) * WWM, wn = (warp % WWARPS_N) * WWN;

  float acc[WMT][WNT][4];
#pragma unroll
  for (int i = 0; i < WMT; ++i)
#pragma unroll
    for (int j = 0; j < WNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int nb = 0; nb < N; nb += WBK) {
    // bf16(g * s): 128 rows x 32 n in chunks of 8 (N is a multiple of 16)
    for (int c = threadIdx.x; c < WBM * WBK / 8; c += WTHREADS) {
      const int r = c / (WBK / 8), nc = (c % (WBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDA + nc) = load8_bf16<F32, true>(
          gr, (size_t)(m0 + r) * N + nb + nc, s + nb + nc,
          m0 + r < R && nb + nc < N);
    }
    // W: 32 n-rows of the (N, K) storage x 128 k, one 16-byte chunk a thread
    for (int c = threadIdx.x; c < WBK * WBN / 16; c += WTHREADS) {
      const int n = c / (WBN / 16), kc = (c % (WBN / 16)) * 16;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (nb + n < N && c0 + kc < K)
        w = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)(nb + n) * K + c0 + kc));
      uint4 lo, hi;
      s8x16_to_bf16(w, lo, hi);
      *reinterpret_cast<uint4*>(Bs + n * LDB + kc) = lo;
      *reinterpret_cast<uint4*>(Bs + n * LDB + kc + 8) = hi;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WBK; ks += 16) {
      uint32_t af[WMT][4];
      a_frags(af, As, wm, ks, g, t);
#pragma unroll
      for (int j = 0; j < WNT; j += 2) {
        // matrices: (n ks..ks+7 | ks+8..ks+15) x (cols of tile j | j+1);
        // transposed, lane (g, t) receives Bs[ks + 2t (+1)][col g]: b0 and
        // b1 of tiles j and j + 1
        const int lr = lane & 15, lc = (lane >> 4) * 8;
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + (ks + lr) * LDB + wn + j * 8 + lc);
#pragma unroll
        for (int i = 0; i < WMT; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < WMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + i * 16 + g + h * 8;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < WNT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * t;
        if (c >= K) continue;  // K is even
        store2<F32>(dx, (size_t)r * K + c, acc[i][j][2 * h],
                    acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// x (R, K) bf16 (f32 = 0) or f32 row-major; wt (N, K) int8 row-major (the
// transposed storage of the (K, N) weight); s (N,) f32; y (R, N) in x's
// type. K and N are multiples of 16. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int thinkdiff_int8_wide_fwd(const void* x, const void* wt,
                                       const void* s, void* y, int R, int K,
                                       int N, int f32, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + WBN - 1) / WBN, (R + WBM - 1) / WBM);
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wt);
  auto sc = static_cast<const float*>(s);
  if (f32)
    int8_wide_fwd_kernel<true><<<grid, WTHREADS, 0, st>>>(x, w, sc, y, R, K, N);
  else
    int8_wide_fwd_kernel<false><<<grid, WTHREADS, 0, st>>>(x, w, sc, y, R, K, N);
  return (int)cudaGetLastError();
}

// g (R, N) bf16 (f32 = 0) or f32 row-major; wt (N, K) int8 row-major; s (N,)
// f32; dx (R, K) in g's type. K and N are multiples of 16. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_int8_wide_bwd(const void* g, const void* wt,
                                       const void* s, void* dx, int R, int K,
                                       int N, int f32, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((K + WBN - 1) / WBN, (R + WBM - 1) / WBM);
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wt);
  auto sc = static_cast<const float*>(s);
  if (f32)
    int8_wide_bwd_kernel<true><<<grid, WTHREADS, 0, st>>>(g, w, sc, dx, R, K, N);
  else
    int8_wide_bwd_kernel<false><<<grid, WTHREADS, 0, st>>>(g, w, sc, dx, R, K, N);
  return (int)cudaGetLastError();
}
