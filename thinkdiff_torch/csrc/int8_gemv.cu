// Weight-only int8 GEMV for Hopper: y = out(f32(x @ f32(Wq)) * s[col]), for
// the skinny activations of a decode step (R <= 32 rows).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py `_kernel`
// (wrapper `int8_matmul`): every weight-only int8 QDense at <= 32 rows, i.e.
// the flan-t5-xxl decoder of the LVLM's greedy text decode and the
// weight-only Qwen2-VL decode step.
//
// What bounds it on an H100: the bytes of the int8 weight, read once (K*N
// bytes at 3.35 TB/s); at R <= 32 the products are far below the tensor
// cores' rate, but not below the CUDA cores' f32 rate at R = 32, so the
// products run on the tensor cores.
// Design: the weight is read as its (N, K) row-major storage (the transposed
// copy QDense keeps): each lane loads 16 contiguous bytes of one output
// column with one vector load, converts them to bf16 exactly (integers
// |v| <= 128 need 8 bits) and feeds four mma.sync m16n8k16 bf16 x bf16 ->
// f32 steps. The 16 k values a lane holds are taken in the order the mma
// fragments want, and the lane's x fragment (rows g and g+8, the same 16 k)
// comes straight from global memory (x is small and stays in L1/L2), so no
// shared memory sits between HBM and the tensor cores. A block owns 32
// columns and its 8 warps split its K range; K is split across blocks as
// well (a second, tiny kernel sums the slices in a fixed order) when the
// column strips alone would leave SMs idle. An f32 x is split into three
// bf16 terms (hi + mid + lo carry its 24 bits), so its products stay exact.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_NG = 4;              // n8 column groups per block
constexpr int GEMV_BN = GEMV_NG * 8;    // columns per block
constexpr int GEMV_KSTEP = 64;          // k per warp iteration: 4 lanes x 16

// Four int8 (one 32-bit word) -> bf16 pairs {v0, v1}, {v2, v3}, exactly:
// 0x4B0000uu is the float 2^23 + u, so u = v + 128 comes back as v by one
// subtraction, and an integer of magnitude <= 128 keeps its value in the
// upper 16 bits of its f32 pattern (the bf16).
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 16 consecutive x values of one row as bf16 pairs, split into NS terms
// (NS = 1 for bf16 x; 3 for f32 x: x = hi + mid + lo exactly).
template <bool XF32, int NS>
__device__ __forceinline__ void load_x16(uint32_t (&out)[NS][8], const void* x,
                                         size_t off, bool ok) {
  if constexpr (!XF32) {
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (ok) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(x) + off);
      a = p[0];
      b = p[1];
    }
    out[0][0] = a.x; out[0][1] = a.y; out[0][2] = a.z; out[0][3] = a.w;
    out[0][4] = b.x; out[0][5] = b.y; out[0][6] = b.z; out[0][7] = b.w;
  } else {
    float v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) f = reinterpret_cast<const float4*>(static_cast<const float*>(x) + off)[i];
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a0 = v[2 * i], a1 = v[2 * i + 1];
#pragma unroll
      for (int sp = 0; sp < NS; ++sp) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(a0, a1);
        out[sp][i] = *reinterpret_cast<const uint32_t*>(&b);
        a0 -= __low2float(b);
        a1 -= __high2float(b);
      }
    }
  }
}

template <bool OUTF32>
__device__ __forceinline__ void store_out(void* y, size_t i, float v) {
  if constexpr (OUTF32) {
    static_cast<float*>(y)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  }
}

// grid (ceil(N / 32), K slices). MT = 1 (R <= 16) or 2 (R <= 32) m16 tiles.
// With one K slice the block applies the epilogue; otherwise it writes its
// f32 partial sums to part[slice][R][N].
template <int MT, bool XF32, bool OUTF32>
__global__ void __launch_bounds__(GEMV_THREADS)
int8_gemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ s, void* __restrict__ y,
                 float* __restrict__ part, int R, int K, int N, int k_split) {
  constexpr int NS = XF32 ? 3 : 1;
  __shared__ float red[GEMV_WARPS][MT * 16][GEMV_BN + 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID: fragment row / weight column
  const int t = lane % 4;  // threadID_in_group: which 16 bytes of the 64
  const int n0 = blockIdx.x * GEMV_BN;
  const int k_lo = blockIdx.y * k_split;
  const int k_hi = min(K, k_lo + k_split);

  float acc[MT][GEMV_NG][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < GEMV_NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kb = k_lo + warp * GEMV_KSTEP; kb < k_hi;
       kb += GEMV_WARPS * GEMV_KSTEP) {
    const int k = kb + 16 * t;
    const bool kin = k < k_hi;  // k_hi is a multiple of 16: all 16 or none
    uint4 wv[GEMV_NG];
#pragma unroll
    for (int j = 0; j < GEMV_NG; ++j) {
      const int n = n0 + 8 * j + g;
      wv[j] = make_uint4(0, 0, 0, 0);
      if (kin && n < N)
        wv[j] = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)n * K + k));
    }
    uint32_t xa[MT][2][NS][8];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * i + g + 8 * h;
        load_x16<XF32, NS>(xa[i][h], x, (size_t)r * K + k, kin && r < R);
      }
    // mma step st takes the lane's bytes 4st..4st+3: logical k (2t, 2t+1)
    // is physical k + 4st + {0, 1}, (2t+8, 2t+9) is k + 4st + {2, 3}; the
    // same map for x and W, and a bijection onto the warp's 64 k
#pragma unroll
    for (int st = 0; st < 4; ++st) {
#pragma unroll
      for (int j = 0; j < GEMV_NG; ++j) {
        const uint32_t word = st == 0 ? wv[j].x : st == 1 ? wv[j].y
                            : st == 2 ? wv[j].z : wv[j].w;
        uint32_t b0, b1;
        s8x4_to_bf16(word, b0, b1);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int sp = 0; sp < NS; ++sp) {
            const uint32_t a[4] = {xa[i][0][sp][2 * st], xa[i][1][sp][2 * st],
                                   xa[i][0][sp][2 * st + 1],
                                   xa[i][1][sp][2 * st + 1]};
            mma_bf16(acc[i][j], a, b0, b1);
          }
      }
    }
  }

  // c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < GEMV_NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][16 * i + g + 8 * (e / 2)][8 * j + 2 * t + (e % 2)] = acc[i][j][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * GEMV_BN; idx += GEMV_THREADS) {
    const int r = idx / GEMV_BN, c = idx % GEMV_BN, n = n0 + c;
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) sum += red[w][r][c];
    if (gridDim.y == 1) {
      store_out<OUTF32>(y, (size_t)r * N + n, sum * s[n]);
    } else {
      part[((size_t)blockIdx.y * R + r) * N + n] = sum;
    }
  }
}

// y[r, n] = out(sum over slices of part[slice, r, n], in slice order, * s[n])
template <bool OUTF32>
__global__ void int8_gemv_reduce(const float* __restrict__ part,
                                 const float* __restrict__ s,
                                 void* __restrict__ y, int R, int N,
                                 int slices) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * N) return;
  float sum = 0.f;
  for (int sl = 0; sl < slices; ++sl) sum += part[(size_t)sl * R * N + i];
  store_out<OUTF32>(y, i, sum * s[i % N]);
}

template <int MT, bool XF32, bool OUTF32>
void launch(const void* x, const int8_t* wt, const float* s, void* y,
            float* part, int R, int K, int N, int k_split, cudaStream_t st) {
  const int slices = (K + k_split - 1) / k_split;
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, slices);
  int8_gemv_kernel<MT, XF32, OUTF32><<<grid, GEMV_THREADS, 0, st>>>(
      x, wt, s, y, part, R, K, N, k_split);
  if (slices > 1) {
    const size_t total = (size_t)R * N;
    int8_gemv_reduce<OUTF32><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, s, y, R, N, slices);
  }
}

}  // namespace

// x (R, K) bf16 (x_f32 = 0) or f32 row-major, 1 <= R <= 32; wt (N, K) int8
// row-major (the transposed storage of the (K, N) weight); s (N,) f32;
// y (R, N) bf16 (y_f32 = 0) or f32. K and N are multiples of 16, k_split a
// multiple of 16; when k_split < K, part holds ceil(K / k_split) * R * N
// floats. Launches on `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_int8_gemv(const void* x, const void* wt, const void* s,
                                   void* y, void* part, int R, int K, int N,
                                   int k_split, int x_f32, int y_f32,
                                   void* stream) {
  if (R <= 0 || R > 32 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
      k_split <= 0 || k_split % 16 != 0 || (k_split < K && part == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wt);
  auto sc = static_cast<const float*>(s);
  auto p = static_cast<float*>(part);
  const int code = (R > 16 ? 4 : 0) | (x_f32 ? 2 : 0) | (y_f32 ? 1 : 0);
  switch (code) {
    case 0: launch<1, false, false>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 1: launch<1, false, true>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 2: launch<1, true, false>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 3: launch<1, true, true>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 4: launch<2, false, false>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 5: launch<2, false, true>(x, w, sc, y, p, R, K, N, k_split, st); break;
    case 6: launch<2, true, false>(x, w, sc, y, p, R, K, N, k_split, st); break;
    default: launch<2, true, true>(x, w, sc, y, p, R, K, N, k_split, st); break;
  }
  return (int)cudaGetLastError();
}
