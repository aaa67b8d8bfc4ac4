// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale, f32 inside,
// cast to x's dtype (f32, bf16 or f16).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/norms.py
// `_rmsnorm_kernel` (wrapper `_rmsnorm_pallas`): every RMSNorm of the
// Qwen2-VL LM (D 1536 / 3584), the flan-t5 decoder and the projector
// (D 4096).
//
// What bounds it on an H100: bytes. One read of x and one write of y per
// element; the sum of squares is a few flops a byte. Design: W warps a row
// (chosen by the wrapper from the shape, `rmsnorm_warps` in ops/norms.py:
// fewer rows take more warps, so that enough loads are in flight),
// 16-byte loads (8 bf16 or 4 f32 a lane),
// the row kept in registers between the sum and the scaling, so x is read
// from device memory once; the f32 sum of squares by warp shuffles (and,
// for W > 1, through shared memory); the block's warps stride over rows
// with the scale's vectors held in registers, loaded once, in flight with
// the first row. D = 1536 / 3584 / 4096 in bf16 is 6 / 14 / 16 vectors a
// row's lane at W = 1 (at most 16: W grows for wider rows). A scale of
// another dtype than x, a width that is not a whole number of 16-byte
// vectors or a start that is not 16-byte aligned takes a scalar loop that
// reads x twice (the second time from L1/L2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;  // warps a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// element j of a 16-byte vector of T, and a vector packed from VT floats,
// by bit operations (no address of a register vector is taken, so the
// vectors stay in registers)
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T> __device__ __forceinline__ float elem(const uint4& v, int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int j) {
  return __uint_as_float(word(v, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int j) {
  const uint32_t u = word(v, j / 2);
  return __uint_as_float(j % 2 ? u & 0xffff0000u : u << 16);
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& v, int j) {
  const uint32_t u = word(v, j / 2);
  return __half2float(__ushort_as_half((unsigned short)(j % 2 ? u >> 16 : u & 0xffffu)));
}

template <typename T> __device__ __forceinline__ uint32_t bits(float v);
template <> __device__ __forceinline__ uint32_t bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ uint32_t bits<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

template <typename T, int VT>
__device__ __forceinline__ uint4 pack(const float (&f)[VT]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bits<T>(f[2 * k]) | bits<T>(f[2 * k + 1]) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's copy of the scale in f32, loaded once
template <typename S>
__device__ __forceinline__ void load_scale(const S* scale, float* s_sh, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_sh[i] = to_f32(scale[i]);
  __syncthreads();
}

// W warps a row, 8 / W rows a block in flight; NV: 16-byte vectors a lane
// held in registers (a power of two >= the row's vectors / (32 W));
// d % (16 / sizeof(T)) == 0; the scale of x's dtype.
template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int rows, int d, float eps, int w) {
  constexpr int VT = 16 / sizeof(T);
  __shared__ float part[2][WARPS];  // by row group parity: one barrier a group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_block = WARPS / w;
  const int lr = (warp % w) * 32 + lane;  // the lane's place in its row
  const int stride = 32 * w;
  const int nvec = d / VT;
  const float inv_d = 1.f / (float)d;
  uint4 sv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lr + stride * i;
    if (v < nvec) sv[i] = __ldg(reinterpret_cast<const uint4*>(scale) + v);
  }
  // the loop's bound is the block's, so every warp meets __syncthreads
  int parity = 0;
  for (int r0 = blockIdx.x * per_block; r0 < rows;
       r0 += gridDim.x * per_block, parity ^= 1) {
    const int row = r0 + warp / w;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
    uint4 xv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lr + stride * i;
      if (live && v < nvec) xv[i] = __ldg(xr + v);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live && lr + stride * i < nvec) {
#pragma unroll
        for (int j = 0; j < VT; ++j) {
          const float f = elem<T>(xv[i], j);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = warp_sum(ss);
    if (w > 1) {
      if (lane == 0) part[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < w; ++k) ss += part[parity][warp / w * w + k];
    }
    const float r = rsqrtf(ss * inv_d + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lr + stride * i;
      if (live && v < nvec) {
        float f[VT];
#pragma unroll
        for (int j = 0; j < VT; ++j) f[j] = elem<T>(xv[i], j) * r * elem<T>(sv[i], j);
        yr[v] = pack<T, VT>(f);
      }
    }
  }
}

// any width: one element at a time, x read twice
template <typename T, typename S>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_loop_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ y, int rows, int d, float eps) {
  extern __shared__ float s_sh[];
  load_scale(scale, s_sh, d);
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / (float)d;
  for (int row = blockIdx.x * WARPS + threadIdx.x / 32; row < rows;
       row += gridDim.x * WARPS) {
    const T* xr = x + (size_t)row * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
    const float r = rsqrtf(warp_sum(ss) * inv_d + eps);
    T* yr = y + (size_t)row * d;
    for (int c = lane; c < d; c += 32)
      yr[c] = from_f32<T>(to_f32(xr[c]) * r * s_sh[c]);
  }
}

int g_sms = 0;

template <typename T, int NV>
void launch_vec(const void* x, const void* scale, void* y, int rows, int d,
                float eps, int w, int blocks, cudaStream_t st) {
  rmsnorm_vec_kernel<T, NV><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(y),
      rows, d, eps, w);
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int w, cudaStream_t st) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  constexpr int VT = 16 / sizeof(T);
  const int nvec = d / VT;
  const bool aligned = d % VT == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  // at most 16 vectors a lane (x and scale take 8 registers a vector)
  while (w < WARPS && nvec > 16 * 32 * w) w *= 2;
  const int nv = (nvec + 32 * w - 1) / (32 * w);
  if (std::is_same<T, S>::value && aligned && nv <= 16) {
    const int blocks = min((rows + WARPS / w - 1) / (WARPS / w), 8 * g_sms);
    if (nv <= 1) launch_vec<T, 1>(x, scale, y, rows, d, eps, w, blocks, st);
    else if (nv <= 2) launch_vec<T, 2>(x, scale, y, rows, d, eps, w, blocks, st);
    else if (nv <= 4) launch_vec<T, 4>(x, scale, y, rows, d, eps, w, blocks, st);
    else if (nv <= 8) launch_vec<T, 8>(x, scale, y, rows, d, eps, w, blocks, st);
    else launch_vec<T, 16>(x, scale, y, rows, d, eps, w, blocks, st);
  } else {
    const size_t smem = (size_t)d * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int blocks = min((rows + WARPS - 1) / WARPS, 8 * g_sms);
    rmsnorm_loop_kernel<T, S><<<blocks, WARPS * 32, smem, st>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y),
        rows, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, of dtype code 0 = f32,
// 1 = bf16, 2 = f16; scale (d,) contiguous, of x's dtype or, with
// scale_f32, f32. d <= 12288 (the f32 scale in 48 KB of shared memory).
// warps: warps a row, 1, 2, 4 or 8 (more where a row would need more than
// 16 vectors a lane). Launches on `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_rmsnorm(const void* x, const void* scale, void* y,
                                 int rows, int d, float eps, int dtype,
                                 int scale_f32, int warps, void* stream) {
  if (rows <= 0 || d <= 0 || (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (scale_f32 ? 1 : 0)) {
    case 0: case 1: return launch<float, float>(x, scale, y, rows, d, eps, warps, st);
    case 2: return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, warps, st);
    case 3: return launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, warps, st);
    case 4: return launch<__half, __half>(x, scale, y, rows, d, eps, warps, st);
    case 5: return launch<__half, float>(x, scale, y, rows, d, eps, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
