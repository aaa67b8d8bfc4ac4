// Per-row absmax int8 quantization of activations inside a kernel, shared
// by the fused sampler (fused_sample.cu, #8) and the quantize-in-kernel
// w8a8 GEMM (s8_gemm_qx.cu, #12): each row of x is quantized once per
// launch into an int8 workspace and an f32 scale, which the kernel's TMA
// ring then reads like any int8 operand.
//
// The quanta are bit for bit what the plain versions compute on a CUDA
// tensor (ops/quant.py `_absmax_quant_rows`, ops/fused_sample.py
// `_quantize_input`):
//   xs = f32(x) (* inv_input[k], one rounded product: the sampler only)
//   sx = max(max_k |xs|, 1e-30) * fl(1 / 127)   (PyTorch's CUDA division by
//        a Python scalar multiplies by the scalar's f32 reciprocal)
//   q  = clamp(rint(xs / sx), -127, 127)         (an IEEE division, round
//        half to even)
//
// Who quantizes: every CTA of the persistent grid, before its main loop,
// takes tickets from a counter (one atomicAdd by one thread); ticket t is
// the chunk of QROWS rows [QROWS t, QROWS t + QROWS), a warp a row. A CTA
// stops at the first ticket past the rows. A row tile (`tile` rows, a
// multiple of QROWS, or all the rows) is ready once its ready counter holds
// its row count.
// Hazards, and what the code does about them:
//  - Co-residency. A wait on rows that a CTA not yet resident would write
//    could hang (two launches on two streams can hold the SMs between
//    them). Here a CTA waits only after it drew a ticket past the rows,
//    and tickets are drawn in order, so every row was claimed by a CTA
//    that is running and that waits on nothing before it counts its rows.
//    No cooperative launch and no occupancy bound are needed.
//  - Proxy ordering. The rows are written by generic stores and read by
//    TMA (the async proxy). The writer stores, every writing thread runs
//    __threadfence(), the CTA meets at a barrier, and one thread adds the
//    chunk to the ready counter. The reader acquires the counter
//    (ld.acquire.gpu), then runs fence.proxy.async.global, then issues its
//    TMA loads; without that fence TMA may read stale bytes. Scales are
//    read with __ldcg (L2), never through the read-only path.
//  - Reuse. The counters live in a workspace kept per device and stream
//    and reset themselves: the last CTA to finish (an exit counter) sets
//    the ticket, ready and exit counters back to 0, so the next launch and
//    a CUDA-graph replay find them at 0. No host read, no memset. This
//    holds only while no two launches in flight share a workspace: a
//    CUDA graph keeps the workspace of the stream it was captured on, so
//    its replay must not overlap an eager call on that stream, nor a
//    replay of another graph captured there (their tickets and counters
//    would interleave: wrong rows, or a hang).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int QROWS = 8;  // rows a ticket: warps 0-7 of the CTA, a row each

// counters of one workspace: [0] the next ticket, [1] CTAs finished,
// [2 + t] rows of row tile t quantized
struct QuantJob {
  const void* x;           // (rows, K) bf16 or f32, row-major
  const float* inv;        // (K,) multiplied in before the absmax, or null
  int8_t* xq;              // (rows, K) int8 workspace
  float* sx;               // (rows,) f32 workspace
  int* cnt;                // 2 + tiles counters, 0 at launch
  int rows, K, tile;       // tile: rows a ready counter counts (QROWS | tile, or all rows)
};

// 8 consecutive x values of a row as f32 (16- or 32-byte aligned)
template <bool XF32>
__device__ __forceinline__ void load8(float (&v)[8], const void* x, size_t off) {
  if constexpr (XF32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(x) + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __low2float(h[j]);
      v[2 * j + 1] = __high2float(h[j]);
    }
  }
}

// xs of 8 values at k: x, or x * inv[k] rounded once
__device__ __forceinline__ void scale8(float (&v)[8], const float* inv, int k) {
  if (inv == nullptr) return;
  const float4 a = __ldg(reinterpret_cast<const float4*>(inv + k));
  const float4 b = __ldg(reinterpret_cast<const float4*>(inv + k + 4));
  const float s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], s[i]);
}

// One warp quantizes row r: the absmax over K, the scale, then the quanta.
// A lane takes 8 values of every 256 (the second pass reads the row again,
// from L1). K % 8 == 0.
template <bool XF32>
__device__ __forceinline__ void quant_row(const QuantJob& j, int r, int lane) {
  const size_t base = (size_t)r * j.K;
  float amax = 0.f;
  for (int k = lane * 8; k < j.K; k += 256) {
    float v[8];
    load8<XF32>(v, j.x, base + k);
    scale8(v, j.inv, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-30f), __frcp_rn(127.0f));
  for (int k = lane * 8; k < j.K; k += 256) {
    float v[8];
    load8<XF32>(v, j.x, base + k);
    scale8(v, j.inv, k);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
      packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(j.xq + base + k) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) j.sx[r] = s;
}

// Every thread of the CTA calls this before its main loop (`ticket` is an
// int of shared memory). Returns once the CTA drew a ticket past the rows.
template <bool XF32>
__device__ __forceinline__ void quant_rows_once(const QuantJob& j, int* ticket) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (;;) {
    if (threadIdx.x == 0) *ticket = atomicAdd(&j.cnt[0], 1);
    __syncthreads();
    const int r0 = *ticket * QROWS;
    __syncthreads();  // every thread read the ticket before the next draw
    if (r0 >= j.rows) return;
    if (warp < QROWS && r0 + warp < j.rows) {
      quant_row<XF32>(j, r0 + warp, lane);
      __threadfence();  // every writer: its stores before the count
    }
    __syncthreads();
    if (threadIdx.x == 0)
      atomicAdd(&j.cnt[2 + r0 / j.tile], min(QROWS, j.rows - r0));
  }
}

// rows in row tile t
__device__ __forceinline__ int tile_rows(const QuantJob& j, int t) {
  return min(j.tile, j.rows - t * j.tile);
}

// Spin until row tile t is quantized, then order the TMA loads that follow
// after it (one thread: the one that issues them).
__device__ __forceinline__ void wait_tile(const QuantJob& j, int t) {
  const int want = tile_rows(j, t);
  while (ld_acquire_gpu(&j.cnt[2 + t]) < want) __nanosleep(32);
  fence_proxy_async_global();
}

// The CTA's last act, every thread after its last use of the workspace:
// returns true in the last CTA to finish, which has set the counters back
// to 0 (and may still use what every other CTA left, e.g. atomics they
// made before finishing). `flag` is an int of shared memory.
__device__ __forceinline__ bool quant_exit(const QuantJob& j, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(&j.cnt[1], 1) == (int)gridDim.x - 1;
    if (last) {
      __threadfence();
      const int tiles = (j.rows + j.tile - 1) / j.tile;
      j.cnt[0] = 0;
      j.cnt[1] = 0;
      for (int t = 0; t < tiles; ++t) j.cnt[2 + t] = 0;
    }
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

}  // namespace
