// Weight-only int8 GEMV for Hopper: y = out(f32(x @ f32(Wq)) * s[col]), for
// the skinny activations of a decode step (R <= 32 rows).
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py `_kernel`
// (wrapper `int8_matmul`): every weight-only int8 QDense at <= 32 rows, i.e.
// the flan-t5-xxl decoder of the LVLM's greedy text decode and the
// weight-only Qwen2-VL decode step.
//
// What bounds it on an H100: the bytes of the int8 weight, read once from
// HBM (K*N bytes at 3.35 TB/s; the decode streams 16.8-131.6 MB weights, far
// past the 50 MB L2 across a step). At R <= 32 the products are far below
// the tensor cores' rate. So the design is a bandwidth kernel:
//  - Persistent CTAs, at most one an SM. A work unit is BN = 32, 64 or 128
//    output columns x a K range (a whole number of stages); units are
//    numbered K range by K range, column tile fastest, and CTA c of C takes
//    units [c U / C, (c + 1) U / C): every CTA streams the same bytes to
//    within one unit. The host's gemv_plan picks BN and the K range (and so
//    the split of K) from the shapes: narrow units fill the SMs without a
//    split (whose partial sums and closing reduction cost ~3-4 us), wide
//    ones read each stage's x for more columns.
//  - Bytes in flight: one SM's share of HBM is 3.35 TB/s / 132 = 25.4 B/ns;
//    at ~1 us of loaded HBM latency an SM needs ~25 KB in flight to keep
//    pace, 32 KB with margin. One producer thread keeps a ring of 2-8
//    stages (as many as fit) of 16 KB weight tiles (BN columns x 16384 / BN
//    bytes of the (N, K) storage, in TMA boxes of 128 bytes x BN rows with
//    the 128-byte swizzle) in flight on full/empty mbarriers: 64-112 KB an
//    SM.
//  - x rides in the same stage: TMA copies the stage's k of x (R rows,
//    zero-filled to a multiple of 8; the mma's rows past them read stale
//    shared memory and their sums are never stored) beside the weight
//    tile, and every consumer warp reads its fragments there; no lane
//    fetches x from L2. (A K range
//    of x kept resident instead would cap the K range at 1,024 at R 32 and
//    force a split on every shape; per stage it costs R x 32768 / BN bytes
//    of L2 reads beside 16 KB of HBM ones.)
//  - Eight consumer warps: BN / 32 column groups of 32 x 8 / (BN / 32)
//    slices of 64 k of each stage. A lane reads 16 contiguous weight bytes
//    of one column, converts them to bf16 exactly and feeds four mma.sync
//    m16n8k16 bf16 x bf16 -> f32 steps, with its x fragment (rows g and
//    g+8, the same 16 k) from the stage. The 16 k a lane holds are taken in
//    the order the fragments want: logical k (2t, 2t+1) of step st is
//    physical k + 4st + {0, 1}, (2t+8, 2t+9) is k + 4st + {2, 3}, the same
//    map for x and W, a bijection onto the warp's 64 k. Which weight row of
//    each group of 8 a lane group reads is permuted so that every
//    shared-memory phase is free of bank conflicts; the epilogue maps the
//    sums back. An f32 x is split into three bf16 terms (hi + mid + lo
//    carry its 24 bits), so its products stay exact. The slot is released
//    as soon as the warp's bytes are in registers. (Sixteen warps measured
//    no faster: the exact conversion's 8 instructions a 4-byte word, not
//    latency, set the consumers' rate, ~0.7 us a 16 KB stage an SM.)
//  - At a unit's end every warp's sums meet in shared memory and all eight
//    warps share the epilogue (one warp alone measured a stall of the
//    next unit's stages): each output sums its k slices in slice order, a
//    fixed order. A unit that covers all of K applies s[n] and writes y.
//    A split's unit only stores its f32 partial sums to a workspace; at the
//    CTA's end one fence, then one warp moves a counter per column tile for
//    each of the CTA's units (32 atomics in flight), and the CTA that ran
//    a tile's last unit sums the partials in K-range order (0 + p0 + p1 +
//    ...), applies s[n], writes y and sets the counter back to 0: one
//    launch, the same bits every run, and a CUDA-graph replay finds its
//    counters at 0. (Counting unit by unit measured ~2-3 us of fence and
//    atomic a unit on the consumers' path.)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr int GV_W = 16384;            // weight bytes a stage
constexpr int GV_CONSUMERS = 8;        // consumer warps
constexpr int GV_THREADS = (GV_CONSUMERS + 1) * 32;
constexpr int GV_MAX_STAGES = 8;

// MT m16 tiles of x rows (R <= 16: 1, else 2); x bf16 or f32; CG column
// groups of 32 (BN = 32 CG output columns a unit), each warp a slice of 64
// of a stage's SK = 64 KQ bytes of k (KQ = 8 / CG slices)
template <int MT, bool XF32, int CG>
struct GemvTile {
  static constexpr int BN = 32 * CG;             // columns a unit
  static constexpr int KQ = GV_CONSUMERS / CG;   // k slices
  static constexpr int SK = 64 * KQ;             // k a stage
  static constexpr int WBOX = BN * 128;          // one weight box (128 k)
  static constexpr int XR = 16 * MT;             // x rows a box
  static constexpr int XBOX = XR * 128;          // one x box: 64 bf16 / 32 f32 of k
  static constexpr int XBOXES = SK / (XF32 ? 32 : 64);
  static constexpr int STAGE = GV_W + XBOXES * XBOX;
  static constexpr int RED = GV_CONSUMERS * MT * 16 * 32 * 4;  // every warp's sums
  static int smem(int stages) { return stages * STAGE + RED + 2 * stages * 8 + 1024; }
};

struct GemvParams {
  const float* s;  // (N,) column scales
  void* y;         // (R, N)
  float* ws;       // (splits, R, N) partial sums, when split
  int* cnt;        // (tiles,) units finished a column tile, when split
  int R, K, N;
  int steps;       // stages of K
  int per;         // stages a unit
  int splits;      // K ranges
  int tiles;       // column tiles
  int units;       // tiles * splits
  int stages;      // ring depth
  int tx;          // bytes a stage: the weight, and x's boxes of XROWS rows
};

// Four int8 (one 32-bit word, bytes b0..b3) -> bf16 pairs {b0, b1}, {b2,
// b3}, exactly: the low seven bits of each byte become the mantissa of the
// bf16 128 + (b & 0x7f) and its sign bit the bf16 128 or 256, whose
// difference is v = b (two's complement) in one bf16x2 subtraction (the
// result, an integer of magnitude <= 128, is representable).
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t p0 = __byte_perm(w, 0u, 0x4140);  // [0 b1 0 b0]
  const uint32_t p1 = __byte_perm(w, 0u, 0x4342);  // [0 b3 0 b2]
  const uint32_t a0 = (p0 & 0x007F007Fu) | 0x43004300u;
  const uint32_t s0 = (p0 & 0x00800080u) | 0x43004300u;
  const uint32_t a1 = (p1 & 0x007F007Fu) | 0x43004300u;
  const uint32_t s1 = (p1 & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a0),
                                    *reinterpret_cast<const __nv_bfloat162*>(&s0));
  const __nv_bfloat162 d1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a1),
                                    *reinterpret_cast<const __nv_bfloat162*>(&s1));
  lo = *reinterpret_cast<const uint32_t*>(&d0);
  hi = *reinterpret_cast<const uint32_t*>(&d1);
}

// The lane's 16 consecutive x values of row r at k offset 64 kq + 16t of
// the stage, as bf16 pairs, split into NS terms (NS = 1 for bf16 x; 3 for
// f32 x: x = hi + mid + lo exactly). The boxes hold 128-byte rows in the
// 128-byte swizzle: 16-byte unit u of row r at u ^ (r % 8).
template <int MT, bool XF32, int CG, int NS>
__device__ __forceinline__ void load_x(uint32_t (&out)[NS][8], const uint8_t* xs,
                                       int r, int kq, int t) {
  using T = GemvTile<MT, XF32, CG>;
  constexpr int ESZ = XF32 ? 4 : 2, PER_BOX = 128 / ESZ, UNITS = ESZ;
  const int k = 64 * kq + 16 * t;                 // within the stage
  const uint8_t* row = xs + (k / PER_BOX) * T::XBOX + r * 128;
  const int u0 = (k % PER_BOX) * ESZ / 16;        // first 16-byte unit
  if constexpr (!XF32) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const uint4 a = *reinterpret_cast<const uint4*>(row + (((u0 + i) ^ (r & 7)) << 4));
      out[0][4 * i] = a.x; out[0][4 * i + 1] = a.y;
      out[0][4 * i + 2] = a.z; out[0][4 * i + 3] = a.w;
    }
  } else {
    float v[16];
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(row + (((u0 + i) ^ (r & 7)) << 4));
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

// The weight row of each group of 8 that lane group g reads (the mma's
// column g): 4 (g % 2) + g / 2, so that the two lane groups of each 8-lane
// shared-memory phase meet opposite halves of the swizzled 128-byte row.
__device__ __forceinline__ int w_row(int g) { return ((g & 1) << 2) | (g >> 1); }

template <bool OUTF32>
__device__ __forceinline__ void store_out(void* y, size_t i, float v) {
  if constexpr (OUTF32) {
    static_cast<float*>(y)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  }
}

// A unit's epilogue, by all 256 consumer threads. Every warp has written its
// sums to `red` as [warp][(i * 4 + j) * 4 + e][lane] (c0, c1 at row g, cols
// 2t, 2t+1 of n8 group j of m16 tile i; c2, c3 at row g + 8); output (r, c)
// of the unit sums its k slices' values in slice order: mma column 8j + cc
// of column group c / 32 is output column w_row(cc) of the group of 8. A
// thread takes EL = BN XR / 256 outputs, consecutive threads consecutive
// columns. Without a split it applies s[n] and writes y; a split's unit
// stores its f32 partial sums and leaves the counting to close_splits.
template <int MT, int CG, bool OUTF32>
__device__ __forceinline__ void gemv_epilogue(const float* red, const GemvParams& p,
                                              int sl, int tile) {
  constexpr int BN = 32 * CG, KQ = GV_CONSUMERS / CG, ROWS = 16 * MT;
  constexpr int EL = BN * ROWS / (GV_CONSUMERS * 32), ACC = MT * 16 * 32;
  const int tid = threadIdx.x, n0 = tile * BN;
  float v[EL];
#pragma unroll
  for (int m = 0; m < EL; ++m) {
    const int q = tid + GV_CONSUMERS * 32 * m, r = q / BN, c = q % BN;
    const int cg = c / 32, j = (c % 32) / 8, c8 = c % 8;
    const int cc = ((c8 & 3) << 1) | (c8 >> 2);  // w_row's inverse
    const int lane = 4 * (r % 8) + (cc >> 1);
    const int e = 2 * ((r % 16) / 8) + (cc & 1);
    const float* src = red + (((r / 16) * 4 + j) * 4 + e) * 32 + lane;
    float sum = src[cg * ACC];
#pragma unroll
    for (int kq = 1; kq < KQ; ++kq) sum += src[(kq * CG + cg) * ACC];
    v[m] = sum;
  }
  named_sync(1, GV_CONSUMERS * 32);  // `red` is free for the next unit
  float* part = p.ws + (size_t)sl * p.R * p.N;
#pragma unroll
  for (int m = 0; m < EL; ++m) {
    const int q = tid + GV_CONSUMERS * 32 * m, r = q / BN, n = n0 + q % BN;
    if (r >= p.R || n >= p.N) continue;
    if (p.splits > 1) {
      part[(size_t)r * p.N + n] = v[m];
    } else {
      store_out<OUTF32>(p.y, (size_t)r * p.N + n, v[m] * __ldg(p.s + n));
    }
  }
}

// A split's bookkeeping, once at the CTA's end (by all 256 consumer
// threads, `queue` in the free exchange buffer): every writer fences its
// partial sums (one fence by the counting thread after a barrier measured a
// race: the other warps' stores were not yet visible to the closing unit),
// then warp 0 moves the counters of the CTA's units, 32 atomics in flight,
// and queues the tiles whose last unit this CTA ran; those tiles' partials
// are summed in K-range order (0 + p0 + p1 + ...), scaled by s[n] and
// written, and their counters set back to 0 for the next launch.
template <int MT, int CG, bool OUTF32>
__device__ __forceinline__ void close_splits(const GemvParams& p, int u_lo, int u_hi,
                                             int* queue) {
  constexpr int BN = 32 * CG, ROWS = 16 * MT;
  constexpr int EL = BN * ROWS / (GV_CONSUMERS * 32);
  const int tid = threadIdx.x;
  __threadfence();
  if (tid == 0) queue[0] = 0;
  named_sync(2, GV_CONSUMERS * 32);
  if (tid < 32) {
    for (int u = u_lo + tid; u < u_hi; u += 32) {
      const int tile = u % p.tiles;
      if (atomicAdd(&p.cnt[tile], 1) == p.splits - 1)
        queue[1 + atomicAdd(&queue[0], 1)] = tile;
    }
  }
  named_sync(2, GV_CONSUMERS * 32);
  const int closing = queue[0];
  if (closing == 0) return;
  __threadfence();
  const size_t range = (size_t)p.R * p.N;
  for (int c = 0; c < closing; ++c) {
    const int tile = queue[1 + c], n0 = tile * BN;
    float sum[EL];
#pragma unroll
    for (int m = 0; m < EL; ++m) sum[m] = 0.f;
    for (int k = 0; k < p.splits; ++k) {
      const float* slice = p.ws + k * range;
      float w[EL];
#pragma unroll
      for (int m = 0; m < EL; ++m) {
        const int q = tid + GV_CONSUMERS * 32 * m, r = q / BN, n = n0 + q % BN;
        w[m] = r < p.R && n < p.N ? __ldcg(slice + (size_t)r * p.N + n) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < EL; ++m) sum[m] += w[m];
    }
#pragma unroll
    for (int m = 0; m < EL; ++m) {
      const int q = tid + GV_CONSUMERS * 32 * m, r = q / BN, n = n0 + q % BN;
      if (r < p.R && n < p.N)
        store_out<OUTF32>(p.y, (size_t)r * p.N + n, sum[m] * __ldg(p.s + n));
    }
    if (tid == 0) p.cnt[tile] = 0;
  }
}

// grid: C persistent CTAs of 8 consumer warps and one producer warp
template <int MT, bool XF32, bool OUTF32, int CG>
__global__ void __launch_bounds__(GV_THREADS, 1)
int8_gemv_kernel(const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_x, const GemvParams p) {
  using T = GemvTile<MT, XF32, CG>;
  constexpr int NS = XF32 ? 3 : 1;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned (the 128-byte swizzle's period) by arithmetic on the
  // shared array itself, so that the compiler keeps shared loads and stores
  // (the same offset through an integer compiled to generic loads, which
  // faulted with a misaligned address in one instantiation)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + p.stages * T::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * T::STAGE + T::RED);
  uint64_t* empty = full + p.stages;

  const int u_lo = (int)((long long)blockIdx.x * p.units / gridDim.x);
  const int u_hi = (int)((long long)(blockIdx.x + 1) * p.units / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GV_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == GV_CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----------------------------
    if (lane == 0) {
      tma_prefetch_desc(&tm_w);
      tma_prefetch_desc(&tm_x);
      int it = 0;
      for (int u = u_lo; u < u_hi; ++u) {
        const int sl = u / p.tiles, n0 = (u % p.tiles) * T::BN;
        const int kt1 = min(p.steps, (sl + 1) * p.per);
        for (int kt = sl * p.per; kt < kt1; ++kt, ++it) {
          const int st = it % p.stages;
          mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
          uint8_t* dst = ring + st * T::STAGE;
          mbar_arrive_expect_tx(&full[st], p.tx);
#pragma unroll
          for (int b = 0; b < T::SK / 128; ++b)
            tma_load_4d(dst + b * T::WBOX, &tm_w, &full[st], kt * T::SK + 128 * b,
                        n0, 0, 0);
#pragma unroll
          for (int b = 0; b < T::XBOXES; ++b)
            tma_load_4d(dst + GV_W + b * T::XBOX, &tm_x, &full[st],
                        kt * T::SK + b * (XF32 ? 32 : 64), 0, 0, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------------
  const int cg = warp % CG;  // columns 32 cg .. 32 cg + 31 of the unit
  const int kq = warp / CG;  // k 64 kq .. 64 kq + 63 of each stage
  const int g = lane >> 2, t = lane & 3;
  const int wr = w_row(g);
  // the lane's 16 weight bytes of a column row: box kq / 2, unit 4 (kq % 2)
  // + t of the 128-byte row, in the swizzle
  const int wofs = (kq >> 1) * T::WBOX + (((4 * (kq & 1) + t) ^ wr) << 4);
  int it = 0;
  for (int u = u_lo; u < u_hi; ++u) {
    const int sl = u / p.tiles, tile = u % p.tiles;
    const int kt1 = min(p.steps, (sl + 1) * p.per);
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int kt = sl * p.per; kt < kt1; ++kt, ++it) {
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      const uint8_t* ws = ring + st * T::STAGE;
      uint4 wv[4];  // 16 weight bytes of 4 columns
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const uint4*>(ws + (32 * cg + 8 * j + wr) * 128 + wofs);
      uint32_t xa[MT][2][NS][8];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load_x<MT, XF32, CG, NS>(xa[i][h], ws + GV_W, 16 * i + 8 * h + g, kq, t);
      __syncwarp();  // the warp's bytes of the stage are in registers
      if (lane == 0) mbar_arrive(&empty[st]);
      // mma step s4 takes the lane's bytes 4 s4 .. 4 s4 + 3 (the map in the
      // header)
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = s4 == 0 ? wv[j].x : s4 == 1 ? wv[j].y
                              : s4 == 2 ? wv[j].z : wv[j].w;
          uint32_t b0, b1;
          s8x4_to_bf16(word, b0, b1);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int sp = 0; sp < NS; ++sp) {
              const uint32_t a[4] = {xa[i][0][sp][2 * s4], xa[i][1][sp][2 * s4],
                                     xa[i][0][sp][2 * s4 + 1],
                                     xa[i][1][sp][2 * s4 + 1]};
              mma_bf16(acc[i][j], a, b0, b1);
            }
        }
      }
    }

    // every warp's sums to shared memory, then the unit's epilogue by all
    constexpr int ACC = MT * 16 * 32;  // floats of one warp's sums
    float* rw = red + warp * ACC;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rw[((i * 4 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
    named_sync(1, GV_CONSUMERS * 32);
    gemv_epilogue<MT, CG, OUTF32>(red, p, sl, tile);
  }
  if (p.splits > 1) close_splits<MT, CG, OUTF32>(p, u_lo, u_hi, reinterpret_cast<int*>(red));
}

template <int MT, bool XF32, bool OUTF32, int CG>
int gemv_launch(const CUtensorMap& tw, const CUtensorMap& tx, const GemvParams& p,
                int ctas, cudaStream_t stream) {
  using T = GemvTile<MT, XF32, CG>;
  const int smem = T::smem(p.stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = int8_gemv_kernel<MT, XF32, OUTF32, CG>;
  static int configured = 0;  // per instantiation
  if (configured < smem) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    configured = smem;
  }
  kernel<<<ctas, GV_THREADS, smem, stream>>>(tw, tx, p);
  return (int)cudaGetLastError();
}

template <int MT, bool XF32, bool OUTF32>
int gemv_launch_cg(const CUtensorMap& tw, const CUtensorMap& tx, const GemvParams& p,
                   int ctas, int cg, cudaStream_t stream) {
  switch (cg) {
    case 1: return gemv_launch<MT, XF32, OUTF32, 1>(tw, tx, p, ctas, stream);
    case 2: return gemv_launch<MT, XF32, OUTF32, 2>(tw, tx, p, ctas, stream);
    default: return gemv_launch<MT, XF32, OUTF32, 4>(tw, tx, p, ctas, stream);
  }
}

}  // namespace

// x (R, K) bf16 (x_f32 = 0) or f32 row-major, 1 <= R <= 32; wt (N, K) int8
// row-major (the transposed storage of the (K, N) weight); s (N,) f32; y (R,
// N) bf16 (y_f32 = 0) or f32. K and N are multiples of 16, the bases
// 16-byte aligned. The plan is ops/int8_matmul.py's gemv_plan(R, K, N):
// units of `block_n` columns (32, 64 or 128) x `per` stages of 16384 /
// block_n bytes of k (so ceil(steps / per) K ranges), `stages` ring stages,
// `ctas` persistent CTAs (at most the units). With more than one K range,
// ws holds splits * R * N floats and cnt one int a column tile, all 0
// before the first launch; the kernel leaves them at 0. Launches on
// `stream`; returns a CUDA error code (or 1000 + a refused tensor map's
// CUresult).
extern "C" int thinkdiff_int8_gemv(const void* x, const void* wt, const void* s,
                                   void* y, void* ws, void* cnt, int R, int K,
                                   int N, int block_n, int per, int stages,
                                   int ctas, int x_f32, int y_f32, void* stream) {
  if (R <= 0 || R > 32 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
      (block_n != 32 && block_n != 64 && block_n != 128) || per <= 0 ||
      stages < 2 || stages > GV_MAX_STAGES || encoder() == nullptr)
    return (int)cudaErrorInvalidValue;
  const int sk = GV_W / block_n;  // k a stage
  GemvParams p;
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(cnt);
  p.R = R;
  p.K = K;
  p.N = N;
  p.steps = (K + sk - 1) / sk;
  p.per = per;
  p.splits = (p.steps + per - 1) / per;
  p.tiles = (N + block_n - 1) / block_n;
  p.units = p.tiles * p.splits;
  p.stages = stages;
  // x's boxes copy R rows rounded up to 8 into slots of 16 MT rows: the
  // mma rows past them read stale shared memory, and their sums are never
  // stored
  const int mt = R > 16 ? 2 : 1, xrows = (R + 7) / 8 * 8;
  p.tx = GV_W + (16384 / block_n / (x_f32 ? 32 : 64)) * xrows * 128;
  // a split's closing queue (the tiles a CTA closes) lives in the exchange
  // buffer: 4096 ints at least
  if (ctas <= 0 || ctas > p.units ||
      (p.splits > 1 && (ws == nullptr || cnt == nullptr || p.tiles >= 4096)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  int rc;
  if ((rc = cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, N, K, 128,
                          block_n, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (rc = x_f32 ? cached_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, R, K,
                                  32, xrows, CU_TENSOR_MAP_SWIZZLE_128B)
                  : cached_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, R, K,
                                  64, xrows, CU_TENSOR_MAP_SWIZZLE_128B)))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  const int cg = block_n / 32;
  switch ((mt == 2 ? 4 : 0) | (x_f32 ? 2 : 0) | (y_f32 ? 1 : 0)) {
    case 0: return gemv_launch_cg<1, false, false>(tw, tx, p, ctas, cg, st);
    case 1: return gemv_launch_cg<1, false, true>(tw, tx, p, ctas, cg, st);
    case 2: return gemv_launch_cg<1, true, false>(tw, tx, p, ctas, cg, st);
    case 3: return gemv_launch_cg<1, true, true>(tw, tx, p, ctas, cg, st);
    case 4: return gemv_launch_cg<2, false, false>(tw, tx, p, ctas, cg, st);
    case 5: return gemv_launch_cg<2, false, true>(tw, tx, p, ctas, cg, st);
    case 6: return gemv_launch_cg<2, true, false>(tw, tx, p, ctas, cg, st);
    default: return gemv_launch_cg<2, true, true>(tw, tx, p, ctas, cg, st);
  }
}
