// Weight-only int8 GEMM for Hopper at any row count, forward and input
// gradient, with the weight streamed as int8 from HBM:
//   forward:        y  = out(f32(bf16(x) @ bf16(Wq)) * s[col])
//   input gradient: dx = out(f32(bf16(f32(g) * s[n]) @ bf16(Wq)^T))
//
// Replaces the Pallas TPU kernels thinkdiff_tpu/ops/int8_matmul.py
// `_wide_fwd_kernel` (wrapper `_int8_matmul_wide_fwd`) and `_wide_bwd_kernel`
// (wrapper `_int8_matmul_wide_bwd`), the two halves of the `int8_matmul_wide`
// op (a frozen weight: no dW). No model path of either package calls the op.
//
// What bounds it on an H100: at the flan-t5-xxl shapes (R = 1024 rows, K or
// N = 10240) the bf16 tensor-core rate (989 TFLOP/s dense). bf16 wgmma
// reads B only from shared memory and only as bf16, so the int8 weight has
// to become bf16 inside the CTA without costing the products their shared
// memory bandwidth. Design (one kernel for both halves):
//  - Each computes the transpose of its output, so that the weight is
//    wgmma's A operand, which may come from registers: every consumer
//    thread converts its own A fragments from the int8 tile exactly (the
//    int8 byte as the low mantissa byte of an f32 2^23 + 128 + v), and the
//    bf16 weight never exists in shared memory or HBM. The forward reads
//    the (N, K) storage's rows (k contiguous: 16-bit loads in the 64-byte
//    swizzle); the input gradient needs its columns, which ldmatrix .trans
//    on byte pairs delivers for two adjacent output columns at once (the
//    fragment's rows are permuted, and the epilogue stores them in order).
//    B is the activation, K-major: x as TMA copied it; for the gradient,
//    bf16(f32(g) * s[n]), which the consumers write one stage ahead (while
//    the current stage's products run) into one of three tiles in the
//    swizzle g arrived in, with s[n] copied by TMA beside g.
//  - Work units are 128 output columns x BR output rows in the forward (BR
//    128 or 256, the host's wide_plan) and 256 columns x 128 rows in the
//    gradient (g converted half as often a product), rows fastest, so the
//    CTAs in flight share each weight tile; persistent CTAs, one an SM,
//    walk the units, and the ring runs on across units.
//  - One producer thread issues TMA copies into a ring of `stages` stages
//    with full/empty mbarriers: each holds 64 of the contraction of the
//    activation (bf16, or f32 g) and of the int8 weight (UINT8). Rows and
//    columns past the extents read as zero, which adds nothing.
//  - Two consumer warpgroups of 64 (gradient: 128) output columns issue
//    wgmma m64nBRk16 (A from registers), four k16 steps a stage, and load
//    the next stage's A while those run (wgmma_wait<1>, A double-buffered).
//    Each output's sum runs over the contraction in one fixed order, with
//    no split and no atomics: every call and every plan gives the same bits.
//  - Epilogue: the forward's acc * s[col] in f32, one rounding to the
//    output type, transposed into a shared-memory tile per warpgroup
//    (stmatrix .trans for bf16), which one thread hands to a TMA store that
//    clips the ragged edges and drains during the next unit's products.
// The host caches each tensor map per address, shape and box. f32 x is
// rounded to bf16 by the wrapper before the forward's launch: the same
// bits as a rounding in the kernel (its product operand is bf16).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int W_BK = 64;       // contraction a stage: one 128-byte bf16 row
constexpr int W_CVT = 3;       // the input gradient's converted tiles
constexpr int W_THREADS = 384;
constexpr int W_MAX_STAGES = 8;

struct WideParams {
  const float* scale;  // (N,) column scales of the (K, N) weight
  int rows, cols;      // the output (rows, cols): (R, N) forward, (R, K) gradient
  int steps;           // stages of W_BK in the contraction
  int stages;
};

// A unit is 128 MW output columns (weight rows in the forward, weight
// columns in the input gradient: MW m64 blocks of A a consumer warpgroup)
// x BR output rows (wgmma's N). The forward runs MW 1 with BR 128 or 256;
// the input gradient MW 2 with BR 128, which halves the conversions of g
// a product and leaves room for three converted tiles.
template <int BR, int MW, bool BWD, bool GF32>
struct WideTile {
  // a ring stage: the activation as TMA copies it (x, or g in bf16 or f32),
  // then the weight (128 n x 64 k forward; MW tiles of 64 n x 128 k), then
  // (gradient) s[n] of the stage
  static constexpr int ACT = BR * W_BK * (GF32 ? 4 : 2);
  static constexpr int WT = MW * 128 * W_BK;
  // the gradient's 64 column scales of the stage, in a 1 KB slot
  static constexpr int RAW = ACT + WT + (BWD ? 1024 : 0);
  static constexpr int TX = ACT + WT + (BWD ? W_BK * 4 : 0);  // bytes copied
  static constexpr int CVT = BR * W_BK * 2;  // bf16(g * s)
  static constexpr int NCVT = BWD ? W_CVT : 0;
  static constexpr int OUT = MW * BR * 128;  // a warpgroup's staging tiles
  // the ring, the converted tiles, two staging tiles, the ring's full and
  // empty barriers and the converted tiles' empty ones, 1024 B of alignment
  static int smem(int stages) {
    return stages * RAW + NCVT * CVT + 2 * OUT + (2 * stages + NCVT) * 8 + 1024;
  }
};

// two int8 (bytes s0, s1 of u, biased to unsigned) -> a bf16 pair, exactly:
// each byte becomes the low mantissa byte of 2^23 + 128 + v, whose f32
// difference from 2^23 + 128 is v (integers of |v| <= 128 are exact in
// bf16)
__device__ __forceinline__ uint32_t s8sel_to_bf16(uint32_t u, int s0, int s1) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | s0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | s1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The input gradient's A fragments of one stage: W^T, rows the output's k
// from kb (this warp's 16), contraction n, from the int8 tile of 64 n-rows
// x 128 k (128-byte swizzle). ldmatrix .trans on byte pairs hands lane (g,
// t) the bytes (n 2t, k kb + 2g), (2t, kb + 2g + 1), (2t + 1, kb + 2g),
// (2t + 1, kb + 2g + 1): A rows kb + 2g and kb + 2g + 1 both. So the
// fragment's row g stands for k = kb + 2g and its row g + 8 for kb + 2g + 1
// (a permutation of A's rows, which the epilogue undoes).
__device__ __forceinline__ void load_wt_frags(uint32_t (&a)[4][4],
                                              const uint8_t* wr, int kb, int lane) {
  const int unit = kb >> 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // k16 steps 2h, 2h + 1: n 32h + lane
    const int n = 32 * h + lane;
    uint32_t r[4];
    ldsm_x4_trans(r, wr + n * 128 + ((unit ^ (n & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t lo = r[2 * e] ^ 0x80808080u, hi = r[2 * e + 1] ^ 0x80808080u;
      a[2 * h + e][0] = s8sel_to_bf16(lo, 0, 2);
      a[2 * h + e][1] = s8sel_to_bf16(lo, 1, 3);
      a[2 * h + e][2] = s8sel_to_bf16(hi, 0, 2);
      a[2 * h + e][3] = s8sel_to_bf16(hi, 1, 3);
    }
  }
}

// the input gradient's B tile: bf16(f32(g) * s[n]) for BR rows x 64 n, in
// the 128-byte swizzle g arrived in (bf16: one 64-column box; f32: two
// 32-column boxes of BR rows), with the stage's scales `ss` as TMA copied
// them (0 past N, where g is 0 too), by the 256 consumer threads: thread
// tw writes 16-byte unit tw % 8 (n 8 (tw % 8) .. + 7 of the stage) of
// rows tw / 8 + 32 i.
template <int BR, bool GF32>
__device__ __forceinline__ void convert_g(const uint8_t* gr, uint8_t* ga,
                                          const float* ss, int tw) {
  const int v = tw & 7;
  float sc[8];
  const float4 s0 = reinterpret_cast<const float4*>(ss)[2 * v];
  const float4 s1 = reinterpret_cast<const float4*>(ss)[2 * v + 1];
  sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
  sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
#pragma unroll
  for (int r = tw >> 3; r < BR; r += 32) {
    const int at = r * 128 + ((v ^ (r & 7)) << 4);
    float f[8];
    if constexpr (GF32) {
      const uint8_t* box = gr + (v >> 2) * (BR * 128) + r * 128;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 q = *reinterpret_cast<const float4*>(
            box + (((2 * (v & 3) + e) ^ (r & 7)) << 4));
        f[4 * e] = q.x; f[4 * e + 1] = q.y; f[4 * e + 2] = q.z; f[4 * e + 3] = q.w;
      }
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(gr + at);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[2 * e] = __low2float(h[e]);
        f[2 * e + 1] = __high2float(h[e]);
      }
    }
    *reinterpret_cast<uint4*>(ga + at) = make_uint4(
        pack_bf16x2(f[0] * sc[0], f[1] * sc[1]), pack_bf16x2(f[2] * sc[2], f[3] * sc[3]),
        pack_bf16x2(f[4] * sc[4], f[5] * sc[5]), pack_bf16x2(f[6] * sc[6], f[7] * sc[7]));
  }
}

// The input gradient's epilogue: a warpgroup's MW transposed blocks
// (fragment row g of warp w = output column kb + 64 j + 16 w + 2 g, row g
// + 8 the next column; accumulator columns = BR output rows from r0), so
// each thread holds adjacent column pairs: stored as pairs to staging
// tiles of BR rows x 64 columns in the 128-byte swizzle, then TMA stores.
// f32: two rounds of 32 columns.
template <int BR, int MW, bool OUTF32>
__device__ __forceinline__ void bwd_epilogue(const float (&acc)[MW][BR / 2],
                                             uint8_t* so, const CUtensorMap* tm_out,
                                             int r0, int kb, int wg, int wl) {
  const int warp = wl / 32, lane = wl % 32, q = lane % 4;
  const int kl = 16 * warp + 2 * (lane / 4);  // of a block's 64
#pragma unroll
  for (int half = 0; half < (OUTF32 ? 2 : 1); ++half) {
    if (wl == 0) bulk_wait_read<0>();  // the previous store has read it
    named_sync(2 + wg, 128);
    if (!OUTF32 || warp / 2 == half) {
#pragma unroll
      for (int j = 0; j < MW; ++j)
#pragma unroll
        for (int jb = 0; jb < BR / 8; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * jb + 2 * q + e;
            const float v0 = acc[j][4 * jb + e], v1 = acc[j][4 * jb + 2 + e];
            uint8_t* row = so + j * BR * 128 + r * 128;
            if constexpr (OUTF32) {
              const int c = kl - 32 * half;
              *reinterpret_cast<float2*>(row + (((c >> 2) ^ (r & 7)) << 4) +
                                         4 * (c & 3)) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<uint32_t*>(row + (((kl >> 3) ^ (r & 7)) << 4) +
                                           2 * (kl & 7)) = pack_bf16x2(v0, v1);
            }
          }
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (wl == 0) {
#pragma unroll
      for (int j = 0; j < MW; ++j)
        tma_store_4d(tm_out, so + j * BR * 128, kb + 64 * j + 32 * half, r0, 0,
                     0);
      bulk_commit();
    }
  }
}

// A consumer thread's m64k16 A fragments of one stage (four k16 steps)
// from the forward's int8 weight tile (rows of 64 bytes in the 64-byte
// swizzle: 16-byte unit u of row n at u ^ ((n / 2) % 4)), rows n0 and
// n0 + 8, as bf16: a[kk] = {(n0, 16kk + 2t..), (n0 + 8, 16kk + 2t..),
// (n0, 16kk + 8 + 2t..), (n0 + 8, 16kk + 8 + 2t..)}, the wgmma register
// A layout (each warp's m16k16 block)
__device__ __forceinline__ void load_w_frags(uint32_t (&a)[4][4],
                                             const uint8_t* wr, int n0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 8 * h;
    const uint8_t* row = wr + n * 64 + 2 * t;
    const int sw = (n >> 1) & 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint8_t* p = row + ((kk ^ sw) << 4);
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 8);
      const uint32_t u = (lo | (hi << 16)) ^ 0x80808080u;
      a[kk][h] = s8sel_to_bf16(u, 0, 1);
      a[kk][2 + h] = s8sel_to_bf16(u, 2, 3);
    }
  }
}

// keep A fragments that an in-flight wgmma reads in their registers
__device__ __forceinline__ void hold_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e]) :: "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(smem_u32(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// The forward's epilogue: a warpgroup's transposed tile (accumulator rows
// = 64 output columns from nb, columns = BR output rows from r0) times
// s[column], to a staging tile of BR rows x 64 columns in the 128-byte
// swizzle and a TMA store. bf16: stmatrix .trans writes each
// 8 x 8 block transposed, its 8 columns as one 16-byte unit of a row. f32:
// two rounds of 32 columns.
template <int BR, bool OUTF32>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[BR / 2],
                                             uint8_t* so, const CUtensorMap* tm_out,
                                             const float* scale, int r0, int nb,
                                             int cols, int wg, int wl) {
  const int warp = wl / 32, lane = wl % 32, g = lane / 4, q = lane % 4;
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = nb + 16 * warp + g + 8 * h;
    sc[h] = c < cols ? __ldg(scale + c) : 0.f;
  }
  if constexpr (!OUTF32) {
    if (wl == 0) bulk_wait_read<0>();  // the previous store has read it
    named_sync(2 + wg, 128);
    const int m = lane / 8, h = m & 1;
#pragma unroll
    for (int jb = 0; jb < BR / 8; jb += 2) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = jb + (e >> 1), hh = e & 1;
        v[e] = pack_bf16x2(acc[4 * b + 2 * hh] * sc[hh],
                           acc[4 * b + 2 * hh + 1] * sc[hh]);
      }
      const int r = 8 * (jb + (m >> 1)) + lane % 8;
      stmatrix_x4_trans(so + r * 128 + (((2 * warp + h) ^ (r & 7)) << 4), v[0],
                        v[1], v[2], v[3]);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (wl == 0) {
      tma_store_4d(tm_out, so, nb, r0, 0, 0);
      bulk_commit();
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (wl == 0) bulk_wait_read<0>();
      named_sync(2 + wg, 128);
      if (warp / 2 == half) {
#pragma unroll
        for (int i = 0; i < BR / 2; ++i) {
          const int r = 8 * (i / 4) + 2 * q + (i % 2);
          const int col = 16 * (warp % 2) + g + 8 * ((i / 2) % 2);  // of 32
          *reinterpret_cast<float*>(so + r * 128 + (((col / 4) ^ (r & 7)) << 4) +
                                    4 * (col % 4)) = acc[i] * sc[(i / 2) % 2];
        }
      }
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (wl == 0) {
        tma_store_4d(tm_out, so, nb + 32 * half, r0, 0, 0);
        bulk_commit();
      }
    }
  }
}

// The forward's stage t: A (the weight tile's rows) into `a`, then four k16
// steps against x in the ring; the previous stage's group is then done, so
// its A (`prev`) and its ring slot are free. `first`: no previous stage in
// this unit (the last unit's ended with wgmma_wait<0>).
template <int BR>
__device__ __forceinline__ void fwd_stage(float (&acc)[1][BR / 2],
                                          uint32_t (&a)[1][4][4],
                                          uint32_t (&prev)[1][4][4], uint8_t* raw,
                                          uint64_t* full, uint64_t* empty,
                                          const WideParams& p, int& t, int wg,
                                          bool first) {
  using T = WideTile<BR, 1, false, false>;
  const int S = p.stages, s = t % S;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  mbar_wait(&full[s], (t / S) & 1);
  const uint8_t* st = raw + s * T::RAW;
  load_w_frags(a[0], st + T::ACT, 64 * wg + 16 * warp + lane / 4, lane % 4);
  fence_regs(acc[0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W_BK / 16; ++kk)
    wgmma_rs_kb<BR>(acc[0], a[0][kk], wgmma_desc(st + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc[0]);
  hold_frags(prev[0]);  // read by the group just waited out: kept till now
  if (!first) mbar_arrive(&empty[(t - 1) % S]);
  ++t;
}

// The input gradient's conversion of stage u: bf16(g * s) into converted
// tile u % W_CVT (free once the products of stage u - W_CVT are done),
// published to wgmma by a bar.sync of the 256 consumers.
template <int BR, int MW, bool GF32>
__device__ __forceinline__ void bwd_convert(uint8_t* raw, uint8_t* cvt,
                                            uint64_t* full, uint64_t* cvt_empty,
                                            int S, int u) {
  using T = WideTile<BR, MW, true, GF32>;
  mbar_wait(&full[u % S], (u / S) & 1);
  mbar_wait(&cvt_empty[u % W_CVT], ((u / W_CVT) & 1) ^ 1);
  const uint8_t* st = raw + (u % S) * T::RAW;
  convert_g<BR, GF32>(st, cvt + (u % W_CVT) * T::CVT,
                      reinterpret_cast<const float*>(st + T::ACT + T::WT),
                      threadIdx.x);
  fence_proxy_async();  // the converted tile, to wgmma's async proxy
  named_sync(1, 256);
}

// The input gradient's stage t: A (the weight tile's columns) into `a`,
// which frees the ring slot (g was converted a stage earlier); the MW
// blocks' k16 steps against converted tile t % W_CVT; then, while they
// run, stage t + 1's conversion (`next`); then the previous stage's group
// is done, so its A (`prev`) and converted tile are free.
template <int BR, int MW, bool GF32>
__device__ __forceinline__ void bwd_stage(float (&acc)[MW][BR / 2],
                                          uint32_t (&a)[MW][4][4],
                                          uint32_t (&prev)[MW][4][4],
                                          uint8_t* raw, uint8_t* cvt,
                                          uint64_t* full, uint64_t* empty,
                                          uint64_t* cvt_empty, const WideParams& p,
                                          int& t, int wg, bool first, bool next) {
  using T = WideTile<BR, MW, true, GF32>;
  const int S = p.stages, s = t % S;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  mbar_wait(&full[s], (t / S) & 1);
  const uint8_t* st = raw + s * T::RAW;
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    const int kl = 64 * MW * wg + 64 * j + 16 * warp;  // of the unit's columns
    load_wt_frags(a[j], st + T::ACT + (kl >> 7) * 8192, kl & 127, lane);
  }
  mbar_arrive(&empty[s]);
  const uint8_t* sb = cvt + (t % W_CVT) * T::CVT;
#pragma unroll
  for (int j = 0; j < MW; ++j) fence_regs(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < MW; ++j)
#pragma unroll
    for (int kk = 0; kk < W_BK / 16; ++kk)
      wgmma_rs_kb<BR>(acc[j], a[j][kk], wgmma_desc(sb + kk * 32, 16, 1024), 1);
  wgmma_commit();
  if (next) bwd_convert<BR, MW, GF32>(raw, cvt, full, cvt_empty, S, t + 1);
  wgmma_wait<1>();
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    fence_regs(acc[j]);
    hold_frags(prev[j]);  // read by the group just waited out: kept till now
  }
  if (!first) mbar_arrive(&cvt_empty[(t - 1) % W_CVT]);
  ++t;
}

// Both halves as the transpose of the output, a 128 MW-column x BR-row unit
// at a time, with A the weight converted from int8 into registers by each
// consumer and B the activation in shared memory (K-major):
//   forward (BWD 0):  y^T = W x^T, A = the (N, K) storage's rows (k
//     contiguous), B = x (R, K) bf16 as TMA copied it; y (R, N) in
//     OUTF32 ? f32 : bf16 after acc * s[column];
//   input gradient:  dx^T = W^T bf16(g s)^T, A = the storage's columns (n
//     contiguous in a column only through ldmatrix .trans), B = g (R, N)
//     (bf16, or f32 with GF32) scaled and rounded into a converted tile.
template <int BR, int MW, bool BWD, bool GF32, bool OUTF32>
__global__ void __launch_bounds__(W_THREADS, 1)
int8_wide_kernel(const __grid_constant__ CUtensorMap tm_act,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_out, const WideParams p) {
  using T = WideTile<BR, MW, BWD, GF32>;
  const int S = p.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* raw = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cvt = raw + S * T::RAW;
  uint8_t* out = cvt + T::NCVT * T::CVT;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * T::OUT);
  uint64_t* empty = full + S;
  uint64_t* cvt_empty = empty + S;  // the input gradient's
  const int tiles_r = (p.rows + BR - 1) / BR;
  const int n_work = tiles_r * ((p.cols + 128 * MW - 1) / (128 * MW));

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < T::NCVT; ++b) mbar_init(&cvt_empty[b], 256);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread ------------------------------------------
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tm_act);
      tma_prefetch_desc(&tm_w);
      int t = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const int r0 = (w % tiles_r) * BR, c0 = (w / tiles_r) * 128 * MW;
        for (int kt = 0; kt < p.steps; ++kt, ++t) {
          const int s = t % S, k0 = kt * W_BK;
          mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
          uint8_t* st = raw + s * T::RAW;
          mbar_arrive_expect_tx(&full[s], T::TX);
          tma_load_4d(st, &tm_act, &full[s], k0, r0, 0, 0);
          if constexpr (GF32)
            tma_load_4d(st + BR * 128, &tm_act, &full[s], k0 + 32, r0, 0, 0);
          if constexpr (BWD) {
#pragma unroll
            for (int h = 0; h < MW; ++h)
              tma_load_4d(st + T::ACT + h * 8192, &tm_w, &full[s], c0 + 128 * h,
                          k0, 0, 0);
            tma_load_4d(st + T::ACT + T::WT, &tm_s, &full[s], k0, 0, 0, 0);
          } else {
            tma_load_4d(st + T::ACT, &tm_w, &full[s], k0, c0, 0, 0);
          }
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    regs_alloc<232>();
    const int wl = threadIdx.x % 128;
    float acc[MW][BR / 2];
    uint32_t a0[MW][4][4], a1[MW][4][4];  // A of even and odd stages
    int t = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int r0 = (w % tiles_r) * BR, c0 = (w / tiles_r) * 128 * MW;
#pragma unroll
      for (int j = 0; j < MW; ++j)
#pragma unroll
        for (int i = 0; i < BR / 2; ++i) acc[j][i] = 0.f;
      if constexpr (BWD) {
        bwd_convert<BR, MW, GF32>(raw, cvt, full, cvt_empty, S, t);
        for (int kt = 0; kt < p.steps; kt += 2) {
          bwd_stage<BR, MW, GF32>(acc, a0, a1, raw, cvt, full, empty, cvt_empty,
                                  p, t, wg, kt == 0, kt + 1 < p.steps);
          if (kt + 1 < p.steps)
            bwd_stage<BR, MW, GF32>(acc, a1, a0, raw, cvt, full, empty,
                                    cvt_empty, p, t, wg, false, kt + 2 < p.steps);
        }
      } else {
        for (int kt = 0; kt < p.steps; kt += 2) {
          fwd_stage<BR>(acc, a0, a1, raw, full, empty, p, t, wg, kt == 0);
          if (kt + 1 < p.steps)
            fwd_stage<BR>(acc, a1, a0, raw, full, empty, p, t, wg, false);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        fence_regs(acc[j]);
        hold_frags(a0[j]);
        hold_frags(a1[j]);
      }
      if constexpr (BWD) {
        mbar_arrive(&cvt_empty[(t - 1) % W_CVT]);
        bwd_epilogue<BR, MW, OUTF32>(acc, out + wg * T::OUT, &tm_out, r0,
                                     c0 + 64 * MW * wg, wg, wl);
      } else {
        mbar_arrive(&empty[(t - 1) % S]);
        fwd_epilogue<BR, OUTF32>(acc[0], out + wg * T::OUT, &tm_out, p.scale,
                                 r0, c0 + 64 * wg, p.cols, wg, wl);
      }
    }
    if (wl == 0) bulk_wait<0>();  // the last store, before the CTA exits
  }
}

template <int BR, int MW, bool BWD, bool GF32, bool OUTF32>
int wide_launch(const CUtensorMap& ta, const CUtensorMap& tw,
                const CUtensorMap& ts, const CUtensorMap& tout,
                const WideParams& p, cudaStream_t stream) {
  const int smem = WideTile<BR, MW, BWD, GF32>::smem(p.stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = int8_wide_kernel<BR, MW, BWD, GF32, OUTF32>;
  static int configured = 0, sms = 0;  // per instantiation
  if (configured < smem) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    configured = smem;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long n_work = (long long)((p.rows + BR - 1) / BR) *
                           ((p.cols + 128 * MW - 1) / (128 * MW));
  const int grid = (int)(n_work < sms ? n_work : sms);  // persistent
  kernel<<<grid, W_THREADS, smem, stream>>>(ta, tw, ts, tout, p);
  return (int)cudaGetLastError();
}

// the activation's and the output's maps: bf16 in 64-column boxes, f32 in
// 32-column ones, `rows` rows, the 128-byte swizzle
inline int act_map(CUtensorMap* m, const void* base, int rows, int cols,
                   bool f32, int box_rows) {
  return f32 ? cached_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows,
                             cols, 32, box_rows, CU_TENSOR_MAP_SWIZZLE_128B)
             : cached_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows,
                             cols, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool wide_args_ok(int R, int K, int N, int block, int stages) {
  return R > 0 && K > 0 && N > 0 && K % 16 == 0 && N % 16 == 0 &&
         (block == 128 || block == 256) && stages >= 2 &&
         stages <= W_MAX_STAGES && encoder() != nullptr;
}

}  // namespace

// x (R, K) bf16 row-major (the wrapper rounds f32 x to bf16 first); wt (N,
// K) int8 row-major (the transposed storage of the (K, N) weight); s (N,)
// f32; y (R, N) f32 (out_f32) or bf16. K and N are multiples of 16, the
// bases 16-byte aligned. The plan (block: output rows a unit, stages) is
// ops/int8_matmul.py's wide_plan(R, K, N). Launches on `stream`; returns a
// CUDA error code (or 1000 + a refused tensor map's CUresult).
extern "C" int thinkdiff_int8_wide_fwd(const void* x, const void* wt,
                                       const void* s, void* y, int R, int K,
                                       int N, int out_f32, int block,
                                       int stages, void* stream) {
  if (!wide_args_ok(R, K, N, block, stages)) return (int)cudaErrorInvalidValue;
  const WideParams p{static_cast<const float*>(s), R, N,
                     (K + W_BK - 1) / W_BK, stages};
  CUtensorMap ta, tw, tout;
  int rc;
  if ((rc = act_map(&ta, x, R, K, false, block)) ||
      (rc = cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, N, K, W_BK,
                          128, CU_TENSOR_MAP_SWIZZLE_64B)) ||
      (rc = act_map(&tout, y, R, N, out_f32, block)))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  if (block == 256)
    return out_f32 ? wide_launch<256, 1, false, false, true>(ta, tw, tw, tout, p, st)
                   : wide_launch<256, 1, false, false, false>(ta, tw, tw, tout, p, st);
  return out_f32 ? wide_launch<128, 1, false, false, true>(ta, tw, tw, tout, p, st)
                 : wide_launch<128, 1, false, false, false>(ta, tw, tw, tout, p, st);
}

// g (R, N) bf16 (f32 = 0) or f32 row-major; wt (N, K) int8 row-major; s (N,)
// f32; dx (R, K) in g's type. K and N are multiples of 16, the bases 16-byte
// aligned. The plan (block: output rows a unit, 128 with 256 columns;
// stages) is wide_plan(R, N, K, f32=f32, backward=True). Launches on `stream`; returns a CUDA error
// code (or 1000 + a refused tensor map's CUresult).
extern "C" int thinkdiff_int8_wide_bwd(const void* g, const void* wt,
                                       const void* s, void* dx, int R, int K,
                                       int N, int f32, int block, int stages,
                                       void* stream) {
  if (!wide_args_ok(R, K, N, block, stages) || block != 128)
    return (int)cudaErrorInvalidValue;
  const WideParams p{static_cast<const float*>(s), R, K,
                     (N + W_BK - 1) / W_BK, stages};
  CUtensorMap ta, tw, ts, tout;
  int rc;
  if ((rc = act_map(&ta, g, R, N, f32, block)) ||
      (rc = cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, N, K, 128,
                          W_BK, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (rc = cached_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, 1, N, W_BK,
                          1, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (rc = act_map(&tout, dx, R, K, f32, block)))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  // 128 rows x 256 columns a unit
  return f32 ? wide_launch<128, 2, true, true, true>(ta, tw, ts, tout, p, st)
             : wide_launch<128, 2, true, false, false>(ta, tw, ts, tout, p, st);
}
