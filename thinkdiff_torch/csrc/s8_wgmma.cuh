// The w8a8 GEMM on Hopper, shared by the forward (s8_gemm.cu, #2), the
// input gradient (s8_gemm_bwd.cu, #7) and the quantize-in-kernel forward
// (s8_gemm_qx.cu, #12), which differ in their operands, the epilogue's
// column scale and, for #12, what runs before and after the mainloop
// (s8_body, below):
//   out[r, c] = bf16(float(sum_k A[r, k] * B[c, k]) * srow[r] (* scol[c]))
// for int8 A (M, Kc) and B (Nc, Kc), both row-major with the contraction
// contiguous (K-major, the layout 8-bit wgmma reads without a transpose).
// The int32 sum is exact whatever the order or split of the contraction
// (127^2 * Kc < 2^31 for the repository's Kc <= 32128).
//
// What bounds it on an H100: at prefill and training rows the int8 tensor
// cores (1,979 TOP/s dense); at decode rows (R <= 32) the weight's bytes
// (3.35 TB/s). Design:
//  - Work units are (BM x BN output tile, split of the contraction), tile
//    rows fastest, so the CTAs in flight share each weight (B) tile and
//    read it from device memory about once. Persistent CTAs, one an SM,
//    walk the units; the ring runs on across units, so the next unit's
//    first stages load during this one's epilogue.
//  - One producer thread issues TMA copies of 128-byte K slices of A (BM
//    rows) and B (BN rows), 128-byte swizzle, into a ring of `stages`
//    stages with full/empty mbarriers. Rows and K past the matrices'
//    extents read as zero, which adds nothing to the sums.
//  - BM / 64 consumer warpgroups of 64 rows issue wgmma m64nBNk32
//    s32.s8.s8 from shared memory, four k32 steps a stage, and release a
//    stage once the next one's products are issued (wgmma_wait<1>).
//  - Epilogue: float(acc) * srow[r] (* scol[c]) in f32, in that order, one
//    round to bf16, into a shared-memory tile per warpgroup (64-column boxes
//    in the 128-byte swizzle), which one thread hands to a TMA store: the
//    store drains while the warpgroup runs the next unit's products, and
//    the map clips the ragged M and Nc edges. (With bf16 pairs stored from
//    registers instead, wi_fused's forward took 0.194 ms against 0.123 on
//    an H100; PERF.md.)
//    Split (#2 and #7: the plan splits where the tiles are short of a
//    wave): each unit writes its int32 partial tile from registers to the
//    workspace (split, M, Nc), and s8_split_sum adds the splits in int32,
//    in order, and applies the same epilogue, so every split gives the
//    same bits.
//  - #12 only: its A rows are quantized in the same launch (s8_quant.cuh);
//    the producer issues the first unit's B slices, then waits for the
//    unit's row tile, then issues its A slices; later units wait for their
//    row tile once. Its plan never splits (one launch a call). An f32
//    output is stored from registers: a warp's 8-byte pairs fill whole
//    32-byte sectors (a bf16 pair fills half of one).
//  - The host encodes each tensor map once per address, shape and box and
//    keeps it: the weight is the same tensor on every call, and PyTorch's
//    caching allocator hands the activations and outputs the same
//    addresses again.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "s8_quant.cuh"

namespace {

constexpr int S8_BK = 128;  // bytes (int8 elements) of the contraction a stage holds
constexpr int S8_MAX_STAGES = 8;

struct S8Params {
  const float* srow;   // (M,)
  const float* scol;   // (Nc,) or null (a column scale of 1)
  void* out;           // (M, Nc) bf16 (f32: #12's OUTF32)
  int* ws;             // (split, M, Nc) int32 partials; null when split == 1
                       // (raw: the sums themselves, in plane 0)
  int M, Nc;
  int steps;           // K slices of S8_BK in the contraction
  int split, per;      // splits of the contraction, K slices a split
  int stages;
  bool raw;            // the int32 mode: the exact sums, no epilogue
};

template <int BM, int BN>
struct S8Tile {
  static constexpr int NWG = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int A_BYTES = BM * S8_BK;
  static constexpr int STAGE = (BM + BN) * S8_BK;
  static constexpr int OUT_BYTES = BN * 64 * 2;  // a warpgroup's bf16 tile
  // the stages, the output tiles, the stages' full and empty barriers, 16
  // bytes of flags (#12: its ticket and exit verdicts), and 1024 B of
  // alignment
  static int smem(int stages) {
    return stages * STAGE + NWG * OUT_BYTES + 2 * stages * 8 + 16 + 1024;
  }
};

// work unit w: its tile's first row and column and its K slices [k0, k1)
__device__ __forceinline__ void s8_unit(const S8Params& p, int w, int bm,
                                        int bn, int& m0, int& n0, int& z,
                                        int& k0, int& k1) {
  const int tiles_m = (p.M + bm - 1) / bm;
  const int tiles_n = (p.Nc + bn - 1) / bn;
  m0 = (w % tiles_m) * bm;
  const int rest = w / tiles_m;
  n0 = (rest % tiles_n) * bn;
  z = rest / tiles_n;
  k0 = z * p.per;
  k1 = min(p.steps, k0 + p.per);
}

// the epilogue of one output pair; `sc` holds the column scales, read only
// where `scaled`
__device__ __forceinline__ uint32_t s8_scale_pair(int a0, int a1, float srow,
                                                  bool scaled, float2 sc) {
  float v0 = (float)a0 * srow, v1 = (float)a1 * srow;
  if (scaled) {
    v0 *= sc.x;
    v1 *= sc.y;
  }
  return pack_bf16x2(v0, v1);
}

// One CTA's share of the GEMM: barrier set-up, the producer thread's TMA
// ring and the consumer warpgroups' products and epilogue, over the work
// units blockIdx.x, + gridDim.x, ... Every thread of the CTA calls it;
// `smem` is the 1024-aligned dynamic shared memory (S8Tile's layout).
// QX (#12): A's row tiles are quantized in this launch (`q`), there is no
// split, and the output is f32 where OUTF32.
template <int BM, int BN, bool QX, bool OUTF32>
__device__ __forceinline__ void s8_body(const CUtensorMap* tm_a,
                                        const CUtensorMap* tm_b,
                                        const CUtensorMap* tm_out,
                                        const S8Params& p, const QuantJob& q,
                                        uint8_t* smem) {
  using T = S8Tile<BM, BN>;
  constexpr int NWG = T::NWG;
  static_assert(QX || !OUTF32, "an f32 output is #12's");
  const int S = p.stages;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S * T::STAGE + NWG * T::OUT_BYTES);
  uint64_t* empty = full + S;
  const int n_work = ((p.M + BM - 1) / BM) * ((p.Nc + BN - 1) / BN) * p.split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  int m0, n0, z, k0, k1;
  if (wg == NWG) {
    // ---- producer: one thread ------------------------------------------
    if constexpr (NWG == 2) regs_dealloc<40>();
    if (threadIdx.x == NWG * 128) {
      tma_prefetch_desc(tm_a);
      tma_prefetch_desc(tm_b);
      int t = 0;
      uint64_t ready = 0;  // QX: row tiles < 64 known quantized
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        s8_unit(p, w, BM, BN, m0, n0, z, k0, k1);
        int kt = k0;
        if constexpr (QX) {
          const int mt = m0 / BM;
          if (mt >= 64 || !((ready >> mt) & 1)) {
            // the B slices of the ring's free stages go out first; A's rows
            // may still be being quantized
            int pre = 0;
            if (w == (int)blockIdx.x) {
              pre = min(S, k1 - k0);
              for (int i = 0; i < pre; ++i) {
                mbar_arrive_expect_tx(&full[i], T::STAGE);
                tma_load_4d(smem + i * T::STAGE + T::A_BYTES, tm_b, &full[i],
                            (k0 + i) * S8_BK, n0, 0, 0);
              }
            }
            wait_tile(q, mt);
            if (mt < 64) ready |= 1ull << mt;
            for (int i = 0; i < pre; ++i)
              tma_load_4d(smem + i * T::STAGE, tm_a, &full[i], (k0 + i) * S8_BK,
                          m0, 0, 0);
            kt += pre;
            t += pre;
          }
        }
        for (; kt < k1; ++kt, ++t) {
          const int s = t % S;
          mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
          uint8_t* st = smem + s * T::STAGE;
          mbar_arrive_expect_tx(&full[s], T::STAGE);
          tma_load_4d(st, tm_a, &full[s], kt * S8_BK, m0, 0, 0);
          tma_load_4d(st + T::A_BYTES, tm_b, &full[s], kt * S8_BK, n0, 0, 0);
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    if constexpr (NWG == 2) regs_alloc<232>();
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int rl = 64 * wg + 16 * (tw / 32) + lane / 4;  // row in the tile
    const int cl = 2 * (lane % 4);                       // column in an 8-block
    int acc[BN / 2];
    int t = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      s8_unit(p, w, BM, BN, m0, n0, z, k0, k1);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kt = k0; kt < k1; ++kt, ++t) {
        const int s = t % S;
        mbar_wait(&full[s], (t / S) & 1);
        const uint8_t* sa = smem + s * T::STAGE + wg * 64 * S8_BK;
        const uint8_t* sb = smem + s * T::STAGE + T::A_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S8_BK / 32; ++kk)
          wgmma_s8<BN>(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                       wgmma_desc(sb + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (kt > k0) mbar_arrive(&empty[(t - 1) % S]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(t - 1) % S]);

      // value i of the accumulator: row rl + 8 * ((i / 2) % 2), column
      // 8 * (i / 4) + cl + i % 2 of the tile
      if (!QX && (p.split > 1 || p.raw)) {
        // this split's int32 partial tile, from registers (the int32
        // mode's sums where it does not split)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + rl + 8 * r;
          if (row >= p.M) continue;
          int* wrow = p.ws + ((size_t)z * p.M + row) * p.Nc;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = n0 + 8 * j + cl;
            if (c < p.Nc)
              *reinterpret_cast<int2*>(wrow + c) =
                  make_int2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
          }
        }
      } else if (OUTF32) {
        // f32 pairs from registers: (float(acc) * srow) * scol, in order
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + rl + 8 * r;
          if (row >= p.M) continue;
          const float sr = __ldcg(p.srow + row);
          float* orow = static_cast<float*>(p.out) + (size_t)row * p.Nc;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = n0 + 8 * j + cl;  // Nc is even: c + 1 < Nc too
            if (c < p.Nc) {
              const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scol + c));
              *reinterpret_cast<float2*>(orow + c) = make_float2(
                  (float)acc[4 * j + 2 * r] * sr * sc.x,
                  (float)acc[4 * j + 2 * r + 1] * sr * sc.y);
            }
          }
        }
      } else {
        uint8_t* so = smem + S * T::STAGE + wg * T::OUT_BYTES;
        // this warpgroup's previous store has read the buffer
        if (tw == 0) bulk_wait_read<0>();
        named_sync(1 + wg, 128);
        float sr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + rl + 8 * r;
          sr[r] = row >= p.M ? 0.f : QX ? __ldcg(p.srow + row) : p.srow[row];
        }
        const bool scaled = p.scol != nullptr;
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += 8) {
          // a 64-column box: its column scales first, then its values
          float2 sc[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = n0 + 8 * (j0 + j) + cl;  // Nc is even: c + 1 < Nc too
            sc[j] = scaled && c < p.Nc
                ? __ldg(reinterpret_cast<const float2*>(p.scol + c))
                : make_float2(1.f, 1.f);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * (j0 + j) + 2 * r;
              const int rw = rl - 64 * wg + 8 * r;  // row in the warpgroup's 64
              *reinterpret_cast<uint32_t*>(
                  so + (j0 / 8) * 8192 + rw * 128 + ((j ^ (rw & 7)) << 4) +
                  (lane % 4) * 4) =
                  s8_scale_pair(acc[i], acc[i + 1], sr[r], scaled, sc[j]);
            }
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (tw == 0) {
#pragma unroll
          for (int ch = 0; ch < BN / 64; ++ch)
            tma_store_4d(tm_out, so + ch * 8192, n0 + 64 * ch, m0 + 64 * wg, 0,
                         0);
          bulk_commit();
        }
      }
    }
    if (tw == 0) bulk_wait<0>();  // the last store, before the CTA exits
  }
}

// The w8a8 GEMM of #2 and #7
template <int BM, int BN>
__global__ void __launch_bounds__(S8Tile<BM, BN>::THREADS, 1)
s8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_out, const S8Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  s8_body<BM, BN, false, false>(&tm_a, &tm_b, &tm_out, p, QuantJob{}, smem);
}

// the split's second pass: the int32 partials of each output pair added in
// split order, then the epilogue of an unsplit call
__global__ void __launch_bounds__(256)
s8_split_sum(const int* __restrict__ ws, const float* __restrict__ srow,
             const float* __restrict__ scol, __nv_bfloat16* __restrict__ out,
             int M, int Nc, int split) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int half = Nc / 2;
  if (pair >= (long long)M * half) return;
  const int row = (int)(pair / half);
  const int c = (int)(pair % half) * 2;
  const size_t at = (size_t)row * Nc + c, plane = (size_t)M * Nc;
  int a0 = 0, a1 = 0;
  for (int z = 0; z < split; ++z) {
    const int2 v = *reinterpret_cast<const int2*>(ws + z * plane + at);
    a0 += v.x;
    a1 += v.y;
  }
  const bool scaled = scol != nullptr;
  *reinterpret_cast<uint32_t*>(out + at) = s8_scale_pair(
      a0, a1, srow[row], scaled,
      scaled ? *reinterpret_cast<const float2*>(scol + c) : make_float2(1.f, 1.f));
}

// the int32 mode's second pass where it splits: each output pair's
// partials added in split order into plane 0 (every pair is one thread's,
// which reads its planes before it writes)
__global__ void __launch_bounds__(256)
s8_split_sum_i32(int* __restrict__ ws, int M, int Nc, int split) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int half = Nc / 2;
  if (pair >= (long long)M * half) return;
  const size_t at = (size_t)(pair / half) * Nc + (size_t)(pair % half) * 2;
  const size_t plane = (size_t)M * Nc;
  int a0 = 0, a1 = 0;
  for (int z = 0; z < split; ++z) {
    const int2 v = *reinterpret_cast<const int2*>(ws + z * plane + at);
    a0 += v.x;
    a1 += v.y;
  }
  *reinterpret_cast<int2*>(ws + at) = make_int2(a0, a1);
}

// ---- host ---------------------------------------------------------------

// The tensor map of an int8 operand (s8: boxes of 128 columns, bytes) or
// of the bf16 output (boxes of 64 columns) (rows, cols) row-major, in
// boxes of `box_rows` rows with the 128-byte swizzle, cached
// (hopper.cuh's cached_map_2d). TMA has no signed 8-bit type: UINT8
// copies the bytes as they are.
inline int cached_map(CUtensorMap* m, bool s8, const void* base, int rows,
                      int cols, int box_rows) {
  return s8 ? cached_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows,
                            cols, 128, box_rows, CU_TENSOR_MAP_SWIZZLE_128B)
            : cached_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows,
                            cols, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the persistent grid of a plan: a CTA an SM, at most one a work unit
inline int s8_grid(const S8Params& p, int bm, int bn) {
  const long long n_work = (long long)((p.M + bm - 1) / bm) *
                           ((p.Nc + bn - 1) / bn) * p.split;
  const int sms = sm_count();
  return (int)(n_work < sms ? n_work : sms);
}

template <int BM, int BN>
int s8_launch(const CUtensorMap& ta, const CUtensorMap& tb,
              const CUtensorMap& tout, const S8Params& p, cudaStream_t stream) {
  using T = S8Tile<BM, BN>;
  const int smem = T::smem(p.stages);
  auto kernel = s8_wgmma_kernel<BM, BN>;
  static int configured = 0;  // per instantiation
  if (int rc = set_smem_attr(kernel, smem, configured)) return rc;
  kernel<<<s8_grid(p, BM, BN), T::THREADS, smem, stream>>>(ta, tb, tout, p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || p.split == 1) return (int)rc;
  const long long pairs = (long long)p.M * (p.Nc / 2);
  if (p.raw) {
    s8_split_sum_i32<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
        p.ws, p.M, p.Nc, p.split);
    return (int)cudaGetLastError();
  }
  s8_split_sum<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      p.ws, p.srow, p.scol, static_cast<__nv_bfloat16*>(p.out), p.M, p.Nc,
      p.split);
  return (int)cudaGetLastError();
}

// The parameters of a plan (stages, split) for an (M, Nc) output over a
// contraction of Kc; false where the plan is not one the kernels take (a
// split must leave no split of the contraction empty)
inline bool s8_params(S8Params& p, const float* srow, const float* scol,
                      void* out, void* ws, int M, int Nc, int Kc, int stages,
                      int split, bool raw = false) {
  if (M <= 0 || Nc <= 0 || Kc <= 0 || Kc % 16 != 0 || Nc % 8 != 0 ||
      stages < 2 || stages > S8_MAX_STAGES || split < 1 ||
      (split > 1 || raw) != (ws != nullptr) || encoder() == nullptr)
    return false;
  p.raw = raw;
  p.srow = srow;
  p.scol = scol;
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.M = M;
  p.Nc = Nc;
  p.steps = (Kc + S8_BK - 1) / S8_BK;
  p.split = split;
  p.per = (p.steps + split - 1) / split;
  p.stages = stages;
  return (split - 1) * p.per < p.steps;
}

// out (M, Nc) = the product of a (M, Kc) and b (Nc, Kc), int8 row-major,
// with the epilogue above; ws an int32 (split, M, Nc) workspace when split
// > 1. The plan (block_m in {64, 128}, block_n in {128, 256}, stages in [2,
// 8], split) is ops/int8_matmul.py's s8_gemm_plan; a split must leave no
// split of the contraction empty. Nc is a multiple of 8 (the output's rows
// start 16-byte aligned, as TMA stores them). Returns a CUDA error code, or 1000 + the
// CUresult of a tensor map that cuTensorMapEncodeTiled refused.
//
// raw (the int32 mode): no epilogue; ws (split, M, Nc) int32 holds the
// exact sums in its plane 0, out is ignored (a sharded contraction's
// partial sums, which the caller adds over its ranks before it scales).
inline int s8_wgmma(const void* a, const void* b, const float* srow,
                    const float* scol, void* out, void* ws, int M, int Nc,
                    int Kc, int block_m, int block_n, int stages, int split,
                    cudaStream_t stream, bool raw = false) {
  S8Params p;
  if (raw) out = ws;  // the unused bf16 map over memory that holds it
  if (!s8_params(p, srow, scol, out, ws, M, Nc, Kc, stages, split, raw))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tout;
  int rc;
  if ((rc = cached_map(&ta, true, a, M, Kc, block_m)) ||
      (rc = cached_map(&tb, true, b, Nc, Kc, block_n)) ||
      (rc = cached_map(&tout, false, out, M, Nc, 64)))
    return rc;
  if (block_m == 64 && block_n == 128)
    return s8_launch<64, 128>(ta, tb, tout, p, stream);
  if (block_m == 64 && block_n == 256)
    return s8_launch<64, 256>(ta, tb, tout, p, stream);
  if (block_m == 128 && block_n == 128)
    return s8_launch<128, 128>(ta, tb, tout, p, stream);
  if (block_m == 128 && block_n == 256)
    return s8_launch<128, 256>(ta, tb, tout, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
