// Fused lm_head + sampling for Hopper: token ids = argmax over the vocab of
//   float(xq @ Wq) * sx[row] * s[col] * inv_T + pad_bias[col]
//   + blocked[row] * eos_bias[col] (+ Gumbel noise keyed on (seed, row, col)),
// with x quantized per row in the same launch, and without writing the (B,
// V) logits to device memory.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/fused_sample.py
// `_fused_sample_kernel` (wrapper `fused_lm_sample`): the token sampler of
// the paged decode step and of the chunked-prefill first token under
// `sampler: gumbel` (2B: D 1536, 7B: D 3584; V padded to Vp, a multiple of
// the pack's block; B <= 256 rows a launch).
//
// What bounds it on an H100: the int8 weight stream, Vp x D bytes read once
// (236 MB for the 2B pack: 70 us at 3.35 TB/s; 550 MB for the 7B's). The
// products (2 B D Vp int8 ops) are 18-61 us at 1,979 TOP/s. With noise the
// epilogue is the other bound: per logit about 70 instructions (the
// lowbias32 hash, two full-precision logf), 39 M logits at B 256.
// Design:
//  - The transposed product, logits^T = Wq xq^T: the vocabulary is wgmma's
//    M (64-row blocks of the pack's K-contiguous (Vp, D) storage), the
//    batch its N (B rounded up to 8, 16, 32, 64 or 128), so a batch of 8 or
//    64 pads nothing to 128 rows; above 128 rows, two batch tiles of 128.
//  - Persistent CTAs, one an SM: CTA c takes the blocks [c nb / G, (c + 1)
//    nb / G) (nb = Vp / 64), so every CTA streams the same bytes to within
//    one block.
//  - Two pipelines a CTA, one a consumer warpgroup, each with its own
//    producer thread and ring of weight slices (64 rows x 128 bytes of D,
//    TMA, 128-byte swizzle) on its own full/empty mbarriers. With one batch
//    tile the warpgroups take alternate blocks; with two, warpgroup w takes
//    batch tile w of every block (the block's second read comes from L2).
//    So one warpgroup's epilogue can run while the other's pipeline keeps
//    the weight streaming. (Against one ring shared by both warpgroups, on
//    H100s: within 1% at B 8, 0-4% faster at B 16 and 64, 6-11% faster at
//    B 256; PERF.md. With noise, the epilogue's own issue rate, ~4.6
//    scheduler cycles a logit, is what costs B 64 ~30 us and B 256 ~190
//    us over the same call without.)
//  - xq streams beside the weight: each stage carries the warpgroup's
//    batch tile's 128 bytes of D, read from L2 (xq, at most 256 x 3584
//    bytes, was written in this launch and stays there).
//  - x is quantized once, in this launch: the CTAs take 8-row tickets and
//    write xq and sx to a workspace (s8_quant.cuh). The producers issue
//    their first ring of weight slices before they wait for the rows
//    (acquire, then fence.proxy.async.global, then the TMA of xq).
//  - Epilogue, per unit (a block and a batch tile): each consumer thread
//    owns two vocabulary rows and N / 4 batch columns; scale, pad_bias and
//    eos_bias are loaded once a row a unit, sx and blocked once a CTA into
//    shared memory. Each logit gets the plain version's f32 operations in
//    its order, explicitly rounded (no FMA contraction; logf, not __logf),
//    so the ids equal the plain version's on the same keyed noise. The
//    thread keeps a running (value, column) per batch column in registers
//    across its units; it meets columns in increasing order, so a strict >
//    keeps the first.
//  - The argmax across warpgroups and CTAs, in the same launch and with
//    bits that do not depend on the order: each (value, column) becomes a
//    64-bit key, the value's order-preserving bits (-0.0 made +0.0 first)
//    over 0xFFFFFFFF - column, a lexicographic max: commutative and
//    associative, first occurrence on ties, as jnp.argmax and the TPU
//    kernel give. Lanes, then warps (shared memory), then CTAs (one 64-bit
//    atomicMax a row a CTA) meet on it. The last CTA to finish
//    (s8_quant.cuh's exit counter) turns the keys into int64 ids and sets
//    them, and the counters, back to 0 for the next launch or a CUDA-graph
//    replay (while no two launches in flight share the workspace;
//    s8_quant.cuh).
// The noise is a counter-based hash of (seed, row, global column), so the
// draw depends on neither the tiling nor the padding.
// Vocabulary-shard mode (a tensor-parallel lm_head, one shard a rank):
// col0, the global column of the pack's first column, enters the hash and
// the argmax key, and with keys_out the last CTA writes each row's key
// (top bit flipped: int64 order is the keys' order) where it would write
// the id; the MAX of the shards' keys over the model group is exactly the
// unsharded launch's id. col0 = 0 with ids out is the unsharded launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "s8_quant.cuh"

namespace {

constexpr int FS_ROWS = 64;                 // vocabulary rows a block (wgmma M)
constexpr int FS_BK = 128;                  // bytes of D a stage
constexpr int FS_WBOX = FS_ROWS * FS_BK;    // a block's weight slice
constexpr int FS_THREADS = 384;             // two consumer warpgroups + the producer's
constexpr int FS_MAX_STAGES = 8;            // a ring's

// N: the batch tile (wgmma width). A ring stage holds a weight slice and
// the warpgroup's batch tile's slice of D.
template <int N>
struct SampleTile {
  static constexpr int STAGE = FS_WBOX + N * FS_BK;
  // two rings, their barriers, the keys, sx and blocked of every batch
  // column (tiles of N), 16 bytes of flags, 1024 B of alignment
  static int smem(int tiles, int stages) {
    return 2 * stages * STAGE + 4 * stages * 8 + tiles * N * 16 + 16 + 1024;
  }
};

struct SampleParams {
  const float* scale;       // (Vp,)
  const float* pad_bias;    // (Vp,)
  const float* eos_bias;    // (Vp,)
  const float* blocked;     // (B,)
  const int* seed;          // (2,)
  unsigned long long* keys; // (B,) 0 at launch, left at 0
  long long* ids;           // (B,) out
  int B, row0;              // rows; the first row's index in the noise key
  int col0, keys_out;       // the shard's first global column; keys, not ids
  int blocks;               // Vp / 64
  int tiles;                // batch tiles of N: 1, or 2 (B > 128)
  int steps;                // D slices of FS_BK
  int stages, noise;        // stages: a ring's
  float inv_temp;
};

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

// the 64-bit argmax key of (value, column): larger value first, then the
// lower column; -0.0 and +0.0 the same value
__device__ __forceinline__ unsigned long long argmax_key(float v, int c) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (0xFFFFFFFFu - (uint32_t)c);
}

__device__ __forceinline__ unsigned long long shfl_xor_u64(unsigned long long v, int o) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, o);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), o);
  return ((unsigned long long)hi << 32) | lo;
}

// One unit's epilogue for one consumer thread: its two vocabulary rows c0,
// c0 + 8 (parameters pre-loaded) against its N / 4 batch columns.
template <int N, bool NOISE>
__device__ __forceinline__ void sample_epilogue(
    const int (&acc)[N / 2], float (&bv)[N / 4], int (&bc)[N / 4], int c0,
    const float (&sc)[2], const float (&pb)[2], const float (&eb)[2],
    const float* sxs, const float* blks, int bofs, int cl, int row0,
    int col0, float inv_temp, uint32_t s0, uint32_t s1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int b = bofs + 8 * j + cl;  // batch column of values e = 0, 1
    const float2 sxb = *reinterpret_cast<const float2*>(sxs + b);
    const float2 blb = *reinterpret_cast<const float2*>(blks + b);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + 8 * r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * r + e],
                                      e ? sxb.y : sxb.x), sc[r]);
        v = __fadd_rn(__fadd_rn(__fmul_rn(v, inv_temp), pb[r]),
                      __fmul_rn(e ? blb.y : blb.x, eb[r]));
        if constexpr (NOISE)
          v = __fadd_rn(v, gumbel(s0, s1, row0 + b + e, col0 + c));
        if (v > bv[2 * j + e]) {
          bv[2 * j + e] = v;
          bc[2 * j + e] = c;
        }
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(FS_THREADS, 1)
fused_sample_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x,
                    const SampleParams p, const QuantJob q, const int x_f32) {
  constexpr int STAGE = SampleTile<N>::STAGE;
  const int S = p.stages;
  const int cols = p.tiles * N;  // batch columns a launch
  extern __shared__ uint8_t smem_raw[];
  uint8_t* rings = reinterpret_cast<uint8_t*>(  // ring w: S stages
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + 2 * S * STAGE);
  uint64_t* empty = full + 2 * S;  // ring w: [w S, w S + S)
  unsigned long long* keys_s = reinterpret_cast<unsigned long long*>(empty + 2 * S);
  float* sxs = reinterpret_cast<float*>(keys_s + cols);
  float* blks = sxs + cols;
  int* flags = reinterpret_cast<int*>(blks + cols);  // [0] ticket, [3] exit

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < cols; i += FS_THREADS) keys_s[i] = 0ull;
  if (x_f32) quant_rows_once<true>(q, &flags[0]);
  else quant_rows_once<false>(q, &flags[0]);

  // this CTA's blocks; pipeline w's units: with one batch tile the blocks
  // lo + w, lo + w + 2, ...; with two, batch tile w of every block
  const int lo = (int)((long long)blockIdx.x * p.blocks / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * p.blocks / gridDim.x);
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producers: one thread a pipeline --------------------------------
    regs_dealloc<40>();
    const int w = (threadIdx.x - 256) / 32;
    if (threadIdx.x % 32 == 0 && w < 2) {
      const int step = p.tiles == 1 ? 2 : 1;
      const int first = lo + (p.tiles == 1 ? w : 0);
      const int units = first < hi ? (hi - first + step - 1) / step : 0;
      const int total = units * p.steps;  // stages this pipeline streams
      uint8_t* ring = rings + w * S * STAGE;
      uint64_t* f = full + w * S;
      tma_prefetch_desc(&tm_w);
      tma_prefetch_desc(&tm_x);
      // stage t: unit t / steps, D slice t % steps
      auto issue_w = [&](int t) {
        const int blk = first + step * (t / p.steps);
        mbar_arrive_expect_tx(&f[t % S], STAGE);
        tma_load_4d(ring + (t % S) * STAGE, &tm_w, &f[t % S],
                    (t % p.steps) * FS_BK, blk * FS_ROWS, 0, 0);
      };
      auto issue_x = [&](int t) {
        tma_load_4d(ring + (t % S) * STAGE + FS_WBOX, &tm_x, &f[t % S],
                    (t % p.steps) * FS_BK, p.tiles == 1 ? 0 : w * N, 0, 0);
      };
      // the first ring of weight slices, then the rows, then their xq
      const int pre = min(S, total);
      for (int t = 0; t < pre; ++t) issue_w(t);
      wait_tile(q, 0);
      for (int t = 0; t < pre; ++t) issue_x(t);
      for (int t = pre; t < total; ++t) {
        mbar_wait(&empty[w * S + t % S], ((t / S) & 1) ^ 1);
        issue_w(t);
        issue_x(t);
      }
    }
  } else {
    // ---- consumers: warpgroup wg, pipeline wg -----------------------------
    regs_alloc<232>();
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int rw = 16 * (tw / 32) + lane / 4;  // row in the block
    const int cl = 2 * (lane % 4);             // column in an 8-block
    const int bofs = p.tiles == 1 ? 0 : N * wg;  // the warpgroup's batch tile
    const int step = p.tiles == 1 ? 2 : 1;
    const int first = lo + (p.tiles == 1 ? wg : 0);
    const uint8_t* ring = rings + wg * S * STAGE;
    uint64_t* f = full + wg * S;
    uint64_t* e = empty + wg * S;
    // sx (written in this launch: read through L2) and blocked, once
    if (threadIdx.x == 0) {
      const int want = tile_rows(q, 0);
      while (ld_acquire_gpu(&q.cnt[2]) < want) __nanosleep(32);
    }
    named_sync(1, 256);
    for (int i = threadIdx.x; i < cols; i += 256) {
      sxs[i] = i < p.B ? __ldcg(q.sx + i) : 0.f;
      blks[i] = i < p.B ? __ldg(p.blocked + i) : 0.f;
    }
    named_sync(1, 256);
    const uint32_t s0 = (uint32_t)__ldg(p.seed), s1 = (uint32_t)__ldg(p.seed + 1);

    float bv[N / 4];
    int bc[N / 4];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      bv[i] = -INFINITY;
      bc[i] = 0x7fffffff;  // no column yet
    }
    int acc[N / 2];
    int t = 0;
    for (int blk = first; blk < hi; blk += step) {
      const int c0 = blk * FS_ROWS + rw;
      float sc[2], pb[2], eb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sc[r] = __ldg(p.scale + c0 + 8 * r);
        pb[r] = __ldg(p.pad_bias + c0 + 8 * r);
        eb[r] = __ldg(p.eos_bias + c0 + 8 * r);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0;
      for (int k = 0; k < p.steps; ++k, ++t) {
        const int s = t % S;
        mbar_wait(&f[s], (t / S) & 1);
        const uint8_t* sa = ring + s * STAGE;
        const uint8_t* sb = sa + FS_WBOX;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FS_BK / 32; ++kk)
          wgmma_s8<N>(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                      wgmma_desc(sb + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (k > 0) mbar_arrive(&e[(t - 1) % S]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&e[(t - 1) % S]);
      if (p.noise)
        sample_epilogue<N, true>(acc, bv, bc, c0, sc, pb, eb, sxs, blks, bofs,
                                 cl, p.row0, p.col0, p.inv_temp, s0, s1);
      else
        sample_epilogue<N, false>(acc, bv, bc, c0, sc, pb, eb, sxs, blks, bofs,
                                  cl, p.row0, p.col0, p.inv_temp, s0, s1);
    }

    // the CTA's best key a batch column: lanes of one lane % 4 share their
    // columns (shuffles), warps meet in shared memory
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int b = bofs + 8 * (i / 2) + cl + (i % 2);
      unsigned long long key =
          bc[i] != 0x7fffffff && b < p.B ? argmax_key(bv[i], p.col0 + bc[i])
                                         : 0ull;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const unsigned long long other = shfl_xor_u64(key, o);
        key = other > key ? other : key;
      }
      if (lane < 4 && key != 0ull) atomicMax(&keys_s[b], key);
    }
    named_sync(1, 256);
    for (int i = threadIdx.x; i < cols && i < p.B; i += 256)
      if (keys_s[i] != 0ull) atomicMax(&p.keys[i], keys_s[i]);
  }

  // the last CTA turns the keys into ids (or writes the keys) and leaves
  // them at 0
  if (quant_exit(q, &flags[3])) {
    for (int i = threadIdx.x; i < p.B; i += FS_THREADS) {
      const unsigned long long key = atomicExch(&p.keys[i], 0ull);
      p.ids[i] = p.keys_out
          ? (long long)(key ^ 0x8000000000000000ull)
          : (long long)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
    }
  }
}

template <int N>
int sample_launch(const CUtensorMap& tw, const CUtensorMap& tx,
                  const SampleParams& p, const QuantJob& q, int x_f32,
                  int ctas, cudaStream_t stream) {
  const int smem = SampleTile<N>::smem(p.tiles, p.stages);
  auto kernel = fused_sample_kernel<N>;
  static int configured = 0;  // per instantiation
  if (int rc = set_smem_attr(kernel, smem, configured)) return rc;
  kernel<<<ctas, FS_THREADS, smem, stream>>>(tw, tx, p, q, x_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D) bf16 (x_f32 = 0) or f32, unquantized; inv_input (D,) f32; wt
// (Vp, D) int8 row-major (the K-contiguous storage of the (D, Vp) lm_head);
// scale, pad_bias, eos_bias (Vp,) f32; blocked (B,) f32; seed (2,) int32 on
// the device; ids (B,) int64 out: token ids (global columns: col0 + the
// pack's column), or with keys_out the rows' argmax keys with the top bit
// flipped. The workspace, kept per device and stream
// (ops/fused_sample.py): xq (B, D) int8, sx (B,) f32, cnt 3 int32 counters
// and keys (B,) uint64, all at 0 (and left so). 1 <= B <= 256, D % 16 == 0,
// Vp % 128 == 0, col0 + Vp <= 2^20, row0 + B <= 4096 (the noise key's
// row and column). The
// plan (n in {8, 16, 32, 64, 128}, tiles in {1, 2}, stages a ring, ctas)
// is sample_plan's. Launches one kernel on `stream`; returns a
// CUDA error code (or 1000 + a refused tensor map's CUresult).
extern "C" int thinkdiff_fused_sample(
    const void* x, const void* inv_input, const void* wt, const void* scale,
    const void* pad_bias, const void* eos_bias, const void* blocked,
    const void* seed, void* xq, void* sx, void* cnt, void* keys, void* ids,
    int B, int D, int Vp, int row0, int col0, int keys_out, float inv_temp,
    int noise, int x_f32,
    int n, int tiles, int stages, int ctas, void* stream) {
  const int blocks = Vp / FS_ROWS;
  if (B <= 0 || B > 256 || D <= 0 || D % 16 != 0 || Vp <= 0 || Vp % 128 != 0 ||
      col0 < 0 || col0 + Vp > (1 << 20) || row0 < 0 || row0 + B > 4096 ||
      stages < 2 ||
      stages > FS_MAX_STAGES || ctas < 1 ||
      ctas > blocks || tiles < 1 || tiles > 2 ||
      B > tiles * n || (tiles == 2 && n != 128) ||
      encoder() == nullptr)
    return (int)cudaErrorInvalidValue;
  SampleParams p;
  p.scale = static_cast<const float*>(scale);
  p.pad_bias = static_cast<const float*>(pad_bias);
  p.eos_bias = static_cast<const float*>(eos_bias);
  p.blocked = static_cast<const float*>(blocked);
  p.seed = static_cast<const int*>(seed);
  p.keys = static_cast<unsigned long long*>(keys);
  p.ids = static_cast<long long*>(ids);
  p.B = B;
  p.row0 = row0;
  p.col0 = col0;
  p.keys_out = keys_out;
  p.blocks = blocks;
  p.tiles = tiles;
  p.steps = (D + FS_BK - 1) / FS_BK;
  p.stages = stages;
  p.noise = noise;
  p.inv_temp = inv_temp;
  QuantJob q;
  q.x = x;
  q.inv = static_cast<const float*>(inv_input);
  q.xq = static_cast<int8_t*>(xq);
  q.sx = static_cast<float*>(sx);
  q.cnt = static_cast<int*>(cnt);
  q.rows = B;
  q.K = D;
  q.tile = B;  // one tile: every unit needs every row
  CUtensorMap tw, tx;
  int rc;
  if ((rc = cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, Vp, D,
                          FS_BK, FS_ROWS, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (rc = cached_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, B, D,
                          FS_BK, n, CU_TENSOR_MAP_SWIZZLE_128B)))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return sample_launch<8>(tw, tx, p, q, x_f32, ctas, st);
    case 16: return sample_launch<16>(tw, tx, p, q, x_f32, ctas, st);
    case 32: return sample_launch<32>(tw, tx, p, q, x_f32, ctas, st);
    case 64: return sample_launch<64>(tw, tx, p, q, x_f32, ctas, st);
    case 128: return sample_launch<128>(tw, tx, p, q, x_f32, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}
