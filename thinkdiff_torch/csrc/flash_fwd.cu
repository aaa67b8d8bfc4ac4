// Flash-attention forward for Hopper: wgmma on tiles that TMA brings into a
// shared-memory ring, online softmax in f32 registers.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/flash_attention.py
// `_fwd_kernel` (wrapper `_flash_attention_forward`): the Qwen2-VL vision
// tower (D=80, 16 heads, 1024 patches per image), the language model's
// one-shot prefill (D=128, 12 query / 2 kv heads, causal + key padding),
// flan-t5's self- and cross-attention (D=64, 64 heads: relative bias,
// segments, kv_mask) in training, in its encoder and in the greedy decode,
// and BLIP-2's ViT-g (D=88, 16 heads, 257 tokens an image).
//
// What bounds it on an H100: the QK^T and PV products (4*T^2*D flop per
// head) on the bf16 tensor cores; the (T, T) scores never go to device
// memory, so the bytes are q, k, v, o and the bias/mask operands.
//
// Design (one CTA per (batch*head, BQ query rows), BQ = 64 * NWG):
//  - NWG consumer warpgroups of 64 query rows each, and one producer
//    warpgroup whose first warp issues every copy. With two or three
//    consumers the producer gives its registers to them (setmaxnreg 40 /
//    232, 24 / 160).
//  - TMA copies through tensor maps that carry the operands' own strides,
//    so q, k and v may be head-transposed views (the fused qkv of the
//    vision block, T5's (B, T, H, D) projections) and are never copied.
//    Rows are cut in 64-column chunks of 128 bytes with the 128-byte
//    swizzle; D = 80 and 88 take two chunks, the second zero-filled past
//    column D by the map's bounds (zeros add nothing to QK^T, whose last
//    k16 step at D = 88 spans columns 80-95, and the PV product is D
//    wide: wgmma's N = 88 is a multiple of 8). q is loaded once; k and v tiles of BK keys go through a
//    ring of 2-8 stages (as many as fit in shared memory) with full/empty
//    mbarriers, so the copies run ahead of the math.
//  - S = Q K^T: wgmma m64nBKk16 with both operands from shared memory.
//    Softmax: online, in the accumulator layout; scores are taken to the
//    log2 domain by one multiply (sm_scale * log2 e) and exp2.
//    O += P V: P rounded to bf16 in registers as wgmma's A operand, V from
//    shared memory as an MN-major B operand (the descriptor's transpose).
//  - Masks per tile: a bias with a query axis ((1, H, T, T) relative bias,
//    f32) arrives by TMA with the k/v tile, in the 128-byte swizzle; a bias
//    row ((B, 1, 1, Tk) padding bias), kv_mask and the key segment ids are
//    copied as BK-element rows by the producer warp's 32 lanes (TMA needs
//    a row's start 16-byte aligned, and b * Tk is often odd), so each
//    key's values are loaded once, not once per score. Tiles that need no mask
//    (below the causal diagonal, no kv_mask or segments, not the ragged
//    last tile) run no mask code.
//  - Semantics of mha_reference: masked scores are -1e30 (a row whose keys
//    are all masked gets the uniform softmax over them and an lse of
//    -1e30), keys past Tk are -inf, and a row that saw no key at all (l ==
//    0) writes 0. The kv head is h / (Hq / Hkv). o is written through its
//    strides; the natural-log logsumexp (f32), read by the backward
//    (flash_bwd.cu), is written on request.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  __nv_bfloat16* o;
  long long so0, so1, so2;  // o strides (elements) over batch, head, row
  float* lse;               // (B, Hq, Tq) or null
  const int* q_seg;         // (B, Tq) or null
  const int* kv_seg;        // (B, Tk) or null
  const int* kv_mask;       // (B, Tk) or null
  // BIAS_ROW: the bias row of batch b, head h starts at element b*bias_b +
  // h*bias_h of `bias`; BIAS_TILE: a 4-D tensor map (key, query, head,
  // batch) whose head / batch axes exist where bias_h / bias_b is nonzero
  const float* bias;
  long long bias_b, bias_h;
  int B, Hq, Hkv, Tq, Tk;
  int causal, bias_mode;
  int stages;        // k/v ring depth
  float scale_log2;  // sm_scale * log2(e)
};

// Shared memory, in bytes from a 1024-aligned base: q (NCH chunks of BQ
// rows of 128 B), S k tiles, S v tiles (NCH chunks of BK rows), S bias
// tiles or rows, S kv_mask and key-segment rows, the barriers (q full, q
// empty; full and empty per stage), for a ring of S stages.
template <int D, int BK, int NWG>
struct Plan {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NCH = (D + 63) / 64;
  static constexpr int Q_BYTES = NCH * BQ * 128;
  static constexpr int KV_BYTES = NCH * BK * 128;
  static constexpr int VEC_BYTES = BK * 4;
  int bias_bytes, off_k, off_v, off_bias, off_mask, off_seg, off_bar, total;
  __host__ __device__ Plan(int S, int bias_mode, bool mask, bool seg) {
    bias_bytes = bias_mode == BIAS_TILE ? (BK / 32) * BQ * 128
               : bias_mode == BIAS_ROW ? 1024 : 0;
    off_k = Q_BYTES;
    off_v = off_k + S * KV_BYTES;
    off_bias = off_v + S * KV_BYTES;
    off_mask = off_bias + S * bias_bytes;
    off_seg = off_mask + (mask ? S * VEC_BYTES : 0);
    off_bar = off_seg + (seg ? S * VEC_BYTES : 0);
    total = off_bar + (2 + 2 * S) * 8;
  }
};

// a bias tile with a query axis: BK / 32 boxes of 32 f32 columns x BQ rows,
// each row 128 B in the 128-byte swizzle; the pair (row, col), (row, col+1)
// for an even col
__device__ __forceinline__ float2 bias_pair(const uint8_t* tile, int bq, int row,
                                            int col) {
  const int w = col & 31;
  const int unit = (w >> 2) ^ (row & 7);
  return *reinterpret_cast<const float2*>(
      tile + ((col >> 5) * bq + row) * 128 + unit * 16 + (w & 3) * 4);
}

// score x (log2 domain) of query row `row` and key `col` (`cl` in the
// tile): the masked value -1e30 (natural) where a mask forbids the pair,
// -inf past the last key
__device__ __forceinline__ float mask_score(float x, int row, int col, int tk,
                                            bool causal, int qs,
                                            const int* smask, const int* sseg,
                                            int cl) {
  bool ok = true;
  if (smask) ok = smask[cl] > 0;
  if (sseg) ok = ok && qs == sseg[cl];
  if (causal) ok = ok && row >= col;
  x = ok ? x : NEG_BIG * LOG2E;
  return col >= tk ? -INFINITY : x;
}

template <int D, int BK, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_bias,
                 const Params p) {
  using P = Plan<D, BK, NWG>;
  constexpr int BQ = P::BQ, NCH = P::NCH;
  const int S = p.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const P plan(S, p.bias_mode, p.kv_mask != nullptr, p.kv_seg != nullptr);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* q_full = bar;
  uint64_t* q_empty = bar + 1;
  uint64_t* full = bar + 2;
  uint64_t* empty = bar + 2 + S;
  const int n_qt = (p.Tq + BQ - 1) / BQ;
  const int bh_count = p.B * p.Hq;
  const int n_work = n_qt * bh_count;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NWG * 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer ------------------------------------------------------
    if constexpr (NWG == 2) regs_dealloc<40>();
    if constexpr (NWG == 3) regs_dealloc<24>();
    if (threadIdx.x < NWG * 128 + 32) {
      // the producer warp: lane 0 announces and issues the TMA copies, all
      // 32 lanes copy the per-key rows, then every lane arrives on the
      // stage's full barrier. The ring's tile count t runs on across work
      // items, so the next item's first tiles load while the consumers
      // finish the current one.
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        tma_prefetch_desc(&tm_q);
        tma_prefetch_desc(&tm_k);
        tma_prefetch_desc(&tm_v);
      }
      const uint32_t tile_bytes =
          2 * P::KV_BYTES + (p.bias_mode == BIAS_TILE ? plan.bias_bytes : 0);
      int t = 0, item = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
        int qt, bh;
        work_item(w, bh_count, n_qt, p.causal, qt, bh);
        const int q0 = qt * BQ, b = bh / p.Hq, h = bh % p.Hq;
        const int hk = h / (p.Hq / p.Hkv);
        const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
        const int n_tiles = (kv_end + BK - 1) / BK;
        const float* bias_row = p.bias_mode == BIAS_ROW
            ? p.bias + b * p.bias_b + h * p.bias_h : nullptr;
        const int* mask_row = p.kv_mask ? p.kv_mask + (size_t)b * p.Tk : nullptr;
        const int* seg_row = p.kv_seg ? p.kv_seg + (size_t)b * p.Tk : nullptr;
        // q once the consumers are done with the previous item's (after
        // this item's first k/v tile is on its way)
        auto load_q = [&]() {
          mbar_wait(q_empty, (item & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(q_full, P::Q_BYTES);
            for (int c = 0; c < NCH; ++c)
              tma_load_4d(smem + c * BQ * 128, &tm_q, q_full, 64 * c, q0, h, b);
          }
        };
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % S;
          mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
          const int kv0 = j * BK;
          uint8_t* sb = smem + plan.off_bias + s * plan.bias_bytes;
          if (lane == 0) {
            mbar_expect_tx(&full[s], tile_bytes);
            uint8_t* sk = smem + plan.off_k + s * P::KV_BYTES;
            uint8_t* sv = smem + plan.off_v + s * P::KV_BYTES;
            for (int c = 0; c < NCH; ++c) {
              tma_load_4d(sk + c * BK * 128, &tm_k, &full[s], 64 * c, kv0, hk, b);
              tma_load_4d(sv + c * BK * 128, &tm_v, &full[s], 64 * c, kv0, hk, b);
            }
            if (p.bias_mode == BIAS_TILE)
              for (int c = 0; c < BK / 32; ++c)
                tma_load_4d(sb + c * BQ * 128, &tm_bias, &full[s], kv0 + 32 * c,
                            q0, p.bias_h ? h : 0, p.bias_b ? b : 0);
          }
          float* srow = reinterpret_cast<float*>(sb);
          int* smask = reinterpret_cast<int*>(smem + plan.off_mask + s * P::VEC_BYTES);
          int* sseg = reinterpret_cast<int*>(smem + plan.off_seg + s * P::VEC_BYTES);
          for (int e = lane; e < BK; e += 32) {
            const bool in = kv0 + e < p.Tk;  // past Tk the consumers use -inf
            if (bias_row) srow[e] = in ? bias_row[kv0 + e] : 0.f;
            if (mask_row) smask[e] = in ? mask_row[kv0 + e] : 0;
            if (seg_row) sseg[e] = in ? seg_row[kv0 + e] : 0;
          }
          mbar_arrive(&full[s]);
          if (j == 0) load_q();
        }
        if (n_tiles == 0) load_q();
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    if constexpr (NWG == 2) regs_alloc<232>();
    if constexpr (NWG == 3) regs_alloc<160>();
    const int tw = threadIdx.x % 128;
    const int lane = tw % 32;
    const int rl0 = 64 * wg + 16 * (tw / 32) + lane / 4;  // row in the CTA tile
    const int cq = 2 * (lane % 4);
    const float M2 = NEG_BIG * LOG2E;  // a masked score, log2 domain
    const uint8_t* sq = smem + wg * 64 * 128;
    int t = 0, item = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
      int qt, bh;
      work_item(w, bh_count, n_qt, p.causal, qt, bh);
      const int q0 = qt * BQ, b = bh / p.Hq, h = bh % p.Hq;
      const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
      const int n_tiles = (kv_end + BK - 1) / BK;
      const int rows[2] = {q0 + rl0, q0 + rl0 + 8};
      int qs[2] = {-1, -1};
      if (p.q_seg) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < p.Tq) qs[r] = p.q_seg[(size_t)b * p.Tq + rows[r]];
      }
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      mbar_wait(q_full, item & 1);

      for (int j = 0; j < n_tiles; ++j, ++t) {
        const int s = t % S;
        mbar_wait(&full[s], (t / S) & 1);
        const uint8_t* sk = smem + plan.off_k + s * P::KV_BYTES;
        const uint8_t* sv = smem + plan.off_v + s * P::KV_BYTES;

        // S = Q K^T over D in k16 steps (the last one zero-filled past D at
        // D = 88), 4 to a 64-column chunk
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < (D + 15) / 16; ++ks) {
          const int c = ks / 4, kin = ks % 4;
          wgmma_ss<BK>(sc, wgmma_desc(sq + c * BQ * 128 + kin * 32, 16, 1024),
                       wgmma_desc(sk + c * BK * 128 + kin * 32, 16, 1024), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // the last tile's Q K^T is done: the producer may load the next q
        if (j == n_tiles - 1) mbar_arrive(q_empty);

        // scale (to the log2 domain), bias, masks
        const int kv0 = j * BK;
        const bool tail = kv0 + BK > p.Tk;
        const bool diag = p.causal && kv0 + BK - 1 > q0 + 64 * wg;
        const uint8_t* sb = smem + plan.off_bias + s * plan.bias_bytes;
        const int* smask = p.kv_mask ? reinterpret_cast<const int*>(
            smem + plan.off_mask + s * P::VEC_BYTES) : nullptr;
        const int* sseg = p.kv_seg ? reinterpret_cast<const int*>(
            smem + plan.off_seg + s * P::VEC_BYTES) : nullptr;
        const bool masked = tail || diag || smask || sseg;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i >> 1) & 1;
          const int cl = 8 * (i / 4) + cq;  // key of element i in the tile
          float x0 = sc[i] * p.scale_log2, x1 = sc[i + 1] * p.scale_log2;
          if (p.bias_mode == BIAS_TILE) {
            const float2 bv = bias_pair(sb, BQ, rl0 + 8 * r, cl);
            x0 = fmaf(bv.x, LOG2E, x0);
            x1 = fmaf(bv.y, LOG2E, x1);
          } else if (p.bias_mode == BIAS_ROW) {
            const float2 bv = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(sb) + cl);
            x0 = fmaf(bv.x, LOG2E, x0);
            x1 = fmaf(bv.y, LOG2E, x1);
          }
          if (masked) {
            x0 = mask_score(x0, rows[r], kv0 + cl, p.Tk, p.causal, qs[r], smask,
                            sseg, cl);
            x1 = mask_score(x1, rows[r], kv0 + cl + 1, p.Tk, p.causal, qs[r],
                            smask, sseg, cl + 1);
          }
          sc[i] = x0;
          sc[i + 1] = x1;
          mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
        }

        // online softmax: the quad of a row holds its BK columns
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          const float mu = mn == -INFINITY ? 0.f : mn;
          alpha[r] = fast_exp2(m[r] - mu);  // 0 on the first tile
          m[r] = mn;
          l[r] *= alpha[r];
        }
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i >> 1) & 1;
          const float mu = m[r] == -INFINITY ? 0.f : m[r];
          const float p0 = fast_exp2(sc[i] - mu), p1 = fast_exp2(sc[i + 1] - mu);
          l[r] += p0 + p1;
          pa[i / 8][(i % 8) / 2] = pack_bf16x2(p0, p1);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V: 16 keys a step, V read MN-major (transposed)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(o, pa[kk], wgmma_desc(sv + kk * 16 * 128, BK * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[s]);
      }
      if (n_tiles == 0) mbar_arrive(q_empty);

      // epilogue: 1 / l, lse, bf16 o through its strides
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if (p.lse && lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < p.Tq)
            p.lse[(size_t)bh * p.Tq + rows[r]] =
                l[r] == 0.f ? NEG_BIG
                : (m[r] == M2 ? NEG_BIG : m[r] * LN2) + logf(l[r]);
      }
      __nv_bfloat16* ob = p.o + b * p.so0 + h * p.so1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= p.Tq) continue;
        const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
        __nv_bfloat16* orow = ob + rows[r] * p.so2 + cq;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb) = __floats2bfloat162_rn(
              o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- host ---------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, bias;
};

template <int D, int BK, int NWG>
int launch(const Maps& maps, const Params& p, cudaStream_t stream) {
  using P = Plan<D, BK, NWG>;
  const int smem = P(p.stages, p.bias_mode, p.kv_mask != nullptr,
                     p.kv_seg != nullptr).total + 1024;  // + the alignment
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<D, BK, NWG>;
  constexpr int threads = (NWG + 1) * 128;
  // per instantiation: the largest shared memory set so far, and the CTAs
  // an SM holds at the last size asked for
  static int configured = 0, last_smem = 0, per_sm = 1, sms = 0;
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
  if (last_smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    per_sm = per_sm > 0 ? per_sm : 1;
    last_smem = smem;
  }
  // persistent: at most as many CTAs as the card holds at once
  const long long n_work =
      (long long)((p.Tq + P::BQ - 1) / P::BQ) * p.B * p.Hq;
  const int grid = (int)(n_work < (long long)per_sm * sms ? n_work : per_sm * sms);
  kernel<<<grid, threads, smem, stream>>>(maps.q, maps.k, maps.v, maps.bias, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D) bf16 and o (B, Hq, Tq, D) bf16,
// each through its strides (elements, over batch, head and row; the head
// dim contiguous; strides multiples of 8 and bases 16-byte aligned, as TMA
// requires). bias f32 with its key axis contiguous, strides over batch,
// head and row (0 on a broadcast axis; with a query axis, nonzero strides
// multiples of 4 and a 16-byte aligned base), or null. kv_mask, q_seg,
// kv_seg: int32 (B, T) contiguous or null (the segment ids in pairs). lse:
// f32 (B, Hq, Tq) or null.
// shape: B, Hq, Hkv, Tq, Tk, D, block_q, block_k, causal, stages. strides:
// q, k, v, o, bias, three each. (D, block_k) in {(64, 128), (80, 64),
// (88, 64), (128, 64)}; block_q in {64, 128} (or 192 at D = 80 and 88);
// stages in [2, 8],
// within the 227 KB of shared memory a block may use.
// Launches on `stream`; returns a CUDA error code, or 1000 + the CUresult
// of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int thinkdiff_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* bias, const void* kv_mask, const void* q_seg,
    const void* kv_seg, const long long* shape, const long long* strides,
    float sm_scale, void* stream) {
  const int B = (int)shape[0], Hq = (int)shape[1], Hkv = (int)shape[2];
  const int Tq = (int)shape[3], Tk = (int)shape[4], D = (int)shape[5];
  const int block_q = (int)shape[6], block_k = (int)shape[7];
  const int stages = (int)shape[9];
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || Tk < 0 ||
      (q_seg == nullptr) != (kv_seg == nullptr) || encoder() == nullptr ||
      (block_q != 64 && block_q != 128 && block_q != 192) || stages < 2 ||
      stages > 8)
    return (int)cudaErrorInvalidValue;
  const long long *sq = strides, *sk = strides + 3, *sv = strides + 6;
  const long long *so = strides + 9, *sb = strides + 12;

  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.so0 = so[0]; p.so1 = so[1]; p.so2 = so[2];
  p.lse = static_cast<float*>(lse);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.bias = static_cast<const float*>(bias);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.causal = (int)shape[8];
  p.stages = stages;
  p.bias_mode = bias == nullptr ? BIAS_NONE : sb[2] == 0 ? BIAS_ROW : BIAS_TILE;
  p.bias_b = sb[0];
  p.bias_h = sb[1];
  p.scale_log2 = sm_scale * LOG2E;

  Maps maps;
  const int tk = Tk > 0 ? Tk : 1;  // a map needs a nonzero extent
  int rc;
  if ((rc = map_bf16_4d(&maps.q, q, B, Hq, Tq, D, sq, block_q)) ||
      (rc = map_bf16_4d(&maps.k, k, B, Hkv, tk, D, sk, block_k)) ||
      (rc = map_bf16_4d(&maps.v, v, B, Hkv, tk, D, sv, block_k)))
    return rc;
  maps.bias = maps.q;  // unused unless the bias has a query axis
  if (p.bias_mode == BIAS_TILE &&
      (rc = map_bias_4d(&maps.bias, bias, B, Hq, Tq, tk, sb, block_q)))
    return rc;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 192) {  // three consumer warpgroups: the vision towers
    if (D == 80 && block_k == 64) return launch<80, 64, 3>(maps, p, st);
    if (D == 88 && block_k == 64) return launch<88, 64, 3>(maps, p, st);
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = block_q == 128;
  if (D == 64 && block_k == 128)
    return wide ? launch<64, 128, 2>(maps, p, st) : launch<64, 128, 1>(maps, p, st);
  if (D == 80 && block_k == 64)
    return wide ? launch<80, 64, 2>(maps, p, st) : launch<80, 64, 1>(maps, p, st);
  if (D == 88 && block_k == 64)
    return wide ? launch<88, 64, 2>(maps, p, st) : launch<88, 64, 1>(maps, p, st);
  if (D == 128 && block_k == 64)
    return wide ? launch<128, 64, 2>(maps, p, st) : launch<128, 64, 1>(maps, p, st);
  return (int)cudaErrorInvalidValue;
}
