// FlashAttention-2 backward for Hopper: the dq kernel (which also computes
// the FA2 delta) and the dk/dv kernel, wgmma on tiles that TMA brings into a
// shared-memory ring.
//
// Replaces the Pallas TPU kernels thinkdiff_tpu/ops/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (wrapper `_flash_attention_backward`): the
// gradients of the flan-t5-xxl decoder's attentions in the aligner's
// training step (causal self-attention with the (1, H, T, T) relative bias
// and packed segments, cross-attention with kv_mask and segments; 64 heads
// of D=64, T = 256).
//
// What bounds them on an H100: the bf16 products. Per (query, key) pair the
// dq kernel recomputes S = scale*QK^T + bias and dP = dO V^T twice (one sweep
// for delta, one for dq) and adds dS K; the dk/dv kernel recomputes S and dP
// once and adds P^T dO and dS^T Q. The (T, T) scores, probabilities and
// their gradients never go to device memory; the bytes are q, k, v, dO, the
// bias and the (B, H, T) lse and delta rows. At the training shapes a
// kernel is a few microseconds of tensor-core work per CTA, so what sets
// the pace is latency: the copies, the waits on each product, the
// elementwise work between them.
//
// Design (the forward's, flash_fwd.cu): one CTA per work item, NWG consumer
// warpgroups of 64 rows each and one producer warpgroup whose first warp
// issues every copy (with two consumers, setmaxnreg gives the producer's
// registers to them). TMA copies through tensor maps that carry the
// operands' own strides, so q, k, v and dO may be head-transposed views of
// (B, T, H, D) memory, and dq, dk, dv are written through theirs: nothing is
// copied around the kernels. Tiles are 64-column chunks of 128-byte rows in
// the 128-byte swizzle; every product is wgmma m64 with bf16 operands and
// f32 accumulators:
//  - dq: a CTA holds 64 * NWG query rows; q and dO are loaded once, the k/v
//    tiles of 64 keys (with their bias box, kv_mask and key-segment rows)
//    come through a ring of S stages. Sweep 0 issues S = Q K^T and dP = dO
//    V^T back to back (both operands K-major), forms P while dP runs, and
//    accumulates delta = rowsum(P * dP) (the Pallas kernel's choice: the
//    attention output is not a residual); delta goes to device memory for
//    the next kernel. Sweep 1 recomputes S and dP and adds dQ += dS K, dS =
//    P * (dP - delta) rounded to bf16 in register A fragments, K read
//    MN-major (the descriptor's transpose), as V is in the forward's PV.
//    Where a work item's key tiles all fit in the ring (T = 256: K, V and
//    the f32 bias boxes of all four tiles), sweep 1 reads them where sweep
//    0 left them and nothing is loaded twice. dQ(j) runs while tile j+1's S
//    and dP are issued.
//  - dk/dv: a CTA holds 64 keys (one consumer warpgroup; at D = 64 two CTAs
//    share an SM); k and v are loaded once, the q tiles
//    of 64 rows (q, dO, their bias box, and the lse, delta and query-segment
//    rows) come through the ring. S^T = K Q^T and dP^T = V dO^T are issued
//    back to back; P^T is formed while dP^T runs and dV += P^T dO is issued
//    at once; then dS^T and dK += dS^T Q. The q and dO tiles are read
//    MN-major by those two, the same swizzled tiles the first two read
//    K-major. A stage is released when the products that read it are done,
//    one tile later, so the tensor cores always have the next tile's work.
//    Outputs are per query head; the wrapper sums a GQA group.
//  - Masks as in the forward: a bias with a query axis arrives by TMA in f32
//    boxes of 32 keys (the dk/dv kernel reads it transposed), a bias row
//    without one is read once a key; causal tiles that see no key are
//    skipped, and tiles that need no mask run no mask code. A masked pair
//    gets P = 0 explicitly: a row whose keys are all masked (a pad query row
//    of a packed cross-attention) then contributes exactly 0 to dk and dv
//    and gets dq = 0, as in the Pallas kernel, whatever its lse.
// P = exp(S - lse) from the forward's natural-log lse, taken as exp2 of
// log2-domain scores. P and dS are rounded to bf16 for the products; sums
// are f32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct BwdParams {
  __nv_bfloat16* out0;      // dq (dq kernel) or dk (dk/dv kernel)
  __nv_bfloat16* out1;      // dv (dk/dv kernel)
  long long so0[3], so1[3];  // their strides (elements) over batch, head, row
  const float* lse;         // (B, Hq, Tq), natural log
  float* delta;             // (B, Hq, Tq): written by dq, read by dk/dv
  const int* q_seg;         // (B, Tq) or null
  const int* kv_seg;        // (B, Tk) or null
  const int* kv_mask;       // (B, Tk) or null
  // BIAS_ROW: the bias row of batch b, head h starts at element b*bias_b +
  // h*bias_h of `bias`; BIAS_TILE: a tensor map, as in the forward
  const float* bias;
  long long bias_b, bias_h;
  int B, Hq, Hkv, Tq, Tk;
  int causal, bias_mode;
  int stages;        // ring depth
  float scale_log2;  // sm_scale * log2(e)
  float sm_scale;
};

// Shared memory of the dq kernel, in bytes from a 1024-aligned base: q and
// dO (NCH chunks of BQ rows of 128 B each), S k tiles, S v tiles, S bias
// boxes or rows, S key-info rows, the barriers (q full; full and empty per
// stage).
template <int D, int NWG>
struct DqPlan {
  static constexpr int BQ = 64 * NWG, BK = 64, NCH = D / 64;
  static constexpr int Q_BYTES = NCH * BQ * 128;
  static constexpr int KV_BYTES = NCH * BK * 128;
  static constexpr int VEC_BYTES = BK * 4;
  int bias_bytes, off_k, off_v, off_bias, off_info, off_bar, total;
  __host__ __device__ DqPlan(int S, int bias_mode) {
    bias_bytes = bias_mode == BIAS_TILE ? (BK / 32) * BQ * 128
               : bias_mode == BIAS_ROW ? VEC_BYTES : 0;
    off_k = 2 * Q_BYTES;
    off_v = off_k + S * KV_BYTES;
    off_bias = off_v + S * KV_BYTES;
    off_info = off_bias + S * bias_bytes;
    off_bar = off_info + S * VEC_BYTES;
    total = off_bar + (1 + 2 * S) * 8;
  }
};

// Shared memory of the dk/dv kernel: k and v (NCH chunks of BKV rows), S q
// tiles, S dO tiles, S bias boxes, S lse (log2 domain), delta and
// query-info rows, the barriers (k/v full; full and empty per stage).
template <int D>
struct DkvPlan {
  static constexpr int BKV = 64, BQ = 64, NCH = D / 64;
  static constexpr int KV_BYTES = NCH * BKV * 128;
  static constexpr int Q_BYTES = NCH * BQ * 128;
  static constexpr int VEC_BYTES = BQ * 4;
  int bias_bytes, off_q, off_do, off_bias, off_lse, off_delta, off_info,
      off_bar, total;
  __host__ __device__ DkvPlan(int S, int bias_mode) {
    bias_bytes = bias_mode == BIAS_TILE ? (BKV / 32) * BQ * 128 : 0;
    off_q = 2 * KV_BYTES;
    off_do = off_q + S * Q_BYTES;
    off_bias = off_do + S * Q_BYTES;
    off_lse = off_bias + S * bias_bytes;
    off_delta = off_lse + S * VEC_BYTES;
    off_info = off_delta + S * VEC_BYTES;
    off_bar = off_info + S * VEC_BYTES;
    total = off_bar + (1 + 2 * S) * 8;
  }
};

// The masks of a pair as one comparison: a key's info is its segment id (0
// without segments) where it is a valid key (below Tk, kv_mask set), else
// NO_KEY; a query row's is its segment id (0 without segments) where it is
// below Tq, else NO_ROW. A pair may attend where the two are equal (and,
// causal, the row is not before the key). Segment ids are never these two.
constexpr int NO_KEY = -2147483647 - 1;
constexpr int NO_ROW = -2147483647;

// compile-time values, to pick an instantiation of the elementwise code
// from the bias mode and whether a tile needs masks
template <int V>
struct Val {
  static constexpr int value = V;
};

template <typename F>
__device__ __forceinline__ void with_modes(int bias_mode, bool masked, F&& f) {
  if (masked) {
    if (bias_mode == BIAS_TILE) f(Val<BIAS_TILE>(), Val<1>());
    else if (bias_mode == BIAS_ROW) f(Val<BIAS_ROW>(), Val<1>());
    else f(Val<BIAS_NONE>(), Val<1>());
  } else {
    if (bias_mode == BIAS_TILE) f(Val<BIAS_TILE>(), Val<0>());
    else if (bias_mode == BIAS_ROW) f(Val<BIAS_ROW>(), Val<0>());
    else f(Val<BIAS_NONE>(), Val<0>());
  }
}

// CTAs an SM holds: two of the one-consumer D = 64 kernels (the consumer
// warpgroup 224 registers a thread, the producer 32: half the register
// file), so one CTA's loads and stores overlap the other's products; one
// otherwise
template <int D, int NWG>
__host__ __device__ constexpr int ctas_per_sm() {
  return D == 64 && NWG == 1 ? 2 : 1;
}

// the producer warpgroup gives its registers to the consumers (all four
// warps of a warpgroup execute these together)
template <int D, int NWG>
__device__ __forceinline__ void producer_regs() {
  if constexpr (NWG == 2) regs_dealloc<40>();
  if constexpr (ctas_per_sm<D, NWG>() == 2) regs_dealloc<32>();
}

template <int D, int NWG>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG == 2) regs_alloc<232>();
  if constexpr (ctas_per_sm<D, NWG>() == 2) regs_alloc<224>();
}

// the dynamic shared memory from its first 1024-aligned byte, by pointer
// arithmetic on the shared array (so that loads through it stay shared-space
// loads)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// acc[i] of an m64nN accumulator: (row, column) of the thread's value i is
// (16 * warp + lane / 4 + 8 * r, 8 * (i / 4) + 2 * (lane % 4) + i % 2) with
// r = (i / 2) % 2; values i, i + 1 share a row. Values 8 kk .. 8 kk + 7 are
// the A fragment of k16 step kk of a product that takes this tile as A.

// bf16 rows through strides, 2 per thread row r (the accumulator's layout)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const long long* so, int b, int h,
                                           const int (&rows)[2], int limit,
                                           int col, const float (&acc)[D / 2],
                                           float scale) {
  __nv_bfloat16* ob = base + b * so[0] + h * so[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= limit) continue;
    __nv_bfloat16* orow = ob + rows[r] * so[2] + col;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb) = __floats2bfloat162_rn(
          acc[4 * jb + 2 * r] * scale, acc[4 * jb + 2 * r + 1] * scale);
  }
}

// P of a dq tile in place of S, for the thread's rows r = 0, 1 (rows[r],
// lse2[r] = lse log2 e, qinfo[r]) against the tile's keys key0 + 8 jb + e
// (key0 = kv0 + cq). BIAS_TILE: `bias` is row rl0 of the tile's boxes (row
// r is 8 r rows on) and units[m] the byte offset of key block 2m + e in a
// row of this swizzle; BIAS_ROW: `bias` is the bias row + cq. `info`: the
// tile's key info + cq.
template <int BIAS, bool MASK, int BQ, int BK>
__device__ __forceinline__ void dq_probs(float (&sc)[BK / 2], float scale_log2,
                                         const float (&lse2)[2],
                                         const uint8_t* bias, const int (&units)[4],
                                         const int* info, const int (&qinfo)[2],
                                         const int (&rows)[2], int key0,
                                         bool causal) {
  int2 ki[BK / 8];
  if constexpr (MASK) {
#pragma unroll
    for (int jb = 0; jb < BK / 8; ++jb)
      ki[jb] = *reinterpret_cast<const int2*>(info + 8 * jb);
  }
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i >> 1) & 1, jb = i / 4;
    float x0 = fmaf(sc[i], scale_log2, -lse2[r]);
    float x1 = fmaf(sc[i + 1], scale_log2, -lse2[r]);
    if constexpr (BIAS == BIAS_TILE) {
      const float2 bv = *reinterpret_cast<const float2*>(
          bias + (8 * r + (jb >> 2) * BQ) * 128 + units[jb & 3]);
      x0 = fmaf(bv.x, LOG2E, x0);
      x1 = fmaf(bv.y, LOG2E, x1);
    } else if constexpr (BIAS == BIAS_ROW) {
      const float2 bv = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(bias) + 8 * jb);
      x0 = fmaf(bv.x, LOG2E, x0);
      x1 = fmaf(bv.y, LOG2E, x1);
    }
    float p0 = fast_exp2(x0), p1 = fast_exp2(x1);
    if constexpr (MASK) {
      const int key = key0 + 8 * jb;
      p0 = ki[jb].x == qinfo[r] && (!causal || rows[r] >= key) ? p0 : 0.f;
      p1 = ki[jb].y == qinfo[r] && (!causal || rows[r] > key) ? p1 : 0.f;
    }
    sc[i] = p0;
    sc[i + 1] = p1;
  }
}

// P^T of a dk/dv tile in place of S^T, and as bf16 A fragments, for the
// thread's keys r = 0, 1 (keys[r], kinfo[r], brow[r] = bias log2 e)
// against the tile's rows row0 + 8 jq + e (row0 = q0 + cq). `lse` (log2
// domain) and `info`: the tile's rows + cq. BIAS_TILE: offs[r][e] is the
// byte offset of (row cq + e, key r) in the tile's boxes at `bias`; row
// block jq is 1024 B on.
template <int BIAS, bool MASK, int BQ>
__device__ __forceinline__ void dkv_probs(float (&sc)[BQ / 2],
                                          uint32_t (&pa)[BQ / 16][4],
                                          float scale_log2, const float* lse,
                                          const uint8_t* bias,
                                          const int (&offs)[2][2],
                                          const float (&brow)[2], const int* info,
                                          const int (&kinfo)[2],
                                          const int (&keys)[2], int row0,
                                          bool causal) {
  float2 l2[BQ / 8];
  int2 qi[BQ / 8];
#pragma unroll
  for (int jq = 0; jq < BQ / 8; ++jq) {
    l2[jq] = *reinterpret_cast<const float2*>(lse + 8 * jq);
    if constexpr (MASK) qi[jq] = *reinterpret_cast<const int2*>(info + 8 * jq);
  }
#pragma unroll
  for (int i = 0; i < BQ / 2; i += 2) {
    const int r = (i >> 1) & 1, jq = i / 4;
    float x0 = fmaf(sc[i], scale_log2, -l2[jq].x);
    float x1 = fmaf(sc[i + 1], scale_log2, -l2[jq].y);
    if constexpr (BIAS == BIAS_TILE) {
      x0 = fmaf(*reinterpret_cast<const float*>(bias + offs[r][0] + 1024 * jq),
                LOG2E, x0);
      x1 = fmaf(*reinterpret_cast<const float*>(bias + offs[r][1] + 1024 * jq),
                LOG2E, x1);
    } else if constexpr (BIAS == BIAS_ROW) {
      x0 += brow[r];
      x1 += brow[r];
    }
    float p0 = fast_exp2(x0), p1 = fast_exp2(x1);
    if constexpr (MASK) {
      const int row = row0 + 8 * jq;
      p0 = qi[jq].x == kinfo[r] && (!causal || row >= keys[r]) ? p0 : 0.f;
      p1 = qi[jq].y == kinfo[r] && (!causal || row + 1 >= keys[r]) ? p1 : 0.f;
    }
    sc[i] = p0;
    sc[i + 1] = p1;
    pa[i / 8][(i % 8) / 2] = pack_bf16x2(p0, p1);
  }
}

// ---- dq ----------------------------------------------------------------------

template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, (ctas_per_sm<D, NWG>()))
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_bias,
                    const BwdParams p) {
  using P = DqPlan<D, NWG>;
  constexpr int BQ = P::BQ, BK = P::BK, NCH = P::NCH;
  const int S = p.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const P plan(S, p.bias_mode);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* q_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + S;

  int qt, bh;
  work_item(blockIdx.x, p.B * p.Hq, (p.Tq + BQ - 1) / BQ, p.causal, qt, bh);
  const int q0 = qt * BQ, b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  const int n = (kv_end + BK - 1) / BK;  // key tiles of this item
  // every key tile fits in the ring: sweep 1 reads them where sweep 0 left
  // them, and no stage is reused
  const bool resident = n <= S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: lane 0 issues the TMA copies, all 32 lanes copy the
    // per-key rows, then every lane arrives on the stage's full barrier
    producer_regs<D, NWG>();
    if (threadIdx.x >= NWG * 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * P::Q_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load_4d(smem + c * BQ * 128, &tm_q, q_full, 64 * c, q0, h, b);
        tma_load_4d(smem + P::Q_BYTES + c * BQ * 128, &tm_do, q_full, 64 * c, q0,
                    h, b);
      }
    }
    const uint32_t tile_bytes =
        2 * P::KV_BYTES + (p.bias_mode == BIAS_TILE ? plan.bias_bytes : 0);
    const float* bias_row = p.bias_mode == BIAS_ROW
        ? p.bias + b * p.bias_b + h * p.bias_h : nullptr;
    const int* mask_row = p.kv_mask ? p.kv_mask + (size_t)b * p.Tk : nullptr;
    const int* seg_row = p.kv_seg ? p.kv_seg + (size_t)b * p.Tk : nullptr;
    for (int t = 0; t < (resident ? n : 2 * n); ++t) {
      const int s = t % S;
      const int kv0 = (t % n) * BK;
      mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
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
            tma_load_4d(sb + c * BQ * 128, &tm_bias, &full[s], kv0 + 32 * c, q0,
                        p.bias_h ? h : 0, p.bias_b ? b : 0);
      }
      float* srow = reinterpret_cast<float*>(sb);
      int* sinfo = reinterpret_cast<int*>(smem + plan.off_info + s * P::VEC_BYTES);
      for (int e = lane; e < BK; e += 32) {
        const int key = kv0 + e;
        const bool in = key < p.Tk;
        if (bias_row) srow[e] = in ? bias_row[key] : 0.f;
        sinfo[e] = in && (!mask_row || mask_row[key] > 0)
            ? (seg_row ? seg_row[key] : 0) : NO_KEY;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  consumer_regs<D, NWG>();
  const int tw = threadIdx.x % 128;
  const int lane = tw % 32;
  const int rl0 = 64 * wg + 16 * (tw / 32) + lane / 4;  // row in the CTA tile
  const int cq = 2 * (lane % 4);
  const int rows[2] = {q0 + rl0, q0 + rl0 + 8};
  const int wg_last = q0 + 64 * wg + 63;  // the warpgroup's last query row
  float lse2[2];
  int qinfo[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // rows past Tq: zero q and dO, nothing written; their values only need
    // to stay finite
    const bool in = rows[r] < p.Tq;
    lse2[r] = in ? p.lse[(size_t)bh * p.Tq + rows[r]] * LOG2E : 0.f;
    if (p.q_seg && in) qinfo[r] = p.q_seg[(size_t)b * p.Tq + rows[r]];
  }
  // the bias boxes' swizzle: key block 2m + e of row rl0 (or rl0 + 8)
  int units[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    units[m] = ((2 * m) ^ (cq >> 2) ^ (rl0 & 7)) * 16 + (cq & 3) * 4;
  const uint8_t* sq = smem + wg * 64 * 128;
  const uint8_t* sdo = smem + P::Q_BYTES + wg * 64 * 128;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float delta[2] = {0.f, 0.f};
  int held = -1;  // the stage that dQ(j - 1), still running, reads
  auto release = [&](int s) {
    if (!resident) mbar_arrive(&empty[s]);
  };
  mbar_wait(q_full, 0);

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int j = 0; j < n; ++j) {
      const int t = sweep == 1 && !resident ? n + j : j;
      const int s = t % S;
      if (sweep == 0 || !resident) mbar_wait(&full[s], (t / S) & 1);
      const int kv0 = j * BK;
      if (p.causal && kv0 > wg_last) {  // no key of the tile for these rows
        wgmma_wait<0>();
        if (held >= 0) release(held);
        held = -1;
        release(s);
        continue;
      }
      const uint8_t* sk = smem + plan.off_k + s * P::KV_BYTES;
      const uint8_t* sv = smem + plan.off_v + s * P::KV_BYTES;

      // S = Q K^T and dP = dO V^T, two groups issued back to back
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks / 4, kin = ks % 4;
        wgmma_ss<BK>(sc, wgmma_desc(sq + c * BQ * 128 + kin * 32, 16, 1024),
                     wgmma_desc(sk + c * BK * 128 + kin * 32, 16, 1024), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks / 4, kin = ks % 4;
        wgmma_ss<BK>(dp, wgmma_desc(sdo + c * BQ * 128 + kin * 32, 16, 1024),
                     wgmma_desc(sv + c * BK * 128 + kin * 32, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S, and dQ(j - 1) before it, are done
      fence_regs(sc);
      if (held >= 0) release(held);
      held = -1;

      // P = 2^(S * scale log2 e + bias log2 e - lse log2 e), 0 where masked
      const bool masked = kv0 + BK > p.Tk || p.kv_mask || p.kv_seg ||
                          (p.causal && kv0 + BK - 1 > q0 + 64 * wg);
      const uint8_t* sb = smem + plan.off_bias + s * plan.bias_bytes;
      const uint8_t* bias = p.bias_mode == BIAS_TILE ? sb + rl0 * 128 : sb + 4 * cq;
      const int* info = reinterpret_cast<const int*>(
          smem + plan.off_info + s * P::VEC_BYTES) + cq;
      with_modes(p.bias_mode, masked, [&](auto bias_mode, auto mask) {
        dq_probs<decltype(bias_mode)::value, (decltype(mask)::value != 0), BQ, BK>(
            sc, p.scale_log2, lse2, bias, units, info, qinfo, rows, kv0 + cq,
            p.causal);
      });
      wgmma_wait<0>();
      fence_regs(dp);

      if (sweep == 0) {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i >> 1) & 1;
          delta[r] = fmaf(sc[i], dp[i], fmaf(sc[i + 1], dp[i + 1], delta[r]));
        }
        release(s);
      } else {
        // dQ += dS K: dS = P (dP - delta) in bf16 A fragments, K MN-major
        uint32_t dsa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i >> 1) & 1;
          dsa[i / 8][(i % 8) / 2] = pack_bf16x2(sc[i] * (dp[i] - delta[r]),
                                                sc[i + 1] * (dp[i + 1] - delta[r]));
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(acc, dsa[kk], wgmma_desc(sk + kk * 16 * 128, BK * 128, 1024), 1);
        wgmma_commit();
        held = s;
      }
    }
    if (sweep == 0) {
      // the quad of a row holds its columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
        if (lane % 4 == 0 && rows[r] < p.Tq)
          p.delta[(size_t)bh * p.Tq + rows[r]] = delta[r];
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_rows<D>(p.out0, p.so0, b, h, rows, p.Tq, cq, acc, p.sm_scale);
}

// ---- dk / dv -------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256, (ctas_per_sm<D, 1>()))
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_bias,
                     const BwdParams p) {
  using P = DkvPlan<D>;
  constexpr int BKV = P::BKV, BQ = P::BQ, NCH = P::NCH;
  const int S = p.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const P plan(S, p.bias_mode);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + S;

  int kt, bh;
  work_item(blockIdx.x, p.B * p.Hq, (p.Tk + BKV - 1) / BKV, false, kt, bh);
  const int k0 = kt * BKV, b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: rows before the tile's first key see none of its keys
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  const int n = q_start < p.Tq ? (p.Tq - q_start + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer
    producer_regs<D, 1>();
    if (threadIdx.x >= 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * P::KV_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load_4d(smem + c * BKV * 128, &tm_k, kv_full, 64 * c, k0, hk, b);
        tma_load_4d(smem + P::KV_BYTES + c * BKV * 128, &tm_v, kv_full, 64 * c,
                    k0, hk, b);
      }
    }
    const uint32_t tile_bytes = 2 * P::Q_BYTES + plan.bias_bytes;
    for (int t = 0; t < n; ++t) {
      const int s = t % S;
      const int q0 = q_start + t * BQ;
      mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], tile_bytes);
        uint8_t* sq = smem + plan.off_q + s * P::Q_BYTES;
        uint8_t* sdo = smem + plan.off_do + s * P::Q_BYTES;
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(sq + c * BQ * 128, &tm_q, &full[s], 64 * c, q0, h, b);
          tma_load_4d(sdo + c * BQ * 128, &tm_do, &full[s], 64 * c, q0, h, b);
        }
        uint8_t* sb = smem + plan.off_bias + s * plan.bias_bytes;
        if (p.bias_mode == BIAS_TILE)
          for (int c = 0; c < BKV / 32; ++c)
            tma_load_4d(sb + c * BQ * 128, &tm_bias, &full[s], k0 + 32 * c, q0,
                        p.bias_h ? h : 0, p.bias_b ? b : 0);
      }
      float* slse = reinterpret_cast<float*>(smem + plan.off_lse + s * P::VEC_BYTES);
      float* sdl = reinterpret_cast<float*>(smem + plan.off_delta + s * P::VEC_BYTES);
      int* sinfo = reinterpret_cast<int*>(smem + plan.off_info + s * P::VEC_BYTES);
      for (int e = lane; e < BQ; e += 32) {
        const int row = q0 + e;
        const bool in = row < p.Tq;
        slse[e] = in ? p.lse[(size_t)bh * p.Tq + row] * LOG2E : 0.f;
        sdl[e] = in ? p.delta[(size_t)bh * p.Tq + row] : 0.f;
        sinfo[e] = in ? (p.q_seg ? p.q_seg[(size_t)b * p.Tq + row] : 0) : NO_ROW;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: S^T (keys x queries) in the accumulators, so P^T and
  // dS^T are A fragments of dV += P^T dO and dK += dS^T Q as they stand
  consumer_regs<D, 1>();
  const int lane = threadIdx.x % 32;
  const int kl0 = 16 * (threadIdx.x / 32) + lane / 4;  // key in the CTA tile
  const int cq = 2 * (lane % 4);
  const int keys[2] = {k0 + kl0, k0 + kl0 + 8};
  int kinfo[2];
  float brow[2] = {0.f, 0.f};  // BIAS_ROW, log2 domain
  int offs[2][2];              // BIAS_TILE: (row cq + e, key r) in the boxes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = keys[r];
    const bool in = key < p.Tk;
    kinfo[r] = in && (!p.kv_mask || p.kv_mask[(size_t)b * p.Tk + key] > 0)
        ? (p.kv_seg ? p.kv_seg[(size_t)b * p.Tk + key] : 0) : NO_KEY;
    if (p.bias_mode == BIAS_ROW && in)
      brow[r] = p.bias[b * p.bias_b + h * p.bias_h + key] * LOG2E;
    const int kl = kl0 + 8 * r;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      offs[r][e] = ((kl >> 5) * BQ + cq + e) * 128 +
                   ((((kl & 31) >> 2) ^ (cq + e)) * 16) + (kl & 3) * 4;
  }
  const bool key_masks = k0 + BKV > p.Tk || p.kv_mask || p.kv_seg;
  const uint8_t* sk = smem;
  const uint8_t* sv = smem + P::KV_BYTES;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  int held = -1;  // the stage that dV(j - 1) and dK(j - 1), still running, read
  mbar_wait(kv_full, 0);

  for (int t = 0; t < n; ++t) {
    const int s = t % S;
    const int q0 = q_start + t * BQ;
    mbar_wait(&full[s], (t / S) & 1);
    const uint8_t* sq = smem + plan.off_q + s * P::Q_BYTES;
    const uint8_t* sdo = smem + plan.off_do + s * P::Q_BYTES;

    // S^T = K Q^T and dP^T = V dO^T, two groups issued back to back
    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / 4, kin = ks % 4;
      wgmma_ss<BQ>(sc, wgmma_desc(sk + c * BKV * 128 + kin * 32, 16, 1024),
                   wgmma_desc(sq + c * BQ * 128 + kin * 32, 16, 1024), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / 4, kin = ks % 4;
      wgmma_ss<BQ>(dp, wgmma_desc(sv + c * BKV * 128 + kin * 32, 16, 1024),
                   wgmma_desc(sdo + c * BQ * 128 + kin * 32, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T, and dV(j - 1), dK(j - 1) before it, are done
    fence_regs(sc);
    if (held >= 0) mbar_arrive(&empty[held]);
    held = -1;

    // P^T, 0 where masked
    const bool masked = key_masks || q0 + BQ > p.Tq ||
                        (p.causal && q0 < k0 + BKV - 1);
    const uint8_t* sb = smem + plan.off_bias + s * plan.bias_bytes;
    const float* slse = reinterpret_cast<const float*>(
        smem + plan.off_lse + s * P::VEC_BYTES) + cq;
    const float* sdl = reinterpret_cast<const float*>(
        smem + plan.off_delta + s * P::VEC_BYTES) + cq;
    const int* info = reinterpret_cast<const int*>(
        smem + plan.off_info + s * P::VEC_BYTES) + cq;
    uint32_t pa[BQ / 16][4];
    with_modes(p.bias_mode, masked, [&](auto bias_mode, auto mask) {
      dkv_probs<decltype(bias_mode)::value, (decltype(mask)::value != 0), BQ>(
          sc, pa, p.scale_log2, slse, sb, offs, brow, info, kinfo, keys,
          q0 + cq, p.causal);
    });
    // dV += P^T dO, dO read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], wgmma_desc(sdo + kk * 16 * 128, BQ * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done (dV may still run)
    fence_regs(dp);

    // dK += dS^T Q, dS^T = P^T (dP^T - delta), Q read MN-major
    uint32_t dsa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const float2 dl = *reinterpret_cast<const float2*>(sdl + 8 * (i / 4));
      dsa[i / 8][(i % 8) / 2] = pack_bf16x2(sc[i] * (dp[i] - dl.x),
                                            sc[i + 1] * (dp[i + 1] - dl.y));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dk, dsa[kk], wgmma_desc(sq + kk * 16 * 128, BQ * 128, 1024), 1);
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  store_rows<D>(p.out0, p.so0, b, h, keys, p.Tk, cq, dk, p.sm_scale);
  store_rows<D>(p.out1, p.so1, b, h, keys, p.Tk, cq, dv, 1.f);
}

// ---- host ------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout, bias;
};

// the largest shared memory set so far for `kernel`, raised when a call
// needs more
template <typename K>
int configure(K kernel, int smem, int& configured) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (configured < smem) {
    // as much of the SM's memory as shared memory as the hardware gives, so
    // that two CTAs fit where their plans do
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                100);
    if (rc != cudaSuccess) return (int)rc;
    configured = smem;
  }
  return 0;
}

template <int D, int NWG>
int launch_dq(const Maps& m, const BwdParams& p, cudaStream_t stream) {
  using P = DqPlan<D, NWG>;
  const int smem = P(p.stages, p.bias_mode).total + 1024;  // + the alignment
  auto kernel = flash_bwd_dq_kernel<D, NWG>;
  static int configured = 0;
  if (int rc = configure(kernel, smem, configured)) return rc;
  const int grid = (p.Tq + P::BQ - 1) / P::BQ * p.B * p.Hq;
  kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(m.q, m.k, m.v, m.dout, m.bias, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Maps& m, const BwdParams& p, cudaStream_t stream) {
  using P = DkvPlan<D>;
  const int smem = P(p.stages, p.bias_mode).total + 1024;
  auto kernel = flash_bwd_dkv_kernel<D>;
  static int configured = 0;
  if (int rc = configure(kernel, smem, configured)) return rc;
  const int grid = (p.Tk + P::BKV - 1) / P::BKV * p.B * p.Hq;
  kernel<<<grid, 256, smem, stream>>>(m.q, m.k, m.v, m.dout, m.bias, p);
  return (int)cudaGetLastError();
}

// Checks the shape, fills the parameters and encodes the tensor maps:
// q and dO in boxes of `q_rows` rows, k and v of `k_rows`, the bias of 32
// keys x `q_rows`.
int prepare(BwdParams& p, Maps& m, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, void* delta, const void* bias,
            const void* kv_mask, const void* q_seg, const void* kv_seg,
            const long long* shape, const long long* strides, float sm_scale) {
  const int B = (int)shape[0], Hq = (int)shape[1], Hkv = (int)shape[2];
  const int Tq = (int)shape[3], Tk = (int)shape[4], D = (int)shape[5];
  const int q_rows = (int)shape[6], k_rows = (int)shape[7];
  const int stages = (int)shape[9];
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      (D != 64 && D != 128) || (q_seg == nullptr) != (kv_seg == nullptr) ||
      encoder() == nullptr || stages < 2 || stages > 8)
    return (int)cudaErrorInvalidValue;
  const long long *sq = strides, *sk = strides + 3, *sv = strides + 6;
  const long long *sdo = strides + 9, *sb = strides + 18;
  for (int i = 0; i < 3; ++i) {
    p.so0[i] = strides[12 + i];
    p.so1[i] = strides[15 + i];
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.bias = static_cast<const float*>(bias);
  p.bias_mode = bias == nullptr ? BIAS_NONE : sb[2] == 0 ? BIAS_ROW : BIAS_TILE;
  p.bias_b = sb[0];
  p.bias_h = sb[1];
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.causal = (int)shape[8];
  p.stages = stages;
  p.scale_log2 = sm_scale * LOG2E;
  p.sm_scale = sm_scale;
  int rc;
  if ((rc = map_bf16_4d(&m.q, q, B, Hq, Tq, D, sq, q_rows)) ||
      (rc = map_bf16_4d(&m.dout, dout, B, Hq, Tq, D, sdo, q_rows)) ||
      (rc = map_bf16_4d(&m.k, k, B, Hkv, Tk, D, sk, k_rows)) ||
      (rc = map_bf16_4d(&m.v, v, B, Hkv, Tk, D, sv, k_rows)))
    return rc;
  m.bias = m.q;  // unused unless the bias has a query axis
  if (p.bias_mode == BIAS_TILE &&
      (rc = map_bias_4d(&m.bias, bias, B, Hq, Tq, Tk, sb, q_rows)))
    return rc;
  return 0;
}

}  // namespace

// q, dO (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D) bf16, each through its
// strides (elements, over batch, head and row; the head dim contiguous;
// strides multiples of 8 and bases 16-byte aligned, as TMA requires); lse
// f32 (B, Hq, Tq) from the forward kernel, delta f32 (B, Hq, Tq) written by
// the dq kernel and read by the dk/dv kernel; bias f32 as the forward takes
// it, or null; kv_mask, q_seg, kv_seg int32 (B, T) contiguous or null.
// shape: B, Hq, Hkv, Tq, Tk, D, block_q, block_k, causal, stages. strides:
// q, k, v, dO, out0, out1, bias, three each. D in {64, 128}; stages in
// [2, 8], within the 227 KB of shared memory a block may use.
// thinkdiff_flash_bwd_dq: dq (B, Hq, Tq, D) bf16 through the out0 strides;
// block_q 128 query rows a CTA (or 64 at D = 64), block_k 64.
// Launches on `stream`; returns a CUDA error code, or 1000 + the CUresult
// of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int thinkdiff_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, const void* bias,
    const void* kv_mask, const void* q_seg, const void* kv_seg,
    const long long* shape, const long long* strides, float sm_scale,
    void* stream) {
  BwdParams p;
  Maps m;
  const int block_q = (int)shape[6], block_k = (int)shape[7];
  if ((block_q != 128 && !(block_q == 64 && shape[5] == 64)) || block_k != 64)
    return (int)cudaErrorInvalidValue;
  if (int rc = prepare(p, m, q, k, v, dout, lse, delta, bias, kv_mask, q_seg,
                       kv_seg, shape, strides, sm_scale))
    return rc;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.out1 = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = block_q == 128;
  if (shape[5] == 64)
    return wide ? launch_dq<64, 2>(m, p, st) : launch_dq<64, 1>(m, p, st);
  return launch_dq<128, 2>(m, p, st);
}

// As thinkdiff_flash_bwd_dq, reading the delta it wrote; dk, dv (B, Hq, Tk,
// D) bf16 through the out0 / out1 strides, one per query head (the caller
// sums a GQA group). block_q and block_k 64.
extern "C" int thinkdiff_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* bias,
    const void* kv_mask, const void* q_seg, const void* kv_seg,
    const long long* shape, const long long* strides, float sm_scale,
    void* stream) {
  BwdParams p;
  Maps m;
  const int block_q = (int)shape[6], block_k = (int)shape[7];
  if (block_q != 64 || block_k != 64) return (int)cudaErrorInvalidValue;
  if (int rc = prepare(p, m, q, k, v, dout, lse, const_cast<void*>(delta), bias,
                       kv_mask, q_seg, kv_seg, shape, strides, sm_scale))
    return rc;
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shape[5] == 128 ? launch_dkv<128>(m, p, st) : launch_dkv<64>(m, p, st);
}
