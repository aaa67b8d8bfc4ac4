// Paged decode attention for Hopper: one query token per slot against the
// slot's pages of a shared KV pool.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/paged_attention.py
// `_paged_kernel` (wrapper `paged_attention_pallas`): every decode step of
// the paged serving scheduler, once per language-model layer (2B: 12 query
// heads, 2 kv heads, D=128, 64-token pages, 256 slots; 7B: 28 and 4).
//
// What bounds it on an H100: the bytes of K and V of each slot's live pages,
// read once (2 x 64 x 128 x 2 B = 32 KB per page and kv head); the products
// are 4*G*D flop per cached token, far below the card's compute rate. So
// the design is a bandwidth kernel:
//  - Work units are (slot, kv head, range of pages); the host's paged_plan
//    picks the pages a unit from the shapes alone (the lengths stay on the
//    card: no host read, nothing that breaks a CUDA graph). A unit reads
//    its slot's length and exits at once past the slot's live pages, the
//    early exit the TPU kernel gets by clamping its index map. Page 0, the
//    trash page, is never copied: only the pages of the table's first
//    ceil(len / page) entries are.
//  - Streaming: a stage is 64 tokens (64 / page pages) of K and of V of one
//    kv head; each page's K (and V) is one contiguous block of the (P, Hkv,
//    PAGE, D) pool, copied by TMA in two 64-column boxes with the 128-byte
//    swizzle. One producer warp reads the unit's page ids (the first 32
//    together with the slot's length, in one round trip) and keeps a ring
//    of two 32 KB stages in flight on full/empty mbarriers: three CTAs an
//    SM hold up to 192 KB in flight (3- and 4-stage rings measured no
//    faster).
//  - Compute on mma.sync m16n8k16: the G <= 8 query heads of the kv head
//    are the rows (padded to 16; the pad rows are zero registers), S = q
//    K^T from ldmatrix of K, then P V from ldmatrix .trans of V, with P
//    taken straight from S's accumulators (carried as two bf16 terms, hi +
//    lo, so the product keeps ~16 bits of each probability). Each of four
//    consumer warps owns 16 tokens of every stage and its own online
//    softmax in f32 (running max m, sum l, rescale alpha); masked positions
//    are -1e30 as in the JAX kernel and add exactly nothing. At the unit's
//    end the four warps merge in shared memory in warp order.
//  - Split units combine in the same launch: each writes (m, l, acc) to a
//    workspace, and the last of the (slot, kv head)'s units to finish (a
//    counter, taken with an atomic after a fence) combines them in unit
//    order and sets the counter back to 0: one launch, fixed bits, and a
//    CUDA-graph replay finds its counters at 0. A slot whose live pages fit
//    one unit writes its output directly.
//  - A slot of length 0 reads no page: m = -1e30, l = 0, and the finalize's
//    l == 0 guard writes zeros (no NaN). Its output is not defined (the TPU
//    kernel averages V over the slot's first table page) and no caller
//    reads it: the model passes lengths of cache_len + 1.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr int PD_D = 128;                    // head dim (Qwen2-VL 2B and 7B)
constexpr int PD_TOK = 64;                   // tokens a stage
constexpr int PD_CONSUMERS = 4;              // 16 tokens of a stage each
constexpr int PD_THREADS = (PD_CONSUMERS + 1) * 32;
constexpr int PD_STAGES = 2;                 // ring: 64 KB a CTA, three CTAs an SM
constexpr int PD_HALF = PD_TOK * 128;        // one 64-column half of K or V: 8 KB
constexpr int PD_STAGE = 4 * PD_HALF;        // K and V, both halves: 32 KB
constexpr int PD_MAX_G = 8;                  // query heads per kv head, at most
constexpr int PD_WS = PD_MAX_G * PD_D + 2 * PD_MAX_G;  // floats a unit's partial
constexpr int PD_SMEM = PD_STAGES * PD_STAGE + 1024;

struct PagedParams {
  const __nv_bfloat16* q;  // (S, H, D)
  __nv_bfloat16* out;      // (S, H, D)
  const int* table;        // (S, MP)
  const void* lengths;     // (S,) int32 or int64
  float* ws;               // (S * Hkv * splits, PD_WS), when split
  int* cnt;                // (S * Hkv,), when split
  int H, Hkv, G, page, MP, ppu, splits;
  float sm_scale;
};

// the shared-memory address of (token, column) of a K or V stage array in
// the 128-byte swizzle: two 64-column halves of 64 rows of 128 bytes
__device__ __forceinline__ const uint8_t* kv_at(const uint8_t* base, int tok, int col) {
  return base + (col >> 6) * PD_HALF + tok * 128 + ((((col & 63) >> 3) ^ (tok & 7)) << 4);
}

template <bool LENS64>
__global__ void __launch_bounds__(PD_THREADS, 3)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const PagedParams p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned (the 128-byte swizzle's period) by arithmetic on the
  // shared array itself, so that the compiler keeps shared loads and stores
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[PD_STAGES], empty[PD_STAGES];
  __shared__ float ml[PD_CONSUMERS][PD_MAX_G][2];
  __shared__ int last;

  const int unit = blockIdx.x;
  const int sp = unit % p.splits;
  const int pair = unit / p.splits;  // slot * Hkv + kv head
  const int s = pair / p.Hkv, hk = pair % p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the producer warp reads the unit's first 32 page ids together with the
  // length, before it is known which are live: one round trip, not two
  int id0 = 0;
  if (warp == PD_CONSUMERS && lane < p.ppu && sp * p.ppu + lane < p.MP)
    id0 = p.table[(size_t)s * p.MP + sp * p.ppu + lane];
  const long long len_raw = LENS64 ? static_cast<const long long*>(p.lengths)[s]
                                   : static_cast<const int*>(p.lengths)[s];
  const int len = (int)min(max(len_raw, 0LL), (long long)p.MP * p.page);
  const int np = (len + p.page - 1) / p.page;         // live pages
  const int nlive = max(1, (np + p.ppu - 1) / p.ppu); // live units
  if (sp >= nlive) return;  // past the slot's live pages
  const int p_lo = sp * p.ppu, p_hi = min(np, p_lo + p.ppu);
  const int lim = min(len, p_hi * p.page);  // this unit's tokens end here
  const int pps = PD_TOK / p.page;          // pages a stage
  const int nstage = (p_hi - p_lo + pps - 1) / pps;  // 0 at length 0

  if (threadIdx.x == 0) {
    for (int i = 0; i < PD_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], PD_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PD_CONSUMERS) {
    // ---- producer warp: the page ids 32 at a time, lane 0 issues ----------
    if (lane == 0) {
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
    }
    const int npg = p_hi - p_lo;
    for (int c0 = 0; c0 < npg; c0 += 32) {  // 32 is a whole number of stages
      const int id = c0 == 0 ? id0
                     : c0 + lane < npg ? p.table[(size_t)s * p.MP + p_lo + c0 + lane] : 0;
      for (int j = 0; j < min(32, npg - c0); ++j) {
        const int pid = __shfl_sync(0xffffffffu, id, j);
        const int i = (c0 + j) / pps, slot = i % PD_STAGES, pp = (c0 + j) % pps;
        if (lane == 0) {
          if (pp == 0) {
            mbar_wait(&empty[slot], ((i / PD_STAGES) & 1) ^ 1);
            const int pages = min(pps, npg - (c0 + j));
            mbar_arrive_expect_tx(&full[slot], pages * p.page * 128 * 4);
          }
          const int row = (pid * p.Hkv + hk) * p.page;
          uint8_t* st = ring + slot * PD_STAGE + pp * p.page * 128;
          tma_load_4d(st, &tm_k, &full[slot], 0, row, 0, 0);
          tma_load_4d(st + PD_HALF, &tm_k, &full[slot], 64, row, 0, 0);
          tma_load_4d(st + 2 * PD_HALF, &tm_v, &full[slot], 0, row, 0, 0);
          tma_load_4d(st + 3 * PD_HALF, &tm_v, &full[slot], 64, row, 0, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  // q as A fragments (rows = the group's heads, g < G; rows g + 8 are zero)
  uint32_t qa[8][2];
  {
    const __nv_bfloat16* qr = p.q + ((size_t)s * p.H + hk * p.G + g) * PD_D;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qa[kk][0] = g < p.G ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t) : 0u;
      qa[kk][1] = g < p.G ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 + 2 * t) : 0u;
    }
  }
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m = NEG_BIG, l = 0.f;  // head g's, the same in the four lanes t

  const int lrow = lane & 7, lmat = lane >> 3;  // ldmatrix: row, matrix
  for (int i = 0; i < nstage; ++i) {
    const int slot = i % PD_STAGES;
    mbar_wait(&full[slot], (i / PD_STAGES) & 1);
    const int tok0 = (p_lo + i * pps) * p.page + 16 * warp;  // this warp's first
    if (tok0 < lim) {
      const uint8_t* ks = ring + slot * PD_STAGE;
      const uint8_t* vs = ks + 2 * PD_HALF;
      // S (16 x 16): two n8 tiles of tokens; ldmatrix matrices (tile, d half)
      // two accumulators a tile (even and odd k16 steps), so that the
      // chain of dependent products is half as long
      float sc2[2][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc2[j][c][e] = 0.f;
      const int ktok = 16 * warp + 8 * (lmat >> 1) + lrow;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kv_at(ks, ktok, 16 * kk + 8 * (lmat & 1)));
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(sc2[0][kk & 1], a, b[0], b[1]);
        mma_bf16(sc2[1][kk & 1], a, b[2], b[3]);
      }
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = sc2[j][0][e] + sc2[j][1][e];
      // online softmax of head g over this warp's 16 tokens
      float x[4];
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = tok0 + 8 * (e >> 1) + 2 * t + (e & 1);
        ok[e] = tok < lim;
        x[e] = ok[e] ? sc[e >> 1][e & 1] * p.sm_scale : NEG_BIG;
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = __expf(m - m_new);
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = ok[e] ? __expf(x[e] - m_new) : 0.f;
      l = l * alpha + (pr[0] + pr[1]) + (pr[2] + pr[3]);
      m = m_new;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[n][0] *= alpha;
        acc[n][1] *= alpha;
      }
      // P (head g, the 16 tokens) as two bf16 A fragments, hi + lo
      const uint32_t h0 = pack_bf16(pr[0], pr[1]), h1 = pack_bf16(pr[2], pr[3]);
      const __nv_bfloat162 b0 = *reinterpret_cast<const __nv_bfloat162*>(&h0);
      const __nv_bfloat162 b1 = *reinterpret_cast<const __nv_bfloat162*>(&h1);
      const uint32_t ahi[4] = {h0, 0u, h1, 0u};
      const uint32_t alo[4] = {
          pack_bf16(pr[0] - __low2float(b0), pr[1] - __high2float(b0)), 0u,
          pack_bf16(pr[2] - __low2float(b1), pr[3] - __high2float(b1)), 0u};
      // O += P V: ldmatrix .trans matrices (token half, d tile)
      const int vtok = 16 * warp + 8 * (lmat & 1) + lrow;
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, kv_at(vs, vtok, 8 * (n + (lmat >> 1))));
        mma_bf16(acc[n], ahi, b[0], b[1]);
        mma_bf16(acc[n], alo, b[0], b[1]);
        mma_bf16(acc[n + 1], ahi, b[2], b[3]);
        mma_bf16(acc[n + 1], alo, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // ---- merge the four warps (warp order), in the ring's memory --------------
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  named_sync(1, PD_CONSUMERS * 32);  // every warp is done with the ring
  float* mrg = reinterpret_cast<float*>(ring);  // [warp][head][D]
  if (g < p.G) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(mrg + (warp * PD_MAX_G + g) * PD_D + 8 * n + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
    if (t == 0) {
      ml[warp][g][0] = m;
      ml[warp][g][1] = l;
    }
  }
  named_sync(1, PD_CONSUMERS * 32);
  const int d = threadIdx.x;  // one output dimension a thread
  float M[PD_MAX_G], L[PD_MAX_G], A[PD_MAX_G];
#pragma unroll
  for (int h = 0; h < PD_MAX_G; ++h) {
    M[h] = NEG_BIG;
    L[h] = 0.f;
    A[h] = 0.f;
    if (h < p.G) {
#pragma unroll
      for (int w = 0; w < PD_CONSUMERS; ++w) M[h] = fmaxf(M[h], ml[w][h][0]);
#pragma unroll
      for (int w = 0; w < PD_CONSUMERS; ++w) {
        const float c = __expf(ml[w][h][0] - M[h]);
        L[h] += ml[w][h][1] * c;
        A[h] += mrg[(w * PD_MAX_G + h) * PD_D + d] * c;
      }
    }
  }
  __nv_bfloat16* o = p.out + ((size_t)s * p.H + hk * p.G) * PD_D + d;
  if (nlive == 1) {
#pragma unroll
    for (int h = 0; h < PD_MAX_G; ++h)
      if (h < p.G) o[h * PD_D] = __float2bfloat16(A[h] / (L[h] == 0.f ? 1.f : L[h]));
    return;
  }

  // ---- a split: this unit's (m, l, acc), then the pair's counter ------------
  float* wu = p.ws + (size_t)unit * PD_WS;
#pragma unroll
  for (int h = 0; h < PD_MAX_G; ++h) {
    if (h < p.G) wu[h * PD_D + d] = A[h];
    if (h < p.G && d == h) {
      wu[PD_MAX_G * PD_D + 2 * h] = M[h];
      wu[PD_MAX_G * PD_D + 2 * h + 1] = L[h];
    }
  }
  __threadfence();
  named_sync(1, PD_CONSUMERS * 32);
  if (threadIdx.x == 0) last = atomicAdd(&p.cnt[pair], 1) == nlive - 1;
  named_sync(1, PD_CONSUMERS * 32);
  if (!last) return;
  __threadfence();
  // the units' (m, l) into shared memory (the merge buffer is free: every
  // thread's reads of it came before the barriers above), then each head's
  // max; the acc loads of a unit issued together
  const float* w0 = p.ws + (size_t)pair * p.splits * PD_WS;
  float* ml_u = mrg;  // [unit][head][m, l]
  for (int i = threadIdx.x; i < nlive * 2 * PD_MAX_G; i += PD_CONSUMERS * 32)
    ml_u[i] = __ldcg(w0 + (size_t)(i / (2 * PD_MAX_G)) * PD_WS + PD_MAX_G * PD_D +
                     i % (2 * PD_MAX_G));
  named_sync(1, PD_CONSUMERS * 32);
#pragma unroll
  for (int h = 0; h < PD_MAX_G; ++h) {
    M[h] = NEG_BIG;
    L[h] = 0.f;
    A[h] = 0.f;
  }
  for (int u = 0; u < nlive; ++u)
#pragma unroll
    for (int h = 0; h < PD_MAX_G; ++h)
      if (h < p.G) M[h] = fmaxf(M[h], ml_u[(u * PD_MAX_G + h) * 2]);
  for (int u = 0; u < nlive; ++u) {
    const float* wp = w0 + (size_t)u * PD_WS;
    float a[PD_MAX_G];
#pragma unroll
    for (int h = 0; h < PD_MAX_G; ++h) a[h] = h < p.G ? __ldcg(wp + h * PD_D + d) : 0.f;
#pragma unroll
    for (int h = 0; h < PD_MAX_G; ++h) {
      if (h >= p.G) continue;
      const float c = __expf(ml_u[(u * PD_MAX_G + h) * 2] - M[h]);
      L[h] += ml_u[(u * PD_MAX_G + h) * 2 + 1] * c;
      A[h] += a[h] * c;
    }
  }
#pragma unroll
  for (int h = 0; h < PD_MAX_G; ++h)
    if (h < p.G) o[h * PD_D] = __float2bfloat16(A[h] / (L[h] == 0.f ? 1.f : L[h]));
  if (threadIdx.x == 0) p.cnt[pair] = 0;  // ready for the next launch
}

template <bool LENS64>
int paged_launch(const CUtensorMap& tk, const CUtensorMap& tv, const PagedParams& p,
                 int units, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<LENS64>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PD_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    configured = true;
  }
  kernel<<<units, PD_THREADS, PD_SMEM, stream>>>(tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (S, H, D) bf16; k_pool, v_pool (P, Hkv, page, D) bf16, all contiguous,
// 16-byte aligned; table (S, MP) int32 page ids (each < P); lengths (S,)
// int32 (lens64 = 0) or int64; out (S, H, D) bf16. D = 128, page 16, 32 or
// 64, H / Hkv <= 8. The plan is ops/paged_attention.py's paged_plan: `ppu`
// pages a unit (a whole number of 64-token stages), so splits =
// ceil(MP / ppu) units a (slot, kv head). With splits > 1, ws holds S * Hkv
// * splits * (8 * 128 + 16) floats and cnt S * Hkv ints, all 0 before the
// first launch; the kernel leaves them at 0. Launches on `stream`; returns
// a CUDA error code (or 1000 + a refused tensor map's CUresult).
extern "C" int thinkdiff_paged_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, void* ws,
                                      void* cnt, int S, int H, int Hkv, int P,
                                      int page, int MP, int Dh, int ppu,
                                      int lens64, float sm_scale, void* stream) {
  if (S <= 0 || Hkv <= 0 || P <= 0 || H % Hkv != 0 || H / Hkv > PD_MAX_G ||
      Dh != PD_D || (page != 16 && page != 32 && page != 64) || MP <= 0 ||
      ppu <= 0 || ppu % (PD_TOK / page) != 0 || encoder() == nullptr)
    return (int)cudaErrorInvalidValue;
  PagedParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.table = static_cast<const int*>(table);
  p.lengths = lengths;
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(cnt);
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.page = page;
  p.MP = MP;
  p.ppu = ppu;
  p.splits = (MP + ppu - 1) / ppu;
  p.sm_scale = sm_scale;
  // a split's closing unit stages the units' (m, l) in the ring's memory
  if (p.splits > 1 && (ws == nullptr || cnt == nullptr ||
                       p.splits * 2 * PD_MAX_G * 4 > PD_STAGES * PD_STAGE))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)S * Hkv * p.splits;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  const int rows = P * Hkv * page;
  int rc;
  if ((rc = cached_map_2d(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k_pool, rows,
                          PD_D, 64, page, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (rc = cached_map_2d(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v_pool, rows,
                          PD_D, 64, page, CU_TENSOR_MAP_SWIZZLE_128B)))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  return lens64 ? paged_launch<true>(tk, tv, p, (int)units, st)
                : paged_launch<false>(tk, tv, p, (int)units, st);
}
