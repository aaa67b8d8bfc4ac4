// Paged decode attention for Hopper: one query token per slot against the
// slot's pages of a shared KV pool.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/paged_attention.py
// `_paged_kernel` (wrapper `paged_attention_pallas`): every decode step of
// the paged serving scheduler, once per language-model layer (2B: 12 query
// heads, 2 kv heads, D=128, 64-token pages, 256 slots).
//
// What bounds it on an H100: the bytes of K and V of each slot's live pages,
// read once (2 x 64 x 128 x 2 B = 32 KB per page and kv head); the products
// are 4*G*D flop per cached token, far below the card's compute rate.
// Design: one block per (slot, kv head), so 256 slots give 512 blocks for
// 132 SMs. The block reads its slot's length and page ids itself and loops
// over ceil(len / PAGE) pages only: that loop bound is the per-slot early
// exit (the TPU kernel walks a fixed (slots, MP) grid and gets it by
// clamping its index map, which has no counterpart here). The G query heads
// of the kv head stay in shared memory (f32, pre-scaled by sm_scale), and
// each K/V page is staged into shared memory once for the whole group with
// 16-byte loads. Scores: two threads per token, each over alternating
// 8-element chunks of D (conflict-free with the padded row), joined by one
// shuffle. The online softmax runs in f32 per head (running max m, sum l,
// rescale alpha, all in shared memory); masked positions are -1e30 as in
// the JAX kernel and the finalize guards l == 0. PV: thread d owns output
// dimension d for all G heads, so the output write is coalesced. CUDA cores
// are enough at this arithmetic intensity. Later work: cp.async double
// buffering of pages, and splitting long contexts over more blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;           // head dim (Qwen2-VL 2B and 7B)
constexpr int THREADS = 128;     // == D: one output dimension per thread
constexpr int MAX_PAGE = 64;     // tokens per page, at most
constexpr int MAX_G = 8;         // query heads per kv head, at most
constexpr int CH = D / 8;        // 16-byte chunks per row
constexpr int LD = D + 16;       // padded smem row (bf16): conflict-free 16 B reads
constexpr float NEG_BIG = -1e30f;

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,       // (S, H, D)
                    const __nv_bfloat16* __restrict__ k_pool,  // (P, Hkv, PAGE, D)
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ table,             // (S, MP)
                    const int* __restrict__ lengths,           // (S,)
                    __nv_bfloat16* __restrict__ out,           // (S, H, D)
                    int H, int Hkv, int page, int MP, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[MAX_PAGE * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[MAX_PAGE * LD];
  __shared__ float Qs[MAX_G][D];
  __shared__ float Ps[MAX_G][MAX_PAGE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], alpha_s[MAX_G];

  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < G * D; i += THREADS) {
    const int h = i / D, d = i % D;
    Qs[h][d] = __bfloat162float(q[((size_t)s * H + hk * G + h) * D + d]) * sm_scale;
  }
  if (tid < MAX_G) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  const int len = lengths[s];
  const int npages = min(max((len + page - 1) / page, 1), MP);

  float acc[MAX_G];
#pragma unroll
  for (int h = 0; h < MAX_G; ++h) acc[h] = 0.f;

  const int tok = tid / 2;   // the token whose scores this thread computes
  const int half = tid % 2;  // which alternating 8-element chunks of D
  for (int p = 0; p < npages; ++p) {
    const int pid = table[(size_t)s * MP + p];
    const size_t base = ((size_t)pid * Hkv + hk) * page * D;
    __syncthreads();  // the previous page is fully consumed
    for (int c = tid; c < page * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      *reinterpret_cast<uint4*>(Ks + r * LD + d) =
          *reinterpret_cast<const uint4*>(k_pool + base + (size_t)r * D + d);
      *reinterpret_cast<uint4*>(Vs + r * LD + d) =
          *reinterpret_cast<const uint4*>(v_pool + base + (size_t)r * D + d);
    }
    __syncthreads();

    // scores of token `tok` for every head of the group
    float sc[MAX_G];
#pragma unroll
    for (int h = 0; h < MAX_G; ++h) sc[h] = 0.f;
    if (tok < page) {
      for (int cidx = half; cidx < CH; cidx += 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(Ks + tok * LD + cidx * 8);
        const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(kv[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int h = 0; h < MAX_G; ++h) {
          if (h < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e) sc[h] += Qs[h][cidx * 8 + e] * kf[e];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MAX_G; ++h) sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], 1);
    if (half == 0 && tok < page) {
      const bool valid = p * page + tok < len;
      for (int h = 0; h < G; ++h) Ps[h][tok] = valid ? sc[h] : NEG_BIG;
    }
    __syncthreads();

    // online softmax per head: warp w takes heads w, w + 4, ...
    for (int h = warp; h < G; h += THREADS / 32) {
      float mx = NEG_BIG;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, Ps[h][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float e = expf(Ps[h][j] - m_new);
        Ps[h][j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha_s[h] = a;
        l_s[h] = a * l_s[h] + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // PV for output dimension tid
#pragma unroll
    for (int h = 0; h < MAX_G; ++h)
      if (h < G) acc[h] *= alpha_s[h];
    for (int j = 0; j < page; ++j) {
      const float v = __bfloat162float(Vs[j * LD + tid]);
#pragma unroll
      for (int h = 0; h < MAX_G; ++h)
        if (h < G) acc[h] += Ps[h][j] * v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < MAX_G; ++h) {
    if (h < G) {
      const float l = l_s[h] == 0.f ? 1.f : l_s[h];
      out[((size_t)s * H + hk * G + h) * D + tid] = __float2bfloat16(acc[h] / l);
    }
  }
}

}  // namespace

// q (S, H, D) bf16; k_pool, v_pool (P, Hkv, page, D) bf16, all contiguous;
// table (S, MP) int32 page ids (each < P); lengths (S,) int32; out (S, H, D)
// bf16. D = 128, page <= 64, H / Hkv <= 8. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int thinkdiff_paged_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, int S,
                                      int H, int Hkv, int page, int MP, int Dh,
                                      float sm_scale, void* stream) {
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G || Dh != D ||
      page <= 0 || page > MAX_PAGE || MP <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S, Hkv);
  paged_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, Hkv, page, MP, sm_scale);
  return (int)cudaGetLastError();
}
