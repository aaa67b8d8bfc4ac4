// Flash-attention forward for Hopper: online softmax over k/v tiles in smem.
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/flash_attention.py
// `_fwd_kernel` (wrapper `_flash_attention_forward`): the Qwen2-VL vision
// tower (D=80, 16 heads, 1024 patches per image) and the language model's
// one-shot prefill (D=128, 12 query / 2 kv heads, causal + key padding).
//
// What bounds it on an H100: the QK^T and PV products (4*T^2*D flop per
// head), which want the bf16 tensor cores; the (T, T) scores never go to
// device memory, so the bytes are only q, k, v and o.
// Design: one block of 4 warps per (batch*head, 64-row q tile); each warp
// owns 16 q rows as mma.sync m16n8k16 A fragments held in registers for the
// whole k sweep. k/v tiles of 64 keys are staged in padded smem (conflict-
// free 32-bit fragment reads for D in {64, 80, 128}). Scores, the running
// max m and sum l stay in f32 registers; P is fed to the PV product straight
// from the score accumulators (the C layout of two n8 tiles is the A layout
// of one k16 step). Masks are computed, never loaded as (T, T) tensors: the
// additive bias is read through strides (0 on broadcast dims), kv_mask and
// segment ids are (B, T) vectors, causal comes from indices, and causal
// blocks skip key tiles above the diagonal. Masked scores are -1e30 as in
// the JAX reference; rows that saw no key at all (l == 0) write 0. The kv
// head is h / (Hq / Hkv). Later work: cp.async/TMA pipelining, wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block (16 per warp)
constexpr int BKV = 64;      // keys per smem tile
constexpr int THREADS = 128;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Params {
  const __nv_bfloat16* q;  // (B, Hq, Tq, D)
  const __nv_bfloat16* k;  // (B, Hkv, Tk, D)
  const __nv_bfloat16* v;  // (B, Hkv, Tk, D)
  __nv_bfloat16* o;        // (B, Hq, Tq, D)
  const float* bias;       // indexed b*sb0 + h*sb1 + i*sb2 + j*sb3, or null
  long long sb0, sb1, sb2, sb3;
  const int* kv_mask;      // (B, Tk) or null
  const int* q_seg;        // (B, Tq) or null
  const int* kv_seg;       // (B, Tk) or null
  int Hq, Hkv, Tq, Tk;
  float sm_scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 8;     // padded smem row (elements)
  constexpr int KS = D / 16;    // k16 steps over the head dim
  constexpr int DT = D / 8;     // n8 tiles over the head dim
  constexpr int ST = BKV / 8;   // n8 tiles over a key tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const __nv_bfloat16* qh = p.q + (size_t)bh * p.Tq * D;
  const __nv_bfloat16* kh = p.k + ((size_t)b * p.Hkv + hk) * p.Tk * D;
  const __nv_bfloat16* vh = p.v + ((size_t)b * p.Hkv + hk) * p.Tk * D;

  // this thread's two q rows: r[0] = row g of the warp's 16, r[1] = g + 8
  int rows[2];
  rows[0] = q0 + warp * 16 + g;
  rows[1] = rows[0] + 8;

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e & 1];
      const int d = ks * 16 + t * 2 + (e >> 1) * 8;
      qf[ks][e] = r < p.Tq
          ? *reinterpret_cast<const uint32_t*>(qh + (size_t)r * D + d) : 0u;
    }
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    constexpr int CHUNKS = BKV * D / 8;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c / (D / 8);
      const int d = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kv0 + r < p.Tk) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(kv0 + r) * D + d);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(kv0 + r) * D + d);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + d) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + d) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * LD + ks * 16 + t * 2;
        mma_bf16(s[j], qf[ks], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // scale, bias, masks; c0,c1 at row g, cols 2t,2t+1; c2,c3 at row g+8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rows[e >> 1];
        const int col = kv0 + j * 8 + t * 2 + (e & 1);
        float x;
        if (col >= p.Tk) {
          x = -INFINITY;  // no such key: contributes nothing
        } else {
          x = s[j][e] * p.sm_scale;
          bool ok = true;
          if (r < p.Tq) {
            if (p.bias)
              x += p.bias[b * p.sb0 + h * p.sb1 + r * p.sb2 + col * p.sb3];
            if (p.q_seg)
              ok = p.q_seg[(size_t)b * p.Tq + r] == p.kv_seg[(size_t)b * p.Tk + col];
          }
          if (p.kv_mask) ok = ok && p.kv_mask[(size_t)b * p.Tk + col] > 0;
          if (p.causal) ok = ok && r >= col;
          if (!ok) x = NEG_BIG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);  // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P's k16 step kk is score tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vb = v0 + j * 8;
        uint32_t b0 = pack_bf16(vb[0], vb[LD]);
        uint32_t b1 = pack_bf16(vb[8 * LD], vb[9 * LD]);
        mma_bf16(o[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = l[i] == 0.f ? 1.f : l[i];
  }
  __nv_bfloat16* oh = p.o + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rows[i] * D + j * 8 + t * 2) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.Tq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/o contiguous bf16 in the (B, H, T, D) layout; bias f32 read at
// b*sb0 + h*sb1 + i*sb2 + j*sb3 (stride 0 on broadcast dims) or null;
// kv_mask/q_seg/kv_seg int32 (B, T) or null. D in {64, 80, 128}.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_flash_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    long long sb0, long long sb1, long long sb2, long long sb3,
    const void* kv_mask, const void* q_seg, const void* kv_seg,
    int B, int Hq, int Hkv, int Tq, int Tk, int D, float sm_scale, int causal,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || Tk < 0 ||
      ((q_seg == nullptr) != (kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.sb0 = sb0; p.sb1 = sb1; p.sb2 = sb2; p.sb3 = sb3;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, st);
    case 80: return launch<80>(p, B, st);
    case 128: return launch<128>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
