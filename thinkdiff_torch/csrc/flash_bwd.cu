// FlashAttention-2 backward for Hopper: the dq kernel (which also computes
// the FA2 delta) and the dk/dv kernel.
//
// Replaces the Pallas TPU kernels thinkdiff_tpu/ops/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (wrapper `_flash_attention_backward`): the
// gradients of the 48 attentions of the flan-t5-xxl decoder in the aligner's
// training step (24 causal self-attentions with the (1, H, T, T) relative
// bias and packed segments, 24 cross-attentions with kv_mask and segments;
// 64 heads of D=64, T = 256).
//
// What bounds them on an H100: the bf16 products. Per (query, key) pair the
// dq kernel recomputes S = scale*QK^T + bias and dP = dO V^T twice (one sweep
// for delta, one for dq) and adds dS K; the dk/dv kernel recomputes S and dP
// once and adds P^T dO and dS^T Q. The (T, T) scores, probabilities and
// their gradients never go to device memory; the bytes are q, k, v, dO, the
// bias and the (B, H, T) lse and delta rows.
// Design: the forward kernel's tiles (flash_fwd.cu). Blocks run in no
// order, so the TPU's sequential grid sweeps become loops inside a block:
//  - dq: one block of 4 warps per (batch*head, 64-row q tile); each warp
//    holds its 16 rows of Q and dO as mma A fragments and sweeps the k/v
//    tiles twice: sweep 0 accumulates delta = rowsum(P * dP) (the Pallas
//    kernel's choice: the attention output is not saved), sweep 1
//    accumulates dQ += dS K. delta goes to device memory for the next kernel.
//  - dk/dv: one block per (batch*query head, 64-key tile); each warp holds
//    16 keys of K and V as A fragments and sweeps the q tiles, computing the
//    transposed scores S^T = K Q^T so that P^T and dS^T come out of the
//    accumulators in the A layout of the dV += P^T dO and dK += dS^T Q steps.
//    Outputs are per query head; the wrapper sums a GQA group.
// P = exp(S - lse) from the forward's natural-log lse. Masks are the
// forward kernel's, element for element (bias through strides, kv_mask,
// segment ids, causal from indices, causal tiles skipped), except that a
// masked pair gets P = 0 explicitly: a row whose keys are all masked (a pad
// query row of a packed cross-attention) then contributes exactly 0 to dk
// and dv and gets dq = 0, as in the Pallas kernel, whatever its lse. P and
// dS are rounded to bf16 for the products; sums are f32.
// Later work: cp.async/TMA pipelining, wgmma, one fused kernel with atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int BQ = 64;       // q rows per tile (16 per warp in the dq kernel)
constexpr int BKV = 64;      // keys per tile (16 per warp in the dk/dv kernel)
constexpr int THREADS = 128;

struct BwdParams {
  const __nv_bfloat16* q;     // (B, Hq, Tq, D)
  const __nv_bfloat16* k;     // (B, Hkv, Tk, D)
  const __nv_bfloat16* v;     // (B, Hkv, Tk, D)
  const __nv_bfloat16* dout;  // (B, Hq, Tq, D)
  const float* lse;           // (B, Hq, Tq)
  float* delta;               // (B, Hq, Tq): written by dq, read by dk/dv
  __nv_bfloat16* dq;          // (B, Hq, Tq, D)
  __nv_bfloat16* dk;          // (B, Hq, Tk, D), per query head
  __nv_bfloat16* dv;          // (B, Hq, Tk, D), per query head
  const float* bias;          // indexed b*sb0 + h*sb1 + i*sb2 + j*sb3, or null
  long long sb0, sb1, sb2, sb3;
  const int* kv_mask;         // (B, Tk) or null
  const int* q_seg;           // (B, Tq) or null
  const int* kv_seg;          // (B, Tk) or null
  int Hq, Hkv, Tq, Tk;
  float sm_scale;
  int causal;
};

// Stage rows [r0, r0 + 64) of a (T, D) bf16 matrix into padded smem rows,
// zero past T.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* smem,
                                           const __nv_bfloat16* g, int r0,
                                           int T) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = 64 * D / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int r = c / (D / 8);
    const int d = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * D + d);
    *reinterpret_cast<uint4*>(smem + r * LD + d) = val;
  }
}

// The A fragments of 16 rows (row0 + g, row0 + g + 8) of a (T, D) matrix.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* g, int row0,
                                            int T, int gid, int tid) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + gid + (e & 1) * 8;
      const int d = ks * 16 + tid * 2 + (e >> 1) * 8;
      f[ks][e] = r < T ? *reinterpret_cast<const uint32_t*>(g + (size_t)r * D + d) : 0u;
    }
  }
}

// acc[j] (16 x 8, j over the 64 rows of `smem`) = A (16 x D) @ smem^T.
template <int D>
__device__ __forceinline__ void rows_times_smem_t(float (&acc)[8][4],
                                                  const uint32_t (&a)[D / 16][4],
                                                  const __nv_bfloat16* smem,
                                                  int gid, int tid) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* b = smem + (j * 8 + gid) * LD + ks * 16 + tid * 2;
      mma_bf16(acc[j], a[ks], *reinterpret_cast<const uint32_t*>(b),
               *reinterpret_cast<const uint32_t*>(b + 8));
    }
  }
}

// out[j] (16 x 8, j over D/8) += X (16 x 64, from the accumulators x) @ smem
// (64 x D).
template <int D>
__device__ __forceinline__ void acc_times_smem(float (&out)[D / 8][4],
                                               const float (&x)[8][4],
                                               const __nv_bfloat16* smem,
                                               int gid, int tid) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* b0p = smem + (kk * 16 + tid * 2) * LD + gid;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* b = b0p + j * 8;
      mma_bf16(out[j], a, pack_bf16(b[0], b[LD]), pack_bf16(b[8 * LD], b[9 * LD]));
    }
  }
}

// Whether query row r (< Tq) may attend key col (< Tk): the forward kernel's
// masks, without the score.
__device__ __forceinline__ bool allowed(const BwdParams& p, int b, int r, int col,
                                        int qseg, int kseg) {
  bool ok = true;
  if (p.q_seg) ok = qseg == kseg;
  if (p.kv_mask) ok = ok && p.kv_mask[(size_t)b * p.Tk + col] > 0;
  if (p.causal) ok = ok && r >= col;
  return ok;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int DT = D / 8;
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
  const __nv_bfloat16* kh = p.k + ((size_t)b * p.Hkv + hk) * p.Tk * D;
  const __nv_bfloat16* vh = p.v + ((size_t)b * p.Hkv + hk) * p.Tk * D;

  int rows[2];
  rows[0] = q0 + warp * 16 + g;
  rows[1] = rows[0] + 8;
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_rows<D>(qf, p.q + (size_t)bh * p.Tq * D, q0 + warp * 16, p.Tq, g, t);
  load_a_rows<D>(dof, p.dout + (size_t)bh * p.Tq * D, q0 + warp * 16, p.Tq, g, t);
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  int qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < p.Tq) {
      lse[i] = p.lse[(size_t)bh * p.Tq + rows[i]];
      if (p.q_seg) qseg[i] = p.q_seg[(size_t)b * p.Tq + rows[i]];
    }
  }
  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
      __syncthreads();
      stage_rows<D>(Ks, kh, kv0, p.Tk);
      stage_rows<D>(Vs, vh, kv0, p.Tk);
      __syncthreads();
      float s[8][4], dp[8][4];
      rows_times_smem_t<D>(s, qf, Ks, g, t);    // Q K^T
      rows_times_smem_t<D>(dp, dof, Vs, g, t);  // dO V^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int r = rows[i];
          const int col = kv0 + j * 8 + t * 2 + (e & 1);
          float pe = 0.f;
          if (r < p.Tq && col < p.Tk &&
              allowed(p, b, r, col, qseg[i],
                      p.kv_seg ? p.kv_seg[(size_t)b * p.Tk + col] : 0)) {
            float x = s[j][e] * p.sm_scale;
            if (p.bias) x += p.bias[b * p.sb0 + h * p.sb1 + r * p.sb2 + col * p.sb3];
            pe = expf(x - lse[i]);
          }
          if (sweep == 0) {
            delta[i] += pe * dp[j][e];
          } else {
            s[j][e] = pe * (dp[j][e] - delta[i]);  // dS
          }
        }
      }
      if (sweep == 1) acc_times_smem<D>(dq, s, Ks, g, t);  // dQ += dS K
    }
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
        if (t == 0 && rows[i] < p.Tq) p.delta[(size_t)bh * p.Tq + rows[i]] = delta[i];
      }
    }
  }

  __nv_bfloat16* dqh = p.dq + (size_t)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)rows[i] * D + j * 8 + t * 2) =
          __floats2bfloat162_rn(dq[j][2 * i] * p.sm_scale, dq[j][2 * i + 1] * p.sm_scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 dOs[BQ * LD];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];
  __shared__ int qseg_s[BQ];

  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16* qh = p.q + (size_t)bh * p.Tq * D;
  const __nv_bfloat16* doh = p.dout + (size_t)bh * p.Tq * D;

  // this thread's two keys: the accumulator rows g and g + 8 of its warp
  int keys[2];
  keys[0] = k0 + warp * 16 + g;
  keys[1] = keys[0] + 8;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  const size_t kvoff = ((size_t)b * p.Hkv + hk) * p.Tk * D;
  load_a_rows<D>(kf, p.k + kvoff, k0 + warp * 16, p.Tk, g, t);
  load_a_rows<D>(vf, p.v + kvoff, k0 + warp * 16, p.Tk, g, t);
  int kseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (p.kv_seg && keys[i] < p.Tk) kseg[i] = p.kv_seg[(size_t)b * p.Tk + keys[i]];
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // causal: rows below the tile's first key see none of its keys
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < p.Tq; q0 += BQ) {
    __syncthreads();
    stage_rows<D>(Qs, qh, q0, p.Tq);
    stage_rows<D>(dOs, doh, q0, p.Tq);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int r = q0 + i;
      const bool in = r < p.Tq;
      lse_s[i] = in ? p.lse[(size_t)bh * p.Tq + r] : 0.f;
      delta_s[i] = in ? p.delta[(size_t)bh * p.Tq + r] : 0.f;
      qseg_s[i] = in && p.q_seg ? p.q_seg[(size_t)b * p.Tq + r] : 0;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    rows_times_smem_t<D>(s, kf, Qs, g, t);    // S^T = K Q^T
    rows_times_smem_t<D>(dp, vf, dOs, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = keys[i];
        const int qi = j * 8 + t * 2 + (e & 1);
        const int r = q0 + qi;
        float pe = 0.f;
        if (r < p.Tq && key < p.Tk && allowed(p, b, r, key, qseg_s[qi], kseg[i])) {
          float x = s[j][e] * p.sm_scale;
          if (p.bias) x += p.bias[b * p.sb0 + h * p.sb1 + r * p.sb2 + key * p.sb3];
          pe = expf(x - lse_s[qi]);
        }
        s[j][e] = pe;                             // P^T
        dp[j][e] = pe * (dp[j][e] - delta_s[qi]);  // dS^T
      }
    }
    acc_times_smem<D>(dv, s, dOs, g, t);   // dV += P^T dO
    acc_times_smem<D>(dk, dp, Qs, g, t);   // dK += dS^T Q
  }

  __nv_bfloat16* dkh = p.dk + (size_t)bh * p.Tk * D;
  __nv_bfloat16* dvh = p.dv + (size_t)bh * p.Tk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const size_t o = (size_t)keys[i] * D + j * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(dkh + o) = __floats2bfloat162_rn(
          dk[j][2 * i] * p.sm_scale, dk[j][2 * i + 1] * p.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + o) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

bool fill(BwdParams& p, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, void* delta, const void* bias,
          long long sb0, long long sb1, long long sb2, long long sb3,
          const void* kv_mask, const void* q_seg, const void* kv_seg, int B,
          int Hq, int Hkv, int Tq, int Tk, float sm_scale, int causal) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      ((q_seg == nullptr) != (kv_seg == nullptr)))
    return false;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.bias = static_cast<const float*>(bias);
  p.sb0 = sb0; p.sb1 = sb1; p.sb2 = sb2; p.sb3 = sb3;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  return true;
}

}  // namespace

// All tensors contiguous: q, dout, dq bf16 (B, Hq, Tq, D); k, v bf16
// (B, Hkv, Tk, D); lse, delta f32 (B, Hq, Tq) — lse from the forward kernel,
// delta written here; bias f32 read at b*sb0 + h*sb1 + i*sb2 + j*sb3 or null;
// kv_mask/q_seg/kv_seg int32 (B, T) or null. D in {64, 128}. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int thinkdiff_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, const void* bias, long long sb0,
    long long sb1, long long sb2, long long sb3, const void* kv_mask,
    const void* q_seg, const void* kv_seg, int B, int Hq, int Hkv, int Tq,
    int Tk, int D, float sm_scale, int causal, void* stream) {
  BwdParams p;
  if (!fill(p, q, k, v, dout, lse, delta, bias, sb0, sb1, sb2, sb3, kv_mask,
            q_seg, kv_seg, B, Hq, Hkv, Tq, Tk, sm_scale, causal))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: flash_bwd_dq_kernel<64><<<grid, THREADS, 0, st>>>(p); break;
    case 128: flash_bwd_dq_kernel<128><<<grid, THREADS, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As thinkdiff_flash_bwd_dq, reading the delta it wrote; dk, dv bf16
// (B, Hq, Tk, D), one per query head (the caller sums a GQA group).
extern "C" int thinkdiff_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* bias,
    long long sb0, long long sb1, long long sb2, long long sb3,
    const void* kv_mask, const void* q_seg, const void* kv_seg, int B, int Hq,
    int Hkv, int Tq, int Tk, int D, float sm_scale, int causal, void* stream) {
  BwdParams p;
  if (!fill(p, q, k, v, dout, lse, const_cast<void*>(delta), bias, sb0, sb1,
            sb2, sb3, kv_mask, q_seg, kv_seg, B, Hq, Hkv, Tq, Tk, sm_scale,
            causal))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  dim3 grid((Tk + BKV - 1) / BKV, B * Hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: flash_bwd_dkv_kernel<64><<<grid, THREADS, 0, st>>>(p); break;
    case 128: flash_bwd_dkv_kernel<128><<<grid, THREADS, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
