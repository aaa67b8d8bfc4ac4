// w8a8 GEMM forward with the activation quantization inside the kernel:
//   sx[r] = max(max_k |x[r, k]|, 1e-30) * fl(1 / 127)
//   xq[r, k] = clip(round_half_even(x[r, k] / sx[r]), -127, 127)
//   y = out(float(xq @ Wq) * sx[r] * s[col])
//
// Replaces the Pallas TPU kernel thinkdiff_tpu/ops/int8_matmul.py
// `_s8_fwd_qx_kernel` (wrapper `_s8_matmul_fused_qx`), the op that skips the
// separate per-row absmax pre-pass of a w8a8 projection (ops/quant.py
// `_absmax_quant_rows` + s8_gemm.cu). No model path of either package calls
// it; the JAX package keeps it as the record of the attempt.
//
// What bounds it on an H100: the int8 tensor-core rate (1,979 TOP/s dense)
// at the flan-t5-xxl training shapes (R = 1024, K = 4096); the quantization
// is 4 M divisions and 8 MB of bf16 x, a few microseconds of the card.
// Design: one launch of persistent CTAs, one an SM.
//  - First every CTA takes tickets of 8 rows and quantizes them, a warp a
//    row, into an int8 workspace (R, K) and an f32 sx (R,) (s8_quant.cuh):
//    each row once. (Quantizing inside each output tile instead repeats
//    the work for every column tile: 160 times at wi_fused, 2.6 GB of L2
//    reads and 671 M divisions.)
//  - Then s8_wgmma.cuh's mainloop (s8_body: s8 wgmma on a TMA ring, with
//    the tiles of ops/int8_matmul.py s8_qx_plan) runs on the workspace,
//    which stays in the 50 MB L2. Its producer issues the first unit's
//    weight slices, then waits for the unit's row tile (an acquire of the
//    tile's ready counter, then fence.proxy.async.global, then TMA), so
//    the ring fills while the rows are quantized.
//  - The contraction is not split: at every shape this op runs (R 1024 K
//    4096: 128 or 640 tiles of 128 x 256) the tiles alone fill the grid,
//    and a split would add a reduction of int32 partials (PERF.md).
//  - Epilogue: float(acc) * sx[r] * s[c] in that order; bf16 through the
//    TMA-store tile, f32 stored from registers.
//  - The last CTA to finish resets the ticket and ready counters: a call
//    and a CUDA-graph replay find them at 0 (while no two launches in
//    flight share the workspace; s8_quant.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "s8_quant.cuh"
#include "s8_wgmma.cuh"

namespace {

template <int BM, int BN, bool XF32, bool OUTF32>
__global__ void __launch_bounds__(S8Tile<BM, BN>::THREADS, 1)
s8_gemm_qx_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_out, const S8Params p,
                  const QuantJob q) {
  using T = S8Tile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the 16 bytes of flags after the barriers: [0] the ticket, [1] the exit
  // verdict
  int* flags = reinterpret_cast<int*>(smem + p.stages * T::STAGE +
                                      T::NWG * T::OUT_BYTES + 16 * p.stages);
  quant_rows_once<XF32>(q, &flags[0]);
  s8_body<BM, BN, true, OUTF32>(&tm_a, &tm_b, &tm_out, p, q, smem);
  quant_exit(q, &flags[1]);
}

template <int BM, int BN, bool XF32, bool OUTF32>
int qx_launch(const CUtensorMap& ta, const CUtensorMap& tb,
              const CUtensorMap& tout, const S8Params& p, const QuantJob& q,
              cudaStream_t stream) {
  using T = S8Tile<BM, BN>;
  const int smem = T::smem(p.stages);
  auto kernel = s8_gemm_qx_kernel<BM, BN, XF32, OUTF32>;
  static int configured = 0;  // per instantiation
  if (int rc = set_smem_attr(kernel, smem, configured)) return rc;
  kernel<<<s8_grid(p, BM, BN), T::THREADS, smem, stream>>>(ta, tb, tout, p, q);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int qx_dispatch(const CUtensorMap& ta, const CUtensorMap& tb,
                const CUtensorMap& tout, const S8Params& p, const QuantJob& q,
                bool x_f32, bool y_f32, cudaStream_t stream) {
  if (x_f32 && y_f32) return qx_launch<BM, BN, true, true>(ta, tb, tout, p, q, stream);
  if (x_f32) return qx_launch<BM, BN, true, false>(ta, tb, tout, p, q, stream);
  if (y_f32) return qx_launch<BM, BN, false, true>(ta, tb, tout, p, q, stream);
  return qx_launch<BM, BN, false, false>(ta, tb, tout, p, q, stream);
}

}  // namespace

// x (R, K) bf16 (x_f32 = 0) or f32 row-major, unquantized; wt (N, K) int8
// row-major (the transposed storage of the (K, N) weight); s (N,) f32; y (R,
// N) bf16 (y_f32 = 0) or f32. The workspace, kept per device and stream
// (ops/int8_matmul.py): xq (R, K) int8, sx (R,) f32, cnt 2 + ceil(R /
// block_m) int32 counters at 0. K and N are multiples of 16, the bases
// 16-byte aligned. The plan (block_m, block_n, stages) is
// ops/int8_matmul.py's s8_qx_plan.
// Launches one kernel on `stream`; returns a CUDA error code (or 1000 + a
// refused tensor map's CUresult).
extern "C" int thinkdiff_s8_gemm_qx(const void* x, const void* wt,
                                    const void* s, void* y, void* xq, void* sx,
                                    void* cnt, int R, int K, int N,
                                    int block_m, int block_n, int stages,
                                    int x_f32, int y_f32, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
      xq == nullptr || sx == nullptr || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  S8Params p;
  if (!s8_params(p, static_cast<const float*>(sx), static_cast<const float*>(s),
                 y, nullptr, R, N, K, stages, 1))
    return (int)cudaErrorInvalidValue;
  QuantJob q;
  q.x = x;
  q.inv = nullptr;
  q.xq = static_cast<int8_t*>(xq);
  q.sx = static_cast<float*>(sx);
  q.cnt = static_cast<int*>(cnt);
  q.rows = R;
  q.K = K;
  q.tile = block_m;
  CUtensorMap ta, tb, tout;
  int rc;
  if ((rc = cached_map(&ta, true, xq, R, K, block_m)) ||
      (rc = cached_map(&tb, true, wt, N, K, block_n)))
    return rc;
  if (y_f32) tout = ta;  // unused: an f32 output is stored from registers
  else if ((rc = cached_map(&tout, false, y, R, N, 64))) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  if (block_m == 64 && block_n == 128)
    return qx_dispatch<64, 128>(ta, tb, tout, p, q, x_f32, y_f32, st);
  if (block_m == 64 && block_n == 256)
    return qx_dispatch<64, 256>(ta, tb, tout, p, q, x_f32, y_f32, st);
  if (block_m == 128 && block_n == 128)
    return qx_dispatch<128, 128>(ta, tb, tout, p, q, x_f32, y_f32, st);
  if (block_m == 128 && block_n == 256)
    return qx_dispatch<128, 256>(ta, tb, tout, p, q, x_f32, y_f32, st);
  return (int)cudaErrorInvalidValue;
}
