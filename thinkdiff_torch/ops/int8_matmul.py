"""The w8a8 s8 x s8 GEMMs with their dequantization epilogues (counterparts
of ``_s8_matmul_fused`` and ``_s8_matmul_fused_bwd`` in
thinkdiff_tpu/ops/int8_matmul.py).

forward:        y = out_dtype(f32(sum_k xq[r, k] * w_q[k, n]) * sx[r] * scale[n])
input gradient: dx = out_dtype(f32(sum_n gq[r, n] * w_q[k, n]) * sg[r])

On a CUDA tensor ``s8_matmul`` / ``s8_matmul_bwd`` launch the hand-written
kernels of ``csrc/s8_gemm.cu`` / ``csrc/s8_gemm_bwd.cu``; on a CPU tensor
they run ``s8_matmul_reference`` / ``s8_matmul_bwd_reference``. The
references accumulate in float64, which holds every int32 sum exactly
(K=10240 x 127^2 exceeds f32's 2^24), so the kernels equal them on the card.
"""

from __future__ import annotations

import torch

from thinkdiff_torch import kernels


def s8_matmul_reference(xq, sx, w_q, scale, out_dtype=torch.bfloat16):
    acc = xq.double() @ w_q.double()  # exact integer sums
    return (acc.float() * sx.float()[:, None]
            * scale.float()[None, :]).to(out_dtype)


def s8_matmul_bwd_reference(gq, sg, w_q, out_dtype=torch.bfloat16):
    acc = gq.double() @ w_q.double().t()  # exact integer sums
    return (acc.float() * sg.float()[:, None]).to(out_dtype)


def _transposed_storage(w_q: torch.Tensor) -> torch.Tensor:
    """The (N, K) row-major storage the kernel reads. QDense keeps its (K, N)
    weight as the transpose view of such a copy, made once at load time;
    any other layout is copied here, per call."""
    wt = w_q.t()
    return wt if wt.is_contiguous() else wt.contiguous()


def _s8_matmul_cuda(xq, sx, w_q, scale, out_dtype):
    r, k = xq.shape
    k2, n = w_q.shape
    if k2 != k or sx.shape != (r,) or scale.shape != (n,):
        raise ValueError(f"s8_matmul: bad shapes xq {tuple(xq.shape)} sx "
                         f"{tuple(sx.shape)} w_q {tuple(w_q.shape)} scale "
                         f"{tuple(scale.shape)}")
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("s8_matmul kernel takes int8 xq and w_q")
    if out_dtype != torch.bfloat16:
        raise TypeError("s8_matmul kernel writes bf16")
    if k % 16 or n % 16:
        raise ValueError(f"s8_matmul kernel: K={k} and N={n} must be "
                         "multiples of 16")
    xq = xq.contiguous()
    wt = _transposed_storage(w_q)
    sx = sx.float().contiguous()
    scale = scale.float().contiguous()
    for name, t in (("xq", xq), ("w_q", wt)):
        if t.data_ptr() % 16:
            raise ValueError(f"s8_matmul kernel: {name} is not 16-byte aligned")
    y = torch.empty((r, n), dtype=torch.bfloat16, device=xq.device)
    rc = kernels.library().thinkdiff_s8_gemm(
        kernels.ptr(xq), kernels.ptr(sx), kernels.ptr(wt), kernels.ptr(scale),
        kernels.ptr(y), r, k, n, kernels.stream_of(xq))
    kernels.check_launch(rc, "s8_matmul")
    kernels.count_launch("s8_matmul")
    return y


def s8_matmul(xq, sx, w_q, scale, out_dtype=torch.bfloat16):
    """xq (R, K) int8, sx (R,) f32, w_q (K, N) int8, scale (N,) f32."""
    if xq.is_cuda:
        return _s8_matmul_cuda(xq, sx, w_q, scale, out_dtype)
    if xq.device.type == "cpu":
        return s8_matmul_reference(xq, sx, w_q, scale, out_dtype)
    raise NotImplementedError(f"s8_matmul: no kernel for {xq.device}")


def _s8_matmul_bwd_cuda(gq, sg, w_q, out_dtype):
    r, n = gq.shape
    k, n2 = w_q.shape
    if n2 != n or sg.shape != (r,):
        raise ValueError(f"s8_matmul_bwd: bad shapes gq {tuple(gq.shape)} sg "
                         f"{tuple(sg.shape)} w_q {tuple(w_q.shape)}")
    if gq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("s8_matmul_bwd kernel takes int8 gq and w_q")
    if out_dtype != torch.bfloat16:
        raise TypeError("s8_matmul_bwd kernel writes bf16")
    if n % 16 or k % 2:
        raise ValueError(f"s8_matmul_bwd kernel: N={n} must be a multiple of "
                         f"16 and K={k} even")
    if not w_q.is_contiguous():
        # copying the whole weight on every backward would hide a missing
        # training layout: the caller keeps the copy, made once at load
        raise ValueError("s8_matmul_bwd kernel reads w_q as a (K, N) row-major "
                         "tensor (QDense(train_layout=True) keeps one)")
    gq, w = gq.contiguous(), w_q
    sg = sg.float().contiguous()
    for name, t in (("gq", gq), ("w_q", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"s8_matmul_bwd kernel: {name} is not 16-byte "
                             "aligned")
    dx = torch.empty((r, k), dtype=torch.bfloat16, device=gq.device)
    rc = kernels.library().thinkdiff_s8_gemm_bwd(
        kernels.ptr(gq), kernels.ptr(sg), kernels.ptr(w), kernels.ptr(dx),
        r, k, n, kernels.stream_of(gq))
    kernels.check_launch(rc, "s8_matmul_bwd")
    kernels.count_launch("s8_matmul_bwd")
    return dx


def s8_matmul_bwd(gq, sg, w_q, out_dtype=torch.bfloat16):
    """gq (R, N) int8, sg (R,) f32, w_q (K, N) int8 -> dx (R, K). The
    kernel takes w_q row-major only; the plain version any layout."""
    if gq.is_cuda:
        return _s8_matmul_bwd_cuda(gq, sg, w_q, out_dtype)
    if gq.device.type == "cpu":
        return s8_matmul_bwd_reference(gq, sg, w_q, out_dtype)
    raise NotImplementedError(f"s8_matmul_bwd: no kernel for {gq.device}")
