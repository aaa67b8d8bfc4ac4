"""Normalization ops (counterpart of thinkdiff_tpu/ops/norms.py).

``rmsnorm`` runs a Triton kernel on a CUDA tensor and its plain PyTorch
version, ``rmsnorm_reference``, on a CPU tensor. It is differentiable in x
and scale: the backward is the plain gradient of ``rmsnorm_reference``
(recomputed from the saved x and scale), as JAX's ``_rms_bwd`` is; the
Pallas package has no backward kernel for it. T5LayerNorm is RMSNorm.
``layernorm`` is plain PyTorch on every device.

The Triton kernel replaces the Pallas TPU kernel ``_rmsnorm_kernel``
(thinkdiff_tpu/ops/norms.py). It is bound by bytes: one read of x and one
write of y per row, with the reduction in f32 registers. One program per
row, the whole row in one block (BLOCK = next power of two >= D, masked),
so x is read once and no partial sums leave the program.
"""

from __future__ import annotations

import torch

from thinkdiff_torch import kernels

_triton_kernel = None


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _get_triton_kernel():
    global _triton_kernel
    if _triton_kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, s_ptr, y_ptr, d, eps,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            x = tl.load(x_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / d
            y = x * tl.rsqrt(var + eps)
            s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            tl.store(y_ptr + row * d + cols,
                     (y * s).to(y_ptr.dtype.element_ty), mask=mask)

        _triton_kernel = rmsnorm_kernel
    return _triton_kernel


def _rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    if not scale.is_cuda or scale.shape != (x.shape[-1],):
        raise ValueError("rmsnorm kernel: scale must be a (D,) CUDA tensor")
    import triton

    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    block = triton.next_power_of_2(d)
    _get_triton_kernel()[(x2.shape[0],)](
        x2, scale.contiguous(), y, d, eps, BLOCK=block,
        num_warps=8 if block >= 2048 else 4)
    kernels.count_launch("rmsnorm")
    return y.reshape(x.shape)


def _rmsnorm_forward(x, scale, eps):
    if x.is_cuda:
        return _rmsnorm_triton(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    raise NotImplementedError(f"rmsnorm: no kernel for device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            sr = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rmsnorm_reference(xr, sr, ctx.eps)
            wrt = [t for t in (xr, sr) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g))
        return (next(grads) if xr.requires_grad else None,
                next(grads) if sr.requires_grad else None, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale, in f32, cast to x's dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_forward(x, scale, eps)


# T5LayerNorm == RMSNorm (HF T5LayerNorm has no mean subtraction/bias).
t5_layernorm = rmsnorm


def layernorm(x: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
