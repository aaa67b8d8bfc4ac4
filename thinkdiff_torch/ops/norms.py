"""Normalization ops (counterpart of thinkdiff_tpu/ops/norms.py).

``rmsnorm`` launches the CUDA kernel of ``csrc/rmsnorm.cu`` on a CUDA
tensor and runs its plain PyTorch version, ``rmsnorm_reference``, on a CPU
tensor. It is differentiable in x and scale: the backward is the plain
gradient of ``rmsnorm_reference`` (recomputed from the saved x and scale),
as JAX's ``_rms_bwd`` is; the Pallas package has no backward kernel for it.
T5LayerNorm is RMSNorm. ``layernorm`` is plain PyTorch on every device.

The kernel replaces the Pallas TPU kernel ``_rmsnorm_kernel``
(thinkdiff_tpu/ops/norms.py). It is bound by bytes: one read of x and one
write of y per row, the reduction in f32 registers (one warp a row,
16-byte loads; see the source).
"""

from __future__ import annotations

import functools

import torch

from thinkdiff_torch import kernels

# the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_KERNEL_WIDTH = 12288  # the f32 scale in 48 KB of shared memory


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def rmsnorm_warps(rows: int, d: int) -> int:
    """Warps of the kernel that share a row (1, 2, 4 or 8), from the shape
    alone: more warps a row where there are few rows, so that rows x warps
    reaches 4096 and enough loads are in flight, but no more warps than
    the row has groups of 64 16-byte vectors (8 bf16 values a vector)."""
    nvec = d // 8
    w = 1
    while w < 8 and rows * w < 4096 and nvec >= 64 * w:
        w *= 2
    return w


def _rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """The kernel: checks, one output allocation, one library call. x is
    taken as rows of its last dimension (a strided x is copied first); the
    scale is read in its own dtype when that is x's, else in f32."""
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if not scale.is_cuda or scale.shape != (d,):
        raise ValueError("rmsnorm kernel: scale must be a (D,) CUDA tensor")
    if d > MAX_KERNEL_WIDTH:
        raise ValueError(f"rmsnorm kernel: width {d} > {MAX_KERNEL_WIDTH}")
    scale_f32 = scale.dtype != x.dtype
    if scale_f32:
        scale = scale.float()
    x, scale = x.contiguous(), scale.contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    rows = x.numel() // d
    rc = kernels.library().thinkdiff_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, eps, code,
        int(scale_f32), rmsnorm_warps(rows, d), kernels.stream_of(x))
    kernels.check_launch(rc, "rmsnorm")
    kernels.count_launch("rmsnorm")
    return y


def _rmsnorm_forward(x, scale, eps):
    if x.is_cuda:
        return _rmsnorm_cuda(x, scale, eps)
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
