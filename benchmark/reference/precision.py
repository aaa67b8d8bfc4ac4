"""The precision the references compute their products in.

``Products("fp32")``: every product in float32 (TF32 off). ``Products("fp8")``
is the control: the same products with both operands rounded to float8
e4m3 first (activations by one scale a tensor, weights by one scale an
output channel, each scale mapping the absolute maximum to 448), then
multiplied in float32: the arithmetic of an fp8 deployment of a bf16
model."""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor (``dim`` None) or
    per-slice scale, returned in float32."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True)).float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def linear(self, x, w, b=None):
        """x @ w.T + b, w (out, in)."""
        w = w.float()
        if self.mode == "fp8":
            x, w = fp8_round(x), fp8_round(w, dim=1)
        y = x.float() @ w.t()
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        """a @ b of two activations (attention's products)."""
        if self.mode == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return a.float() @ b.float()

    def conv(self, x, w, b, padding):
        w = w.float()
        if self.mode == "fp8":
            x, w = fp8_round(x), fp8_round(w, dim=(1, 2, 3))
        return F.conv2d(x.float(), w, b.float(), padding=padding)
