"""The aligner network, ThinkDiff's only trainable parameters (counterpart
of thinkdiff_tpu/models/projector.py).

Projector types mirror the reference's ``build_vision_projector``:
``linear`` (one dense layer), ``mlpNx_gelu`` (N dense layers with the exact
erf GELU between them), ``mlpNx_gelu_t5_norm`` (the same plus a trailing
T5LayerNorm) and ``identity``.

A projector is functional, as the flax module is: ``init_params`` makes the
parameter tree under the JAX names ({"layer_0": {"kernel" (in, out),
"bias"}, ..., "t5_norm": {"weight"}}), all f32, and ``__call__(params, x)``
computes in the model dtype (each parameter cast to it), so the trainer can
hold f32 master copies and differentiate the tree directly.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from thinkdiff_torch.ops.norms import rmsnorm

Params = Dict[str, Dict[str, torch.Tensor]]


class MLPProjector:
    def __init__(self, out_dim: int, depth: int = 2, use_t5_norm: bool = False,
                 dtype=torch.float32):
        self.out_dim, self.depth = out_dim, depth
        self.use_t5_norm, self.dtype = use_t5_norm, dtype

    def init_params(self, in_dim: int, generator: Optional[torch.Generator],
                    device=None) -> Params:
        """flax's Dense init: lecun-normal kernels (truncated normal, std
        1/sqrt(fan_in)), zero biases; a norm weight of ones."""
        params: Params = {}
        dim = in_dim
        for i in range(self.depth):
            std = (1.0 / dim) ** 0.5 / 0.87962566103423978  # truncnorm(-2, 2) std
            w = torch.empty((dim, self.out_dim), dtype=torch.float32,
                            device=device)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            params[f"layer_{i}"] = {
                "kernel": w,
                "bias": torch.zeros(self.out_dim, dtype=torch.float32,
                                    device=device)}
            dim = self.out_dim
        if self.use_t5_norm:
            params["t5_norm"] = {"weight": torch.ones(
                self.out_dim, dtype=torch.float32, device=device)}
        return params

    def __call__(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.depth):
            if i > 0:
                x = F.gelu(x)
            layer = params[f"layer_{i}"]
            x = F.linear(x, layer["kernel"].to(self.dtype).t(),
                         layer["bias"].to(self.dtype))
        if self.use_t5_norm:
            x = rmsnorm(x, params["t5_norm"]["weight"].to(self.dtype), 1e-6)
        return x


class IdentityProjector:
    def init_params(self, in_dim: int, generator=None, device=None) -> Params:
        return {}

    def __call__(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x


def build_vision_projector(projector_type: str, out_dim: int,
                           dtype=torch.float32) -> Any:
    if projector_type == "linear":
        return MLPProjector(out_dim=out_dim, depth=1, dtype=dtype)
    m = re.match(r"^mlp(\d+)x_gelu(_t5_norm)?$", projector_type)
    if m:
        return MLPProjector(out_dim=out_dim, depth=int(m.group(1)),
                            use_t5_norm=m.group(2) is not None, dtype=dtype)
    if projector_type == "identity":
        return IdentityProjector()
    raise ValueError(f"Unknown projector type: {projector_type}")
