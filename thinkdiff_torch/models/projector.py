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


def _as_numpy(v):
    import numpy as np

    return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))


def convert_projector_torch(sd, dtype=None) -> Dict[str, Any]:
    """Reference ``mm_projector`` state dict (a .pth of torch tensors or
    numpy arrays) -> the projector tree as numpy, the JAX package's
    ``convert_projector_torch``: the reference's nn.Sequential(Linear, GELU,
    Linear[, T5LayerNorm]) keys ``mm_projector.<idx>.weight`` map to
    ``layer_i`` in order of appearance (kernels transposed to (in, out)), a
    1-D weight to the trailing ``t5_norm``; a bare ``mm_projector.weight``
    (type ``linear``) to ``layer_0``."""
    by_idx: Dict[int, Dict[str, Any]] = {}
    for key, val in sd.items():
        m = re.match(r"^(?:mm_projector\.)?(?:(\d+)\.)?(weight|bias)$", key)
        if not m:
            continue
        arr = _as_numpy(val)
        if dtype is not None:
            arr = arr.astype(dtype)
        by_idx.setdefault(int(m.group(1) or 0), {})[m.group(2)] = arr
    flat: Dict[str, Any] = {}
    linear_idx = 0
    for idx in sorted(by_idx):
        entry = by_idx[idx]
        w = entry.get("weight")
        if w is not None and w.ndim == 2:
            layer = {"kernel": w.T}
            if "bias" in entry:
                layer["bias"] = entry["bias"]
            flat[f"layer_{linear_idx}"] = layer
            linear_idx += 1
        elif w is not None:
            flat["t5_norm"] = {"weight": w}
    return flat


def export_projector_torch(flat, projector_type: Optional[str] = None,
                           prefix: str = "mm_projector") -> Dict[str, Any]:
    """Inverse of ``convert_projector_torch`` (the JAX package's
    ``export_projector_torch``): a projector tree -> the reference's
    Sequential key layout, numpy leaves. ``projector_type=None`` infers it
    from the tree; ``mlpNx_gelu_t5_norm`` exports only for N <= 2 (the
    reference interleaves a norm after every extra linear beyond that)."""
    arr = _as_numpy
    linear_keys = sorted((k for k in flat if k.startswith("layer_")),
                         key=lambda k: int(k.split("_")[1]))
    if projector_type is None:
        projector_type = (f"mlp{len(linear_keys)}x_gelu"
                          + ("_t5_norm" if "t5_norm" in flat else ""))
    out: Dict[str, Any] = {}
    if projector_type == "linear":
        layer = flat["layer_0"]
        out[f"{prefix}.weight"] = arr(layer["kernel"]).T
        if "bias" in layer:
            out[f"{prefix}.bias"] = arr(layer["bias"])
        return out
    m = re.match(r"^mlp(\d+)x_gelu(_t5_norm)?$", projector_type)
    if not m:
        raise ValueError(f"Unknown projector type: {projector_type}")
    use_norm = m.group(2) is not None
    if use_norm and len(linear_keys) > 2:
        raise ValueError(
            "mlpNx_gelu_t5_norm export only supports N <= 2 (the reference "
            "interleaves norms per extra linear for deeper stacks)")
    idx = 0
    for i, k in enumerate(linear_keys):
        if i > 0:
            idx += 1  # the GELU slot in the reference Sequential
        layer = flat[k]
        out[f"{prefix}.{idx}.weight"] = arr(layer["kernel"]).T
        if "bias" in layer:
            out[f"{prefix}.{idx}.bias"] = arr(layer["bias"])
        idx += 1
    if use_norm:
        out[f"{prefix}.{idx}.weight"] = arr(flat["t5_norm"]["weight"])
    return out
