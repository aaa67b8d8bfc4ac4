"""int8 quantization for frozen weights (counterpart of
thinkdiff_tpu/ops/quant.py): per-output-channel absmax weights, per-row
dynamic activations, and the w8a8 forward. Inference only: the backward
comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from thinkdiff_torch.ops.int8_matmul import s8_matmul


def _as_tensor(w) -> torch.Tensor:
    return torch.from_numpy(np.asarray(w)) if isinstance(w, np.ndarray) else w


def quantize_weight(w) -> Dict[str, torch.Tensor]:
    """(in, out) kernel (numpy or torch, any device) -> {q: int8 (in, out),
    scale: f32 (out,)}: absmax / 127 per column, 1 for an all-zero column,
    round half to even, clip to +-127."""
    w = _as_tensor(w).float()
    scale = w.abs().amax(dim=0) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _absmax_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> per-row absmax int8: (int8 (M, K), f32 scale (M,))."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x32 / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def int8_dynamic_matmul(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """w8a8 forward: x (..., K) float, quantized per row on the fly; q (K, N)
    int8 with per-column scale (N,). Output in x's dtype."""
    shape = x.shape
    xq, sx = _absmax_quant_rows(x.reshape(-1, shape[-1]))
    y = s8_matmul(xq, sx, q, scale, x.dtype)
    return y.reshape(*shape[:-1], q.shape[1])


def quantize_tree(params: Any, min_size: int = 1 << 16,
                  w8a8: bool = False) -> Any:
    """Quantize every 2-D 'kernel' leaf of at least ``min_size`` elements to
    sibling leaves ``kernel_q`` (int8) + ``kernel_scale`` (f32), on the
    leaf's device; with ``w8a8`` an identity ``input_scale`` is added. Other
    leaves pass through. Quantized leaves are torch tensors."""

    def rec(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if (key == "kernel" and not isinstance(val, dict)
                    and val.ndim == 2 and val.shape[0] * val.shape[1] >= min_size):
                qw = quantize_weight(val)
                out["kernel_q"] = qw["q"]
                out["kernel_scale"] = qw["scale"]
                if w8a8:
                    out["input_scale"] = torch.ones(
                        val.shape[0], dtype=torch.float32,
                        device=qw["q"].device)
            else:
                out[key] = rec(val)
        return out

    return rec(params)
