"""QDense: a dense layer whose (in, out) kernel may be stored as int8
(counterpart of ``QDense`` in thinkdiff_tpu/models/t5.py).

``quant`` modes:
  False          — float kernel ``kernel`` (in, out) in the layer's dtype.
  True / "int8"  — weight-only int8: ``kernel_q`` (in, out) + per-column
                   ``kernel_scale``. At <= 32 rows (a decode step) the
                   product is the int8 GEMV (ops/int8_matmul ``int8_matmul``:
                   the kernel on the card, its plain version on the CPU);
                   above that the int8 kernel is converted to the layer's
                   dtype, multiplied with ``torch.matmul``, and the scale is
                   applied to the output. The two branches of the JAX
                   QDense, whose GEMV is the Pallas kernel.
  "w8a8"         — weights int8 AND activations quantized per row on the
                   fly; the product runs in the s8 GEMM kernel
                   (ops/int8_matmul). x is first divided by ``input_scale``
                   (SmoothQuant's channel equalizer; ones until calibrated)
                   in the layer's dtype. The backward gives dx only (the
                   weights are frozen), through the s8 input-gradient GEMM.

The weights are frozen in every mode. A w8a8 layer built with
``train_layout=True`` (a model that trains through it) also keeps its int8
kernel as a (K, N) row-major copy, ``kernel_q_kn``: the layout the input-
gradient GEMM reads. It is made from ``kernel_q`` by ``sync_train_layout``
(``bridge.load_params`` calls it after every load) and is not a parameter
of the JAX tree; the serving path never pays for it.

Parameter names and layouts are the JAX ones, so the weight bridge
(models/bridge.py) maps a JAX tree onto a module key for key.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from thinkdiff_torch.ops.int8_matmul import GEMV_ROWS, int8_matmul
from thinkdiff_torch.ops.quant import int8_dynamic_matmul


def _int8_kernel_storage(in_dim: int, features: int, device) -> torch.Tensor:
    """An empty (in, out) int8 kernel laid out as the transpose of a
    row-major (out, in) array: the layout the s8 GEMM kernel reads, so the
    transposed copy it needs is made once, when weights are loaded."""
    return torch.empty(features, in_dim, dtype=torch.int8, device=device).t()


class QDense(nn.Module):
    def __init__(self, in_dim: int, features: int, dtype=torch.float32,
                 quant: Any = False, use_bias: bool = False, device=None,
                 train_layout: bool = False):
        super().__init__()
        self.in_dim, self.features = in_dim, features
        self.dtype = dtype
        self.quant = quant
        self.train_layout = train_layout and quant == "w8a8"
        self.kernel_q_kn = None
        if quant:
            self.register_buffer(
                "kernel_q", _int8_kernel_storage(in_dim, features, device))
            self.register_buffer("kernel_scale", torch.ones(
                features, dtype=torch.float32, device=device))
            if quant == "w8a8":
                self.register_buffer("input_scale", torch.ones(
                    in_dim, dtype=torch.float32, device=device))
        else:
            self.kernel = nn.Parameter(torch.empty(
                in_dim, features, dtype=dtype, device=device),
                requires_grad=False)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                features, dtype=dtype, device=device), requires_grad=False)
        else:
            self.bias = None

    def sync_train_layout(self) -> None:
        """(Re)make the (K, N) row-major copy of ``kernel_q`` of a training
        layer."""
        if self.train_layout:
            self.kernel_q_kn = self.kernel_q.contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.quant == "w8a8":
            xs = x * (1.0 / self.input_scale.to(self.dtype))
            y = int8_dynamic_matmul(xs, self.kernel_q, self.kernel_scale,
                                    self.kernel_q_kn)
        elif self.quant and x.numel() // x.shape[-1] <= GEMV_ROWS:
            y = int8_matmul(x, self.kernel_q, self.kernel_scale,
                            out_dtype=self.dtype)
        elif self.quant:
            y = torch.matmul(x, self.kernel_q.to(self.dtype))
            y = y * self.kernel_scale.to(self.dtype)
        else:
            y = torch.matmul(x, self.kernel)
        if self.bias is not None:
            y = y + self.bias
        return y


def concat_dense_params(nodes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate QDense param dicts along the OUTPUT axis (counterpart of
    ``_concat_dense_params``): fp {kernel[, bias]} or quantized {kernel_q,
    kernel_scale[, input_scale][, bias]}. Per-column scales concatenate
    losslessly; ``input_scale`` is per input and must agree across branches.
    Leaves may be numpy arrays or torch tensors (one kind per call)."""
    import numpy as np

    def cat(vals, axis):
        if isinstance(vals[0], torch.Tensor):
            return torch.cat(vals, dim=axis)
        return np.concatenate(vals, axis=axis)

    first = nodes[0]
    out: Dict[str, Any] = {}
    if "kernel" in first:
        out["kernel"] = cat([n["kernel"] for n in nodes], 1)
    else:
        out["kernel_q"] = cat([n["kernel_q"] for n in nodes], 1)
        out["kernel_scale"] = cat([n["kernel_scale"] for n in nodes], 0)
    if "bias" in first:
        out["bias"] = cat([n["bias"] for n in nodes], 0)
    if "input_scale" in first:
        ref = first["input_scale"]
        for n in nodes[1:]:
            same = (torch.allclose(ref, n["input_scale"], rtol=1e-5)
                    if isinstance(ref, torch.Tensor)
                    else np.allclose(ref, n["input_scale"], rtol=1e-5))
            if not same:
                raise ValueError(
                    "concat_dense_params: branches have diverged input_scale; "
                    "fuse before calibrating")
        out["input_scale"] = ref
    return out
