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

On a sharded mesh (parallel/sharding.py) a layer holds its rank's block of
each leaf and knows its placement (``set_placement``): the ``fsdp``
dimension is gathered for the product and dropped after it, and gathered
again for the backward, so no saved tensor keeps a gathered weight; a
layer split over ``model`` is column parallel (its output columns: its
share is the rank's columns, the input gradient a SUM over the model
group) or row parallel (its input rows: the product a SUM over the
group). A float partial is formed and summed in f32 and rounded once. A
w8a8 layer gives the unsharded layer's bits: where its row quantization
spans a sharded axis (a row-parallel input, a column-parallel layer's
output gradient) the row absmax is the MAX over the group, and the
partial products are the kernels' exact int32 sums (their int32 mode),
added over the group before the scales are applied once, as XLA adds
JAX's int32 dot over a sharded contraction. Every w8a8 product, sharded
or not, is ``ops/quant.int8_dynamic_matmul`` (a sharded layer passes it
the group's reductions); every float or weight-only one is
``_float_product``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch
from torch import nn

from thinkdiff_torch.ops.int8_matmul import GEMV_ROWS, int8_matmul
from thinkdiff_torch.ops.quant import int8_dynamic_matmul
from thinkdiff_torch.parallel import collectives as col
from thinkdiff_torch.parallel.mesh import FSDP_AXIS, MODEL_AXIS
from thinkdiff_torch.parallel.sharding import (
    Placement, arrange_parts, unarrange_parts)


def _int8_kernel_storage(in_dim: int, features: int, device) -> torch.Tensor:
    """An empty (in, out) int8 kernel laid out as the transpose of a
    row-major (out, in) array: the layout the s8 GEMM kernel reads, so the
    transposed copy it needs is made once, when weights are loaded."""
    return torch.empty(features, in_dim, dtype=torch.int8, device=device).t()


class QDense(nn.Module):
    # the width of the columns a column-parallel share must keep whole (an
    # attention projection's head size; set by the model), and a fused
    # layer's part widths where they are not equal (set by the model)
    tp_unit = 1
    tp_widths = None
    # no placement: the unsharded layer
    tp_role = None
    tp_local = False
    sharded = False

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
        layer (of the rank's block, on a sharded mesh)."""
        if self.train_layout:
            self.kernel_q_kn = self.kernel_q.contiguous()

    # -- a sharded mesh ------------------------------------------------------
    def set_placement(self, pls, mesh) -> None:
        """This layer's leaves' placements {leaf: Placement} on ``mesh``
        (parallel/sharding.py): its role over ``model``, the dimension its
        kernel's ``fsdp`` block splits, and whether a column share is
        self-contained (whole units, or a fused leaf arranged by part) so
        that its consumer can take it as it is."""
        kpl = pls["kernel_q" if self.quant else "kernel"]
        spec = kpl.spec + (None, None)
        self.placement, self.mesh = pls, mesh
        self.sharded = any(a is not None for pl in pls.values()
                           for a in pl.spec)
        self.tp_role = ("col" if spec[1] == MODEL_AXIS else
                        "row" if spec[0] == MODEL_AXIS else None)
        self.fsdp_dim = (spec.index(FSDP_AXIS) if FSDP_AXIS in spec[:2]
                         else None)
        # a fused leaf's share is self-contained only where it is arranged
        # by part (whole heads of every part)
        self.tp_parts = kpl.widths
        self.tp_local = self.tp_role == "col" and (
            bool(self.tp_parts) or not kpl.fused and self.features % (
                mesh.model * self.tp_unit) == 0)
        self.sync_train_layout()

    def _leaf(self, name: str) -> torch.Tensor:
        """A leaf with its ``fsdp`` block gathered (the rank's model block,
        or the whole leaf where nothing splits it over ``model``)."""
        t = getattr(self, name)
        return col.fsdp_gather(t, self.placement[name].dim_of(FSDP_AXIS))

    def _weight(self, cols, kn: bool = False) -> torch.Tensor:
        """The kernel (``kernel`` or ``kernel_q``; with ``kn`` the (K, N)
        row-major int8 copy) gathered over ``fsdp``, narrowed to ``cols``
        (start, width) of its output columns."""
        if not self.quant:
            w = self._leaf("kernel")
        elif kn:
            w = col.fsdp_gather(self.kernel_q_kn, self.fsdp_dim)
        else:
            # gather the (N, K) storage the forward kernel reads
            w = col.fsdp_gather(
                self.kernel_q.t(), None if self.fsdp_dim is None
                else 1 - self.fsdp_dim).t()
        if cols is not None:
            w = w.narrow(1, *cols)
            if kn:
                w = w.contiguous()
        return w

    def fsdp_gathered(self) -> "QDense":
        """This layer with its ``fsdp`` blocks gathered once (a copy that
        shares nothing it changes): for a caller that runs it a
        data-dependent number of times, e.g. the lm_head over token
        chunks, whose ``fsdp`` peers' counts may differ."""
        if not self.sharded or col.fsdp_size() == 1:
            return self
        g = copy.copy(self)
        g._parameters, g._buffers = dict(self._parameters), dict(self._buffers)
        for name in list(g._parameters) + list(g._buffers):
            t = getattr(self, name)
            if t is None:
                continue
            if name == "kernel_q":
                full = self._weight(None)
            else:
                full = self._leaf(name)
            (g._parameters if name in g._parameters else g._buffers)[name] = (
                nn.Parameter(full, requires_grad=False)
                if name in g._parameters else full)
        g.placement = {
            k: Placement(pl.shape, tuple(None if a == FSDP_AXIS else a
                                         for a in pl.spec),
                         pl.parts_dim, pl.widths, pl.fused)
            for k, pl in self.placement.items()}
        g.fsdp_dim = None
        if self.train_layout:
            g.kernel_q_kn = self._weight(None, kn=True)
        return g

    def _scale(self, cols) -> torch.Tensor:
        s = self._leaf("kernel_scale")
        return s if cols is None else s.narrow(0, *cols)

    def _sharded_forward(self, x, keep_local: bool, cols):
        role = "col" if cols is not None else self.tp_role
        m = col.model_size()
        if role == "row" and x.shape[-1] == self.in_dim and m > 1:
            # a whole input: this rank's rows of it (their gradient, zero
            # elsewhere, is summed over the group into the whole one's)
            k = self.in_dim // m
            x = col.copy_to_model(x).narrow(-1, col.model_index() * k, k)
        if self.quant == "w8a8":
            s_in = self._leaf("input_scale")
            x = x * (1.0 / s_in.to(self.dtype))
            split = col.model_all_reduce if m > 1 else None
            y = int8_dynamic_matmul(
                x, self._weight(cols), self._scale(cols),
                k_reduce=split if role == "row" else None,
                n_reduce=split if role == "col" else None,
                weights=lambda: (self._weight(cols, kn=self.train_layout),
                                 self._scale(cols)))
        else:
            y = _ShardedDense.apply(x, self, role, cols)
        if self.bias is not None:
            b = self.bias  # replicated: the rank's columns of it
            if role == "col" and cols is not None:
                b = b.narrow(0, *cols)
            elif role == "col":
                if self.tp_parts:
                    b = arrange_parts(b, 0, self.tp_parts, m)
                b = b.narrow(0, col.model_index() * y.shape[-1], y.shape[-1])
            y = y + b
        if role == "col" and cols is None and not (keep_local
                                                   and self.tp_local):
            y = col.gather_from_model(y, -1)
            if self.tp_parts:
                y = unarrange_parts(y, y.dim() - 1, self.tp_parts, m)
        return y

    def forward(self, x: torch.Tensor, keep_local: bool = False,
                cols=None) -> torch.Tensor:
        """``x`` (..., in) -> (..., out). On a sharded mesh: ``keep_local``
        lets a column-parallel layer whose share is self-contained
        (``tp_local``) return the rank's columns, else they are gathered;
        ``cols`` (start, width) computes only those output columns of a
        layer not split over ``model``, as a column-parallel share (the
        input gradient summed over the model group)."""
        x = x.to(self.dtype)
        if cols is not None or (self.sharded and
                                col.model_size() * col.fsdp_size() > 1):
            if not hasattr(self, "placement"):
                raise ValueError("QDense: cols= is a placed layer's")
            return self._sharded_forward(x, keep_local, cols)
        if self.quant == "w8a8":
            xs = x * (1.0 / self.input_scale.to(self.dtype))
            y = int8_dynamic_matmul(xs, self.kernel_q, self.kernel_scale,
                                    self.kernel_q_kn)
        elif self.quant:
            y = _float_product(x, self.kernel_q, self.kernel_scale, self.dtype)
        else:
            y = _float_product(x, self.kernel, None, self.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y


def _float_product(x, w, scale, dtype, reduce=None):
    """x (..., K) @ w (K, N) of a float or weight-only int8 QDense (an int8
    ``w`` with its column ``scale``): at <= GEMV_ROWS rows the int8 GEMV,
    above it the kernel in ``dtype`` and the scale on the output. With
    ``reduce`` (``model_all_reduce``: K is split over the model group) the
    partial product is formed and summed in f32 and rounded once."""
    if reduce is not None:
        y = x.float() @ w.float()
        if scale is not None:
            y = y * scale.float()[None]
        return reduce(y, "sum").to(dtype)
    if scale is None:
        return torch.matmul(x, w)
    if x.numel() // x.shape[-1] <= GEMV_ROWS:
        return int8_matmul(x, w, scale, out_dtype=dtype)
    return torch.matmul(x, w.to(dtype)) * scale.to(dtype)


class _ShardedDense(torch.autograd.Function):
    """A sharded float or weight-only int8 QDense's product and its input
    gradient (the weights are frozen). Nothing of the gathered weight is
    saved: the backward gathers it again. (An unsharded layer's product is
    plain autograd: a caller may differentiate its kernel, as LoRA does
    through ``functional_call``.)"""

    @staticmethod
    def forward(ctx, x, layer, role, cols):
        ctx.layer, ctx.role, ctx.cols = layer, role, cols
        ctx.x_shape = x.shape
        row = role == "row" and col.model_size() > 1
        y = _float_product(x.reshape(-1, x.shape[-1]), layer._weight(cols),
                           layer._scale(cols) if layer.quant else None,
                           layer.dtype, col.model_all_reduce if row else None)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        layer, cols = ctx.layer, ctx.cols
        dtype = layer.dtype
        split_n = ctx.role == "col" and col.model_size() > 1
        g = dy.reshape(-1, dy.shape[-1])
        w = layer._weight(cols)
        if layer.quant:
            g = g * layer._scale(cols).to(dtype)[None, :]
            w = w.to(dtype)
        dx = _float_product(g, w.t(), None, dtype,
                            col.model_all_reduce if split_n else None)
        return dx.reshape(ctx.x_shape), None, None, None


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
