"""int8 quantization for frozen weights (counterpart of
thinkdiff_tpu/ops/quant.py): per-output-channel absmax weights, per-row
dynamic activations, the w8a8 product with its dx-only backward, the
size-based and the structure-guided tree quantizers, and SmoothQuant
calibration: per-channel activation maxima of every w8a8 layer
(``collect_act_stats``) folded into its weights and ``input_scale``
(``equalize_quantized_tree``). All arithmetic is f32 on the tensors'
device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from thinkdiff_torch.ops.int8_matmul import (
    s8_matmul, s8_matmul_bwd, s8_matmul_bwd_i32, s8_matmul_i32, s8_scaled)


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


def dequantize_weight(qw) -> torch.Tensor:
    """{q, scale} -> the bf16 (in, out) kernel: q and scale each rounded to
    bf16, their product rounded again (JAX's bf16 arithmetic)."""
    q, scale = _as_tensor(qw["q"]), _as_tensor(qw["scale"])
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)[None]


def _absmax_quant_rows(x: torch.Tensor, reduce_amax=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> per-row absmax int8: (int8 (M, K), f32 scale (M,)).
    ``reduce_amax`` (in place on the (M,) row absmax) makes it the absmax
    of rows split over ranks (a MAX over their group)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    if reduce_amax is not None:
        reduce_amax(amax)
    s = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x32 / s[:, None]), -127, 127).to(torch.int8)
    return q, s


class _Int8DynamicMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale, w_kn, k_reduce, n_reduce, weights):
        shape = x.shape
        xq, sx = _absmax_quant_rows(x.reshape(-1, shape[-1]),
                                    _max_of(k_reduce))
        if k_reduce is None:
            y = s8_matmul(xq, sx, q, scale, x.dtype)
        else:
            y = s8_scaled(k_reduce(s8_matmul_i32(xq, q), "sum"), sx, scale,
                          x.dtype)
        ctx.weights, ctx.n_reduce = weights, n_reduce
        if weights is None:
            ctx.save_for_backward(q if w_kn is None else w_kn, scale)
        return y.reshape(*shape[:-1], q.shape[1])

    @staticmethod
    def backward(ctx, dy):
        w, scale = ctx.weights() if ctx.weights else ctx.saved_tensors
        n_reduce = ctx.n_reduce
        dym = dy.reshape(-1, dy.shape[-1])
        gq, sg = _absmax_quant_rows(dym.float() * scale.float()[None, :],
                                    _max_of(n_reduce))
        if n_reduce is None:
            dx = s8_matmul_bwd(gq, sg, w, dy.dtype)
        else:
            dx = s8_scaled(n_reduce(s8_matmul_bwd_i32(gq, w), "sum"), sg,
                           None, dy.dtype)
        return (dx.reshape(*dy.shape[:-1], w.shape[0]),
                None, None, None, None, None, None)


def _max_of(reduce):
    return None if reduce is None else (lambda a: reduce(a, "max"))


def int8_dynamic_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        w_kn: Optional[torch.Tensor] = None,
                        k_reduce=None, n_reduce=None,
                        weights=None) -> torch.Tensor:
    """w8a8 product: x (..., K) float, quantized per row on the fly; q (K, N)
    int8 with per-column scale (N,). Output in x's dtype.

    The weights are frozen: the backward gives dx only. It folds the column
    scales into dy, requantizes per row and runs the s8 input-gradient GEMM
    over N: dx = f32(sum_n gq[r, n] q[k, n]) * sg[r] (``_w8a8_bwd``).
    ``w_kn`` is q as a (K, N) row-major tensor, the layout that GEMM reads
    (a training QDense keeps one). On the card the backward needs it, or a
    row-major q, and raises otherwise; on the CPU any layout serves.

    On a sharded mesh the operands are a rank's blocks, and the product is
    the one of the whole operands. ``k_reduce(t, op)`` ("sum" or "max", in
    place, returning t) reduces over the group that splits K (a
    row-parallel layer), ``n_reduce`` over the group that splits N (a
    column-parallel layer, whose backward contracts N): there the row
    absmax is the group's MAX, and the kernels' exact int32 sums are added
    over the group before the scales are applied once, as XLA adds JAX's
    int32 dot over a sharded contraction. ``weights()`` returns (w_kn,
    scale) again for the backward, which then saves no weight (a caller
    that gathers them for each use)."""
    return _Int8DynamicMatmul.apply(x, q, scale, w_kn, k_reduce, n_reduce,
                                    weights)


def _quantized_node(leaf_tensor, w8a8: bool) -> Dict[str, torch.Tensor]:
    qw = quantize_weight(leaf_tensor)
    node = {"kernel_q": qw["q"], "kernel_scale": qw["scale"]}
    if w8a8:
        node["input_scale"] = torch.ones(qw["q"].shape[0], dtype=torch.float32,
                                         device=qw["q"].device)
    return node


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
                out.update(_quantized_node(val, w8a8))
            else:
                out[key] = rec(val)
        return out

    return rec(params)


def quantize_like(params: Any, ref_struct: Any) -> Any:
    """Structure-guided quantization: quantize exactly the kernels that the
    quantized model declares as QDense triplets, and pass every other leaf
    (plain dense kernels, norms, embeddings, convs) through. ``ref_struct``
    is the quantized model, or its tree (``bridge.tree_of``: any leaves).
    Unlike ``quantize_tree``'s size rule this loads models that mix QDense
    with plain dense layers (FLUX's and CogVideoX's embedders). Quantized
    leaves are torch tensors on the leaf's device, with an identity
    ``input_scale`` where the reference node has one."""
    from thinkdiff_torch.models.bridge import to_tensor, tree_of

    if isinstance(ref_struct, nn.Module):
        ref_struct = tree_of(ref_struct, lambda _, t: t)

    def rec(p, r):
        if not isinstance(p, dict) or not isinstance(r, dict):
            return p
        out = {}
        for k, v in p.items():
            if k == "kernel" and "kernel_q" in r:
                out.update(_quantized_node(to_tensor(v), "input_scale" in r))
            else:
                out[k] = rec(v, r.get(k))
        return out

    return rec(params, ref_struct)


def w8a8_layers(module: nn.Module) -> Dict[str, nn.Module]:
    """{JAX path ('decoder/layer_0/self_attn/qkv'): layer} of every w8a8
    QDense in ``module`` (the weight bridge's names)."""
    return {name.replace(".", "/"): m for name, m in module.named_modules()
            if getattr(m, "quant", None) == "w8a8"}


def collect_act_stats(module: nn.Module, *args, method=None,
                      stats: Any = None, **kwargs) -> Dict[str, Any]:
    """Run one forward (``module(*args, **kwargs)``, or its method named
    ``method``) without gradients and fold the per-channel |x| maxima of
    every w8a8 layer's divided input ``xs = x * (1 / input_scale)`` (formed
    in the layer's dtype, as its forward forms it; the maximum in f32)
    into ``stats`` with an elementwise max across calls. Forward pre-hooks
    read the inputs, so the layers' forward is unchanged. Returns the tree
    of JAX's ``act_stats`` collection, {path...: {"amax": f32 (in,)}},
    keyed by the JAX module paths."""
    from thinkdiff_torch.models.bridge import flatten, to_tensor, unflatten

    flat = {k[: -len("/amax")]: to_tensor(v)
            for k, v in flatten(stats or {}).items()}

    def hook(path, layer):
        def record(_, args):
            xs = args[0].to(layer.dtype) * (
                1.0 / layer.input_scale.to(layer.dtype))
            amax = xs.float().abs().reshape(-1, layer.in_dim).amax(dim=0)
            prev = flat.get(path)
            flat[path] = amax if prev is None else torch.maximum(prev, amax)
        return record

    handles = [m.register_forward_pre_hook(hook(path, m))
               for path, m in w8a8_layers(module).items()]
    try:
        with torch.no_grad():
            (module if method is None else getattr(module, method))(
                *args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return unflatten({f"{k}/amax": v for k, v in flat.items()})


def equalize_quantized_tree(params: Any, act_stats: Any,
                            alpha: float = 0.5) -> Any:
    """SmoothQuant channel equalization of a quantized tree (JAX's
    function, in f32 on the leaves' device). For each QDense node
    (kernel_q, kernel_scale[, input_scale]) with calibrated maxima
    ``amax_x`` (``collect_act_stats``):

        s_j = max(amax_x_j, 1e-8)^alpha / max(amax_w_j, 1e-8)^(1 - alpha),
        clipped to [1e-4, 1e4], and 1 where amax_x_j <= 0;
        W' = (q * scale) * s[:, None], requantized per output column;
        input_scale' = input_scale * s  (the layer divides x by it).

    The product x'W' equals xW up to the quantization error. Calibrations
    compose in the scales; each pass requantizes the dequantized int8
    weight, adding about one LSB of rounding. A fused node (qkv, kv_fused,
    wi_fused) is one node with one ``input_scale``, equalized as such.
    Leaves may be numpy arrays or torch tensors; the result's equalized
    leaves are torch tensors."""
    from thinkdiff_torch.models.bridge import to_tensor

    def rec(p, s):
        if not isinstance(p, dict):
            return p
        if "kernel_q" in p and isinstance(s, dict) and "amax" in s:
            q = to_tensor(p["kernel_q"])
            amax_x = to_tensor(s["amax"]).to(q.device, torch.float32)
            w = q.float() * to_tensor(p["kernel_scale"]).float()[None, :]
            amax_w = torch.clamp(w.abs().amax(dim=1), min=1e-8)
            s_ch = (torch.pow(torch.clamp(amax_x, min=1e-8), alpha)
                    / torch.pow(amax_w, 1.0 - alpha))
            s_ch = torch.where(amax_x <= 0, torch.ones_like(s_ch),
                               torch.clamp(s_ch, 1e-4, 1e4))
            qw = quantize_weight(w * s_ch[:, None])
            prev = p.get("input_scale")
            prev = (torch.ones_like(s_ch) if prev is None
                    else to_tensor(prev).float())
            return {**p, "kernel_q": qw["q"], "kernel_scale": qw["scale"],
                    "input_scale": prev * s_ch}
        return {k: rec(v, s.get(k) if isinstance(s, dict) else None)
                for k, v in p.items()}

    return rec(params, act_stats)
