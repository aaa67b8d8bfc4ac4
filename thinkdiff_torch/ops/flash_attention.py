"""Flash attention forward (counterpart of thinkdiff_tpu/ops/flash_attention.py).

On a CUDA tensor ``flash_attention`` launches the hand-written kernel of
``csrc/flash_fwd.cu``; on a CPU tensor it runs ``mha_reference``, the plain
PyTorch attention it is held against. Forward only: the backward kernels
come with the training slice.

Shapes: q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D); Hq % Hkv == 0.
bias: additive, broadcastable to (B, Hq, Tq, Tk) — the kernel reads it
through strides, so a (B, 1, 1, Tk) padding bias is never expanded.
kv_mask: (B, Tk) int, 1 = valid key. q/kv_segment_ids: (B, Tq)/(B, Tk)
int; position i attends j only when their ids are equal.
"""

from __future__ import annotations

from typing import Optional

import torch

from thinkdiff_torch import kernels

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 80, 128)


def mha_reference(q, k, v, bias=None, kv_mask=None, causal: bool = False,
                  sm_scale: Optional[float] = None, q_segment_ids=None,
                  kv_segment_ids=None) -> torch.Tensor:
    """Naive attention in f32: the numerics reference and the CPU path."""
    q_len, head_dim = q.shape[-2], q.shape[-1]
    kv_len = k.shape[-2]
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    num_heads, num_kv_heads = q.shape[1], k.shape[1]
    if num_kv_heads != num_heads:
        rep = num_heads // num_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    if q_segment_ids is not None:
        same = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        s = torch.where(same, s, NEG_INF)
    if causal:
        row = torch.arange(q_len, device=q.device)[:, None]
        col = torch.arange(kv_len, device=q.device)[None, :]
        s = torch.where(row >= col, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int_rows(x: Optional[torch.Tensor], b: int, t: int, name: str):
    if x is None:
        return None
    if x.shape != (b, t):
        raise ValueError(f"flash_attention: {name} must be ({b}, {t}), got "
                         f"{tuple(x.shape)}")
    return x.to(torch.int32).contiguous()


def _flash_attention_cuda(q, k, v, bias, kv_mask, causal, sm_scale,
                          q_segment_ids, kv_segment_ids) -> torch.Tensor:
    b, hq, tq, d = q.shape
    bk, hkv, tk, dk = k.shape
    if (bk, dk) != (b, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bf16 q, k, v")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: segment ids come in pairs")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias = bias.float().expand(b, hq, tq, tk)
        strides = bias.stride()
    kv_mask = _int_rows(kv_mask, b, tk, "kv_mask")
    q_seg = _int_rows(q_segment_ids, b, tq, "q_segment_ids")
    kv_seg = _int_rows(kv_segment_ids, b, tk, "kv_segment_ids")
    out = torch.empty_like(q)
    rc = kernels.library().thinkdiff_flash_fwd(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
        kernels.ptr(bias), *strides, kernels.ptr(kv_mask), kernels.ptr(q_seg),
        kernels.ptr(kv_seg), b, hq, hkv, tq, tk, d, float(sm_scale),
        int(bool(causal)), kernels.stream_of(q))
    kernels.check_launch(rc, "flash_attention_fwd")
    kernels.count_launch("flash_attention_fwd")
    return out


def flash_attention(q, k, v, bias=None, kv_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None) -> torch.Tensor:
    """softmax(q k^T * sm_scale + bias, masked) v, forward only."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, bias, kv_mask, causal,
                                     sm_scale, q_segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, bias, kv_mask, causal, sm_scale,
                             q_segment_ids, kv_segment_ids)
    raise NotImplementedError(f"flash_attention: no kernel for {q.device}")
