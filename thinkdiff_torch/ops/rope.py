"""Rotary position embeddings: standard RoPE and Qwen2-VL's multimodal
3D M-RoPE (counterpart of thinkdiff_tpu/ops/rope.py).

Plain PyTorch elementwise math on every device.

M-RoPE: the head dim is split into three sections (``mrope_section`` in
half dims, e.g. (16, 24, 24) for head_dim 128) and each section takes its
cos/sin from the t/h/w position ids respectively.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-rotation RoPE. q, k: (..., T, head_dim); cos/sin broadcastable
    to (..., T, head_dim // 2). Math in the promoted dtype (f32 tables),
    results cast back to q's and k's dtypes."""
    cos2 = torch.cat([cos, cos], dim=-1)
    sin2 = torch.cat([sin, sin], dim=-1)
    q_out = q * cos2 + _rotate_half(q) * sin2
    k_out = k * cos2 + _rotate_half(k) * sin2
    return q_out.to(q.dtype), k_out.to(k.dtype)


def rope_from_positions(positions: torch.Tensor, head_dim: int,
                        theta: float = 10000.0):
    """cos/sin for integer positions (..., T) -> (..., T, head_dim // 2) f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int,
                  mrope_section: Sequence[int], theta: float = 1000000.0):
    """position_ids (3, B, T) stacked (t, h, w) -> cos/sin (B, T, head_dim//2)
    with each section taken from its axis type."""
    if position_ids.shape[0] != 3 or sum(mrope_section) != head_dim // 2:
        raise ValueError("mrope_cos_sin: need (3, B, T) ids and sections "
                         "summing to head_dim // 2")
    cos_all, sin_all = rope_from_positions(position_ids, head_dim, theta)
    chunks_cos, chunks_sin = [], []
    start = 0
    for i, size in enumerate(mrope_section):
        chunks_cos.append(cos_all[i % 3, ..., start:start + size])
        chunks_sin.append(sin_all[i % 3, ..., start:start + size])
        start += size
    return torch.cat(chunks_cos, dim=-1), torch.cat(chunks_sin, dim=-1)
