"""KV-cache attention for autoregressive decode (counterpart of
thinkdiff_tpu/ops/decode_attention.py): the dense static-cache formulation
with length masking, in plain PyTorch on every device. The paged kernel
that serves many slots comes with the paged scheduler.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, cache_len, sm_scale=None):
    """Attention of Tq new queries against a static KV cache.

    q: (B, H, Tq, D); k_cache, v_cache: (B, Hkv, S, D); cache_len: (B,) int,
    the valid positions per sequence after this step: query i attends to
    positions < cache_len - Tq + i + 1.
    """
    b, h, tq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    group = h // hkv
    qg = q.reshape(b, hkv, group, tq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k_cache.float()) * sm_scale
    pos = torch.arange(s, device=q.device)[None, None, :]
    qidx = torch.arange(tq, device=q.device)[None, :, None]
    limit = cache_len.to(q.device)[:, None, None] - tq + qidx + 1  # (B, Tq, 1)
    mask = pos < limit                                             # (B, Tq, S)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v_cache.float())
    return out.reshape(b, h, tq, d).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, cache_len):
    """Write the Tq new entries of each sequence at positions
    cache_len[b] .. cache_len[b] + Tq - 1, IN PLACE (the JAX version returns
    updated copies; here the caches are overwritten to save their memory).

    k_new, v_new: (B, Hkv, Tq, D). Returns (k_cache, v_cache, cache_len + Tq).
    """
    b, tq = k_new.shape[0], k_new.shape[2]
    rows = torch.arange(b, device=k_cache.device)[:, None]
    cols = cache_len.to(k_cache.device)[:, None] + torch.arange(
        tq, device=k_cache.device)[None, :]
    # advanced indices on dims 0 and 2 put (B, Tq) first: (B, Tq, Hkv, D)
    k_cache[rows, :, cols] = k_new.transpose(1, 2).to(k_cache.dtype)
    v_cache[rows, :, cols] = v_new.transpose(1, 2).to(v_cache.dtype)
    return k_cache, v_cache, cache_len + tq
