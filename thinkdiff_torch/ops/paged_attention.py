"""Paged KV-cache attention and the page-pool updates (counterpart of
thinkdiff_tpu/ops/paged_attention.py).

Layout, as in the JAX package:

  k_pool, v_pool : (P, Hkv, PAGE, D). Page 0 is the TRASH page: writes of
                   finished and padded slots land there, and no slot reads
                   it as context.
  page_table     : (S, MP) int32, the ordered page ids of each decode slot;
                   entries past a slot's ceil(len / PAGE) pages hold 0.
  lengths        : (S,) int32, valid KV entries per slot, this step's
                   included.

On a CUDA tensor ``paged_attention`` launches the hand-written kernel of
``csrc/paged_decode.cu``, which reads only each slot's live pages; on a CPU
tensor it runs ``paged_attention_reference``, the gather formulation. The
JAX package's slot-count dispatch threshold (the kernel at >= 128 slots,
measured on a TPU) is not carried over. The pool updates write in place
(the JAX versions return updated copies).
"""

from __future__ import annotations

from typing import Optional

import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops.decode_attention import decode_attention


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              sm_scale: Optional[float] = None):
    """Gather each slot's MP pages into a contiguous cache and run
    ``decode_attention`` over it. q (S, H, D) -> (S, H, D)."""
    s, _, d = q.shape
    _, hkv, page, _ = k_pool.shape
    mp = page_table.shape[1]
    table = page_table.long()
    k = k_pool[table].transpose(1, 2).reshape(s, hkv, mp * page, d)
    v = v_pool[table].transpose(1, 2).reshape(s, hkv, mp * page, d)
    return decode_attention(q[:, :, None], k, v, lengths, sm_scale)[:, :, 0]


def _paged_attention_cuda(q, k_pool, v_pool, page_table, lengths, sm_scale):
    s, h, d = q.shape
    p, hkv, page, d2 = k_pool.shape
    if (v_pool.shape != k_pool.shape or d2 != d or h % hkv
            or page_table.shape[0] != s or lengths.shape != (s,)):
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"table {tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError("paged_attention kernel takes bf16 q and pools")
    if d != 128 or page > 64 or h // hkv > 8:
        raise ValueError(f"paged_attention kernel: needs D=128 (got {d}), "
                         f"page <= 64 (got {page}), <= 8 query heads per kv "
                         f"head (got {h // hkv})")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = kernels.library().thinkdiff_paged_decode(
        kernels.ptr(q), kernels.ptr(k_pool), kernels.ptr(v_pool),
        kernels.ptr(table), kernels.ptr(lens), kernels.ptr(out), s, h, hkv,
        page, table.shape[1], d, float(sm_scale), kernels.stream_of(q))
    kernels.check_launch(rc, "paged_attention")
    kernels.count_launch("paged_attention")
    return out


def paged_attention(q, k_pool, v_pool, page_table, lengths,
                    sm_scale: Optional[float] = None):
    """q (S, H, D); pools (P, Hkv, PAGE, D); page_table (S, MP) int;
    lengths (S,) int -> (S, H, D). sm_scale defaults to D^-0.5."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _paged_attention_cuda(q, k_pool, v_pool, page_table, lengths,
                                     sm_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths, sm_scale)
    raise NotImplementedError(f"paged_attention: no kernel for {q.device}")


def paged_update_kv(k_pool, v_pool, k_new, v_new, page_table, cache_len):
    """Write ONE new KV entry per slot at position ``cache_len[s]``, in
    place. k_new/v_new: (S, Hkv, 1, D) or (S, Hkv, D). The page index is
    clamped to MP - 1, so a position past a slot's allocation lands on the
    page its table row names there: the trash page 0 for a slot holding
    fewer than MP pages. Only page 0 may receive several writes in one call
    (slots own disjoint pages). Returns (k_pool, v_pool)."""
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, :, 0], v_new[:, :, 0]
    page = k_pool.shape[2]
    mp = page_table.shape[1]
    cache_len = cache_len.long()
    pg = torch.clamp(cache_len // page, max=mp - 1)
    off = cache_len % page
    pids = torch.gather(page_table.long(), 1, pg[:, None])[:, 0]
    k_pool[pids, :, off] = k_new.to(k_pool.dtype)
    v_pool[pids, :, off] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def commit_pages(pool, dense, page_rows):
    """Scatter a dense prefill cache into the pool page-row-wise, in place.

    pool (P, Hkv, PAGE, D); dense (m, Hkv, pad, D) with pad % PAGE == 0;
    page_rows (m * pad // PAGE,) destination page ids in (slot, page) order,
    0 (trash) for rows past a slot's page count. Returns the pool."""
    m, hkv, pad, d = dense.shape
    page = pool.shape[2]
    rows = dense.reshape(m, hkv, pad // page, page, d).transpose(1, 2)
    pool[page_rows.long()] = rows.reshape(m * (pad // page), hkv, page,
                                          d).to(pool.dtype)
    return pool
