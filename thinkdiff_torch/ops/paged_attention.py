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
``csrc/paged_decode.cu``, which reads only each slot's live pages, split
into units of ``paged_plan``'s pages and combined in the same launch; on a
CPU tensor it runs ``paged_attention_reference``, the gather formulation.
A slot of length 0 has no context, and its output is not defined: the
kernel writes zeros there, the gather formulation averages V over the
slot's MP masked pages, and the TPU kernel over its first table page. No
caller reads one: the model's only call (``models/qwen2_vl.py``, the paged
decode step) passes ``cache_len + 1``, after writing this step's entry. The
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


# the kernel's plan (csrc/paged_decode.cu): a ring stage holds PAGED_TOKENS
# tokens (PAGED_TOKENS / page pages) of one kv head's K and V; a work unit
# is a range of a slot's pages, a whole number of stages
PAGED_TOKENS = 64
PAGED_PAGES = (16, 32, 64)  # the page sizes the kernel takes
PAGED_WS = 8 * 128 + 16     # floats of a unit's partial (acc, then m, l)
# a unit's stages at most (measured on an H100: a split's partials and
# combine cost more than they save at 256 and 64 slots of <= 640 tokens, and
# a 2048-token slot is fastest in units of 4-8 stages; chip_smoke.paged_sweep)
PAGED_UNIT_STAGES = 10


def paged_plan(s: int, hkv: int, mp: int, page: int, sms: int = 132) -> int:
    """Pages a work unit of the paged decode kernel, from the
    shapes alone (the lengths stay on the card): each (slot, kv head)'s MP
    pages are cut into the fewest ranges of whole 64-token stages that hold
    at most PAGED_UNIT_STAGES stages each, or, where the (slot, kv head)
    pairs so cut fill less than half the SMs, into as many as fill them
    (one stage a unit at most)."""
    pps = PAGED_TOKENS // page
    stages = -(-mp // pps)
    pairs = s * hkv
    want = -(-stages // PAGED_UNIT_STAGES)
    if pairs * want < sms // 2:
        want = min(stages, max(want, -(-sms // pairs)))
    per = -(-stages // want)
    while -(-stages // per) < want:  # whole stages: the fewest splits >= want
        per -= 1
    return per * pps


# a split's partials and counters (one int a (slot, kv head), left at 0 by
# every launch), per device, stream and shape: allocated at the first call
# of a shape, never per call
_WORKSPACE: dict = {}


def _workspace(device, stream: int, pairs: int, splits: int):
    key = (device.index, stream, pairs, splits)
    got = _WORKSPACE.get(key)
    if got is None:
        got = _WORKSPACE[key] = (
            torch.empty((pairs * splits, PAGED_WS), dtype=torch.float32,
                        device=device),
            torch.zeros((pairs,), dtype=torch.int32, device=device))
    return got


def _paged_args(q, k_pool, v_pool, page_table, lengths, sms):
    """Check the kernel's operands and plan its launch from their shapes
    alone: (pages a unit, splits). Reads no tensor's values."""
    s, h, d = q.shape
    _, hkv, page, d2 = k_pool.shape
    if (v_pool.shape != k_pool.shape or d2 != d or h % hkv
            or page_table.dim() != 2 or page_table.shape[0] != s
            or lengths.shape != (s,)):
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"table {tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError("paged_attention kernel takes bf16 q and pools")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError("paged_attention kernel takes int32 or int64 lengths")
    if any(t.device != q.device for t in (k_pool, v_pool, page_table,
                                          lengths)):
        raise ValueError("paged_attention kernel: every operand on "
                         f"{q.device}")
    if d != 128 or page not in PAGED_PAGES or h // hkv > 8:
        raise ValueError(f"paged_attention kernel: needs D=128 (got {d}), "
                         f"pages of {PAGED_PAGES} tokens (got {page}), <= 8 "
                         f"query heads per kv head (got {h // hkv})")
    mp = page_table.shape[1]
    ppu = paged_plan(s, hkv, mp, page, sms)
    return ppu, -(-mp // ppu)


def _paged_attention_cuda(q, k_pool, v_pool, page_table, lengths, sm_scale):
    from thinkdiff_torch.ops.int8_matmul import _sm_count

    ppu, splits = _paged_args(q, k_pool, v_pool, page_table, lengths,
                              _sm_count(q.device.index))
    s, h, d = q.shape
    p, hkv, page, _ = k_pool.shape
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.contiguous()
    out = torch.empty_like(q)
    stream = kernels.stream_of(q)
    ws, cnt = (_workspace(q.device, stream, s * hkv, splits) if splits > 1
               else (None, None))
    rc = kernels.library().thinkdiff_paged_decode(
        kernels.ptr(q), kernels.ptr(k_pool), kernels.ptr(v_pool),
        kernels.ptr(table), kernels.ptr(lens), kernels.ptr(out),
        kernels.ptr(ws), kernels.ptr(cnt), s, h, hkv, p, page,
        table.shape[1], d, ppu, int(lens.dtype == torch.int64),
        float(sm_scale), stream)
    kernels.check_launch(rc, "paged_attention")
    kernels.count_launch("paged_attention")
    return out


def paged_attention(q, k_pool, v_pool, page_table, lengths,
                    sm_scale: Optional[float] = None):
    """q (S, H, D); pools (P, Hkv, PAGE, D); page_table (S, MP) int;
    lengths (S,) int -> (S, H, D). sm_scale defaults to D^-0.5. A slot of
    length 0 gets an undefined output (zeros from the kernel; see the
    module's docstring)."""
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
