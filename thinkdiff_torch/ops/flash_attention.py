"""Flash attention, forward and backward (counterpart of
thinkdiff_tpu/ops/flash_attention.py).

On CUDA tensors ``flash_attention`` launches the hand-written kernels:
the forward of ``csrc/flash_fwd.cu`` and, when a gradient is needed, the
FlashAttention-2 backward of ``csrc/flash_bwd.cu`` (a dq kernel that also
computes delta, then a dk/dv kernel), all wgmma on TMA-fed tiles, inside a
``torch.autograd.Function``. On CPU tensors it runs the plain versions they
are held against: ``mha_reference`` for the forward and
``flash_attention_backward_reference`` for the backward.

Shapes: q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D); Hq % Hkv == 0. The forward
takes q, k and v through their strides (head-transposed views of (B, T, H,
D) projections go in without a copy) and returns a (B, Hq, Tq, D) view of
(B, Tq, Hq, D) memory, so the caller's ``transpose(1, 2).reshape(...)`` is
free. The backward takes q, k, v and dO the same way and returns dq, dk
and dv as such views. bias: additive, broadcastable to (B, Hq, Tq, Tk) —
the kernels read it through strides, so a (B, 1, 1, Tk) padding bias or
T5's (1, H, T, T) relative bias is never expanded. It gets no gradient:
the bias is frozen on every training path (T5's relative-position table),
and a bias that requires grad raises. kv_mask: (B, Tk) int, 1 = valid key.
q/kv_segment_ids: (B, Tq)/(B, Tk) int; position i attends j only when their
ids are equal.

The backward recomputes P = exp(S - lse) from the forward's natural-log
logsumexp (B, Hq, Tq) f32 and takes delta = rowsum(P * dP), as the Pallas
kernels do, so the attention output is not kept for the backward. A masked
pair has P = 0: a query row whose keys are all masked (the pad rows of a
packed cross-attention) gets dq = 0 and adds exactly 0 to dk and dv.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from thinkdiff_torch import kernels

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 80, 88, 128)
BACKWARD_HEAD_DIMS = (64, 128)


def _allowed(q, k, kv_mask, causal, q_segment_ids, kv_segment_ids):
    """Boolean (B|1, 1, Tq|1, Tk) mask of the pairs that may attend, or None."""
    ok = None

    def both(a, b):
        return b if a is None else a & b

    if kv_mask is not None:
        ok = both(ok, kv_mask[:, None, None, :] > 0)
    if q_segment_ids is not None:
        ok = both(ok, q_segment_ids[:, None, :, None]
                  == kv_segment_ids[:, None, None, :])
    if causal:
        row = torch.arange(q.shape[-2], device=q.device)[:, None]
        col = torch.arange(k.shape[-2], device=q.device)[None, :]
        ok = both(ok, row >= col)
    return ok


def _repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    rep = num_heads // x.shape[1]
    return x if rep == 1 else x.repeat_interleave(rep, dim=1)


def _scores(q, k, bias, ok, sm_scale):
    """f32 scores with masked pairs at NEG_INF."""
    k = _repeat_kv(k, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if ok is not None:
        s = torch.where(ok, s, NEG_INF)
    return s


def mha_reference(q, k, v, bias=None, kv_mask=None, causal: bool = False,
                  sm_scale: Optional[float] = None, q_segment_ids=None,
                  kv_segment_ids=None) -> torch.Tensor:
    """Naive attention in f32: the numerics reference and the CPU path."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    ok = _allowed(q, k, kv_mask, causal, q_segment_ids, kv_segment_ids)
    p = torch.softmax(_scores(q, k, bias, ok, sm_scale), dim=-1)
    v = _repeat_kv(v, q.shape[1])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def logsumexp_reference(q, k, bias=None, kv_mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None, q_segment_ids=None,
                        kv_segment_ids=None) -> torch.Tensor:
    """(B, Hq, Tq) f32 natural-log logsumexp of the masked scores: what the
    forward kernel saves for the backward."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    ok = _allowed(q, k, kv_mask, causal, q_segment_ids, kv_segment_ids)
    return torch.logsumexp(_scores(q, k, bias, ok, sm_scale), dim=-1)


def _probs(q, k, bias, kv_mask, causal, sm_scale, q_segment_ids,
           kv_segment_ids, lse):
    """P = exp(S - lse), 0 where masked (f32, (B, Hq, Tq, Tk))."""
    ok = _allowed(q, k, kv_mask, causal, q_segment_ids, kv_segment_ids)
    p = torch.exp(_scores(q, k, bias, ok, sm_scale) - lse.float()[..., None])
    return p if ok is None else torch.where(ok, p, 0.0)


def flash_dq_reference(q, k, v, bias, kv_mask, causal, sm_scale,
                       q_segment_ids, kv_segment_ids, lse, do):
    """The dq kernel's function as plain PyTorch: (dq, delta) with
    dP = dO V^T, delta = rowsum(P * dP), dq = scale (P * (dP - delta)) K."""
    p = _probs(q, k, bias, kv_mask, causal, sm_scale, q_segment_ids,
               kv_segment_ids, lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      _repeat_kv(v, q.shape[1]).float())
    delta = (p * dp).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      _repeat_kv(k, q.shape[1]).float()) * sm_scale
    return dq.to(q.dtype), delta


def flash_dkv_reference(q, k, v, bias, kv_mask, causal, sm_scale,
                        q_segment_ids, kv_segment_ids, lse, do, delta):
    """The dk/dv kernel's function as plain PyTorch, from the dq kernel's
    delta: dk = scale dS^T Q, dv = P^T dO, summed over a GQA group."""
    p = _probs(q, k, bias, kv_mask, causal, sm_scale, q_segment_ids,
               kv_segment_ids, lse)
    hq, hkv = q.shape[1], k.shape[1]
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _repeat_kv(v, hq).float())
    ds = p * (dp - delta.float()[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if hkv != hq:
        b, _, tk, d = k.shape
        dk = dk.reshape(b, hkv, hq // hkv, tk, d).sum(2)
        dv = dv.reshape(b, hkv, hq // hkv, tk, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, bias, kv_mask, causal,
                                       sm_scale, q_segment_ids,
                                       kv_segment_ids, lse, do):
    """The backward as plain PyTorch: (dq, dk, dv) from the inputs, the
    saved lse and the output gradient, with the FA2 formulas the kernels
    use: P = exp(S - lse) (0 where masked), dP = dO V^T, delta =
    rowsum(P * dP), dS = P * (dP - delta), dq = scale dS K, dk = scale
    dS^T Q, dv = P^T dO, dk and dv summed over a GQA group. f32 inside,
    outputs in the input dtypes."""
    args = (q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
            kv_segment_ids, lse, do)
    dq, delta = flash_dq_reference(*args)
    return (dq, *flash_dkv_reference(*args, delta))


def _int_rows(x: Optional[torch.Tensor], b: int, t: int, name: str):
    if x is None:
        return None
    if x.shape != (b, t):
        raise ValueError(f"flash_attention: {name} must be ({b}, {t}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        x = x.to(torch.int32).contiguous()
    return x


SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
# the most a block may use for two to share an SM (228 KB, 1 KB reserved
# a block)
TWO_PER_SM = 233472 // 2 - 1024
MAX_STAGES = 8       # the deepest k/v ring the kernel takes
_SHAPE = ctypes.c_longlong * 10    # the kernels' shape argument
_STRIDES = ctypes.c_longlong * 15  # the forward's strides
_BWD_STRIDES = ctypes.c_longlong * 21  # the backward's


def flash_fwd_smem(d: int, block_q: int, block_k: int, stages: int,
                   bias: Optional[str], kv_mask: bool, segments: bool) -> int:
    """Shared memory of the forward kernel (``Plan`` in csrc/flash_fwd.cu):
    q, ``stages`` k/v tiles (rows cut in 64-column chunks of 128 bytes), the
    bias tiles ("tile": f32, BK/32 boxes of 32 x BQ) or rows ("row"), the
    kv_mask and key-segment rows, the barriers, and 1024 bytes of
    alignment."""
    nch = -(-d // 64)
    bias_bytes = {"tile": block_k // 32 * block_q * 128, "row": 1024,
                  None: 0}[bias]
    vec = block_k * 4 * (int(kv_mask) + int(segments))
    return (nch * block_q * 128
            + stages * (2 * nch * block_k * 128 + bias_bytes + vec)
            + (2 + 2 * stages) * 8 + 1024)


@functools.lru_cache(maxsize=None)
def flash_fwd_tiles(tq: int, d: int, bias: Optional[str] = None,
                    kv_mask: bool = False, segments: bool = False) -> tuple:
    """(block_q, block_k, stages) of the forward kernel for a call, from its
    shapes alone: 128 query rows (two consumer warpgroups), 192 (three) for
    the vision towers' D = 80 and 88 past 128 rows, and 64 where the call
    has at most 64 rows (T5's greedy decode, Tq <= 32); 128 keys a
    tile at D = 64, else 64 (D = 128: the registers; D = 80 and 88:
    measured faster on an H100, see PERF.md); as deep a
    ring of k/v stages as fits in shared memory, 2 to 8 (the copies run
    that far ahead of the math). ``bias`` is None, "row" (no query axis)
    or "tile"."""
    block_q = 64 if tq <= 64 else 192 if d in (80, 88) and tq > 128 else 128
    block_k = 128 if d == 64 else 64
    stages = max([2] + [s for s in range(3, MAX_STAGES + 1) if flash_fwd_smem(
        d, block_q, block_k, s, bias, kv_mask, segments) <= SMEM_LIMIT])
    return block_q, block_k, stages


def _heads_view(b, t, h, d, like):
    """An uninitialized (B, H, T, D) view of (B, T, H, D) memory, as the
    caller's ``transpose(1, 2).reshape(B, T, H * D)`` wants it."""
    return torch.empty((b, t, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _tma_fits(t: torch.Tensor) -> bool:
    """Whether the kernels' tensor maps take ``t`` as it is: any strides
    with the head dim contiguous, the others nonzero (where the axis has
    more than one index) multiples of 16 bytes, and a 16-byte aligned
    start."""
    *outer, sd = t.stride()
    return sd == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 and (st > 0 or n == 1)
        for st, n in zip(outer, t.shape[:3]))


def _tma_operand(t: torch.Tensor, name: str) -> torch.Tensor:
    """q, k or v as the kernels' tensor maps take it (``_tma_fits``).
    Raises otherwise; never copies."""
    if not _tma_fits(t):
        raise ValueError(
            f"flash_attention kernel: {name} strides {tuple(t.stride())} at "
            f"offset {t.data_ptr() % 16}: TMA needs the head dim contiguous, "
            "the other strides multiples of 8 elements and a 16-byte "
            "aligned start")
    return t


def _check_operands(q, k, v, head_dims, q_segment_ids, kv_segment_ids):
    """The shape, dtype and layout rules both kernels share; raises before
    any launch."""
    b, hq, tq, d = q.shape
    bk, hkv, tk, dk = k.shape
    if (bk, dk) != (b, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bf16 q, k, v")
    if d not in head_dims:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{head_dims}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: segment ids come in pairs")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _tma_operand(t, name)


def kernel_bias(bias: torch.Tensor) -> torch.Tensor:
    """A bias in the layout the forward kernel copies in tiles: f32, the
    key axis contiguous and rows a multiple of 16 bytes apart (a view of a
    padded buffer)."""
    *lead, tq, tk = bias.shape
    out = torch.empty((*lead, tq, -(-tk // 4) * 4), dtype=torch.float32,
                      device=bias.device)[..., :tk]
    return out.copy_(bias)


def _bias_operand(bias, b, hq, tq, tk):
    """(f32 bias, its strides over batch, head and row) for the kernel, or
    (None, zeros). The kernel needs the key axis contiguous and, when the
    bias has a query axis (copied in 2-D tiles by TMA), a 16-byte aligned
    start and nonzero strides that are multiples of 4 elements; a bias in
    another layout or dtype is first converted (``kernel_bias``), one
    launch. The T5 layer hands over its relative bias in this layout."""
    if bias is None:
        return None, (0, 0, 0)

    def fits(x):
        sb = x.expand(b, hq, tq, tk).stride()
        return (x.dtype == torch.float32 and (tk == 1 or sb[3] == 1)
                and not (sb[2] and (x.data_ptr() % 16
                                    or any(st % 4 for st in sb[:3]))))

    if not fits(bias):
        bias = kernel_bias(bias.expand(*bias.shape[:-1], tk))
    return bias, bias.expand(b, hq, tq, tk).stride()[:3]


def _forward_cuda(q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
                  kv_segment_ids, with_lse: bool):
    """The forward kernel on q, k, v as they come (strided views too). The
    output is a (B, Hq, Tq, D) view of (B, Tq, Hq, D) memory, so a caller's
    ``transpose(1, 2).reshape(B, Tq, Hq * D)`` is free."""
    _check_operands(q, k, v, KERNEL_HEAD_DIMS, q_segment_ids, kv_segment_ids)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    bias, sb = _bias_operand(bias, b, hq, tq, tk)
    kv_mask = _int_rows(kv_mask, b, tk, "kv_mask")
    q_seg = _int_rows(q_segment_ids, b, tq, "q_segment_ids")
    kv_seg = _int_rows(kv_segment_ids, b, tk, "kv_segment_ids")
    block_q, block_k, stages = flash_fwd_tiles(
        tq, d, None if bias is None else "tile" if sb[2] else "row",
        kv_mask is not None, q_seg is not None)
    out = _heads_view(b, tq, hq, d, q)
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    shape = _SHAPE(b, hq, hkv, tq, tk, d, block_q, block_k, int(bool(causal)),
                   stages)
    strides = _STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *out.stride()[:3], *sb)
    rc = kernels.library().thinkdiff_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kernels.ptr(lse), kernels.ptr(bias), kernels.ptr(kv_mask),
        kernels.ptr(q_seg), kernels.ptr(kv_seg), shape, strides,
        float(sm_scale), kernels.stream_of(q))
    kernels.check_launch(rc, "flash_attention_fwd")
    kernels.count_launch("flash_attention_fwd")
    return out, lse


def flash_bwd_smem(kernel: str, d: int, block_q: int, block_k: int,
                   stages: int, bias: Optional[str]) -> int:
    """Shared memory of a backward kernel (``DqPlan`` / ``DkvPlan`` in
    csrc/flash_bwd.cu), rows cut in 64-column chunks of 128 bytes. "dq":
    q and dO of ``block_q`` rows, then ``stages`` of (k and v tiles of
    ``block_k`` keys, the bias boxes ("tile": f32, block_k/32 boxes of 32 x
    block_q) or row ("row"), the key-info row). "dkv": k and v of
    ``block_k`` keys, then ``stages`` of (q and dO tiles of ``block_q``
    rows, the bias boxes, the lse, delta and query-info rows). Then the
    barriers and 1024 bytes of alignment."""
    nch = d // 64
    box = block_k // 32 * block_q * 128 if bias == "tile" else 0
    if kernel == "dq":
        fixed = 2 * nch * block_q * 128
        stage = (2 * nch * block_k * 128 + box
                 + block_k * 4 * (2 if bias == "row" else 1))
    else:
        fixed = 2 * nch * block_k * 128
        stage = 2 * nch * block_q * 128 + box + block_q * 4 * 3
    return fixed + stages * stage + (1 + 2 * stages) * 8 + 1024


@functools.lru_cache(maxsize=None)
def flash_bwd_tiles(tq: int, tk: int, d: int,
                    bias: Optional[str] = None) -> tuple:
    """((block_q, block_k, stages) of the dq kernel, the same of the dk/dv
    kernel) for a call, from its shapes alone. A CTA of 64 rows (dq) or
    keys (dk/dv) is one consumer warpgroup, and at D = 64 two such CTAs
    share an SM where their plans fit in half its shared memory, so one
    CTA's loads and stores overlap the other's products (measured faster
    on an H100, see PERF.md). dq: key tiles of 64, the ring as deep as the
    call has key tiles (sweep 1 then reloads nothing), a 64-row CTA only
    at D = 64 where that ring fits twice in an SM (or Tq <= 64), else 128
    rows (two warpgroups). dk/dv: 64 keys a CTA, q tiles of 64, the ring as
    deep as the call has q tiles, or as fits (at D = 64 in half an SM,
    which two stages always do). ``bias`` is None, "row" (no query axis)
    or "tile"."""
    n_k, n_q = -(-tk // 64), -(-tq // 64)

    def stages(kernel, bq, tiles, limit):
        fit = [s for s in range(3, MAX_STAGES + 1)
               if flash_bwd_smem(kernel, d, bq, 64, s, bias) <= limit]
        return min(max([2] + fit), max(2, tiles))

    if d == 64 and n_k <= MAX_STAGES and flash_bwd_smem(
            "dq", d, 64, 64, max(2, n_k), bias) <= TWO_PER_SM:
        dq = (64, 64, max(2, n_k))
    else:
        bq = 64 if d == 64 and tq <= 64 else 128
        dq = (bq, 64, stages("dq", bq, n_k, SMEM_LIMIT))
    dkv = (64, 64, stages("dkv", 64, n_q, TWO_PER_SM if d == 64
                          else SMEM_LIMIT))
    return dq, dkv


def _backward_operands(q, k, v, bias, kv_mask, q_segment_ids,
                       kv_segment_ids, lse, do):
    """Checked operands of both backward kernels, as they come: q, k, v
    (the forward's own inputs, so their strides fit TMA) and dO through
    their strides; dO is copied once only when autograd hands over a layout
    TMA cannot read (on the T5 path it never does). Returns (q, k, v, dO,
    lse, bias, bias strides, kv_mask, q_seg, kv_seg)."""
    _check_operands(q, k, v, BACKWARD_HEAD_DIMS, q_segment_ids,
                    kv_segment_ids)
    b, hq, tq, d = q.shape
    tk = k.shape[2]
    if do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    do = do.to(torch.bfloat16)
    if not _tma_fits(do):
        do = _heads_view(b, tq, hq, d, do).copy_(do)
    bias, sb = _bias_operand(bias, b, hq, tq, tk)
    return (q, k, v, do, lse.float().contiguous(), bias, sb,
            _int_rows(kv_mask, b, tk, "kv_mask"),
            _int_rows(q_segment_ids, b, tq, "q_segment_ids"),
            _int_rows(kv_segment_ids, b, tk, "kv_segment_ids"))


def _launch_bwd(kernel, ops, delta, outs, causal, sm_scale):
    """One backward kernel: "dq" writes delta and outs = (dq,), "dkv" reads
    delta and writes outs = (dk, dv), each through its strides."""
    q, k, v, do, lse, bias, sb, kv_mask, q_seg, kv_seg = ops
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    dq_tiles, dkv_tiles = flash_bwd_tiles(
        tq, tk, d, None if bias is None else "tile" if sb[2] else "row")
    block_q, block_k, stages = dq_tiles if kernel == "dq" else dkv_tiles
    shape = _SHAPE(b, hq, hkv, tq, tk, d, block_q, block_k, int(bool(causal)),
                   stages)
    out_strides = [x.stride()[:3] for x in outs] + [(0, 0, 0)]
    strides = _BWD_STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *do.stride()[:3], *out_strides[0], *out_strides[1],
                           *sb)
    fn = (kernels.library().thinkdiff_flash_bwd_dq if kernel == "dq"
          else kernels.library().thinkdiff_flash_bwd_dkv)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            kernels.ptr(bias), kernels.ptr(kv_mask), kernels.ptr(q_seg),
            kernels.ptr(kv_seg), shape, strides, float(sm_scale),
            kernels.stream_of(q))
    name = f"flash_attention_{kernel}"
    kernels.check_launch(rc, name)
    kernels.count_launch(name)


def _launch_dq(ops, causal, sm_scale):
    q, lse = ops[0], ops[4]
    b, hq, tq, d = q.shape
    delta = torch.empty_like(lse)
    dq = _heads_view(b, tq, hq, d, q)
    _launch_bwd("dq", ops, delta, (dq,), causal, sm_scale)
    return dq, delta


def _launch_dkv(ops, delta, causal, sm_scale):
    q, k = ops[:2]
    b, hq, _, d = q.shape
    hkv, tk = k.shape[1:3]
    if delta.shape != ops[4].shape:
        raise ValueError(f"flash_attention backward: delta "
                         f"{tuple(delta.shape)} for lse "
                         f"{tuple(ops[4].shape)}")
    dk, dv = (_heads_view(b, tk, hq, d, k) for _ in range(2))
    _launch_bwd("dkv", ops, delta.float().contiguous(), (dk, dv), causal,
                sm_scale)
    if hkv != hq:
        g = hq // hkv
        dk, dv = (x.float().reshape(b, hkv, g, tk, d).sum(2).to(k.dtype)
                  for x in (dk, dv))
    return dk, dv


def flash_dq_cuda(q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
                  kv_segment_ids, lse, do):
    """The dq kernel (#5) alone: (dq, delta)."""
    ops = _backward_operands(q, k, v, bias, kv_mask, q_segment_ids,
                             kv_segment_ids, lse, do)
    return _launch_dq(ops, causal, sm_scale)


def flash_dkv_cuda(q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
                   kv_segment_ids, lse, do, delta):
    """The dk/dv kernel (#6) alone, from the dq kernel's delta: (dk, dv), a
    GQA group's per-query-head outputs summed in f32."""
    ops = _backward_operands(q, k, v, bias, kv_mask, q_segment_ids,
                             kv_segment_ids, lse, do)
    return _launch_dkv(ops, delta, causal, sm_scale)


def flash_attention_backward(q, k, v, bias, kv_mask, causal, sm_scale,
                             q_segment_ids, kv_segment_ids, lse, do):
    """(dq, dk, dv) of ``flash_attention``: the dq kernel, then the dk/dv
    kernel, on CUDA tensors (D in BACKWARD_HEAD_DIMS), q, k, v and dO
    through their strides and dq, dk, dv as (B, H, T, D) views of (B, T,
    H, D) memory; the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
            kv_segment_ids, lse, do)
    if not q.is_cuda:
        raise NotImplementedError(f"flash_attention: no kernel for {q.device}")
    ops = _backward_operands(q, k, v, bias, kv_mask, q_segment_ids,
                             kv_segment_ids, lse, do)
    dq, delta = _launch_dq(ops, causal, sm_scale)
    return (dq, *_launch_dkv(ops, delta, causal, sm_scale))


def _forward(q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
             kv_segment_ids, with_lse: bool):
    if q.is_cuda:
        return _forward_cuda(q, k, v, bias, kv_mask, causal, sm_scale,
                             q_segment_ids, kv_segment_ids, with_lse)
    if q.device.type == "cpu":
        args = (bias, kv_mask, causal, sm_scale, q_segment_ids,
                kv_segment_ids)
        out = mha_reference(q, k, v, *args)
        return out, (logsumexp_reference(q, k, *args) if with_lse else None)
    raise NotImplementedError(f"flash_attention: no kernel for {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
                kv_segment_ids):
        out, lse = _forward(q, k, v, bias, kv_mask, causal, sm_scale,
                            q_segment_ids, kv_segment_ids, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, kv_mask, q_segment_ids,
                              kv_segment_ids, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, kv_mask, q_seg, kv_seg, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, bias, kv_mask, ctx.causal, ctx.sm_scale, q_seg, kv_seg,
            lse, do)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, bias=None, kv_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None) -> torch.Tensor:
    """softmax(q k^T * sm_scale + bias, masked) v, differentiable in q, k, v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        if bias is not None and bias.requires_grad:
            raise NotImplementedError(
                "flash_attention: no gradient for the bias (it is frozen on "
                "every training path)")
        return _FlashAttention.apply(q, k, v, bias, kv_mask, causal, sm_scale,
                                     q_segment_ids, kv_segment_ids)
    return _forward(q, k, v, bias, kv_mask, causal, sm_scale, q_segment_ids,
                    kv_segment_ids, with_lse=False)[0]
