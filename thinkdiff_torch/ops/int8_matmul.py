"""The int8 GEMMs of thinkdiff_tpu/ops/int8_matmul.py, each a hand-written
kernel on a CUDA tensor and its plain version on a CPU tensor.

w8a8 (s8 x s8, exact int32 sums; the references accumulate in float64,
which holds every int32 sum exactly, so the kernels equal them on the card):
  ``s8_matmul``      y = out(f32(sum_k xq[r, k] * w_q[k, n]) * sx[r] * scale[n])
                     (``_s8_matmul_fused``, csrc/s8_gemm.cu)
  ``s8_matmul_bwd``  dx = out(f32(sum_n gq[r, n] * w_q[k, n]) * sg[r])
                     (``_s8_matmul_fused_bwd``, csrc/s8_gemm_bwd.cu)
  ``s8_matmul_qx``   s8_matmul with x quantized per row inside the kernel
                     (``_s8_matmul_fused_qx``, csrc/s8_gemm_qx.cu)
All three run one mainloop (csrc/s8_wgmma.cuh: s8 wgmma on a TMA ring),
whose tiles and split of the contraction ``s8_gemm_plan`` picks from the
shapes (``s8_qx_plan`` for ``s8_matmul_qx``, which quantizes each row once
in the same launch and does not split the contraction).
weight-only int8 (x float, f32 accumulation):
  ``int8_matmul``       y = out(f32(x) @ f32(w_q) * scale), R <= 32 rows a
                        launch (``int8_matmul``, csrc/int8_gemv.cu: a
                        bandwidth kernel, persistent CTAs on a TMA ring,
                        split K reduced in the same launch), whose unit
                        width and split ``gemv_plan`` picks from the shapes
  ``int8_matmul_wide``  the same at any R with bf16 products, and its input
                        gradient (``int8_matmul_wide``, csrc/int8_wide.cu:
                        bf16 wgmma on a TMA ring, the int8 weight tile
                        converted to bf16 in the CTA), whose tile width and
                        ring depth ``wide_plan`` picks from the shapes

Every kernel reads the int8 weight as its (N, K) row-major storage: QDense
keeps its (K, N) kernel as the transpose view of such a copy, made once at
load; any other layout is copied per call. ``s8_matmul_bwd`` alone reads the
(K, N) row-major layout (a training QDense keeps that copy too).
"""

from __future__ import annotations

import functools

import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops.flash_attention import SMEM_LIMIT

# the weight-only GEMV takes R <= GEMV_ROWS rows a launch (two m16 tiles)
GEMV_ROWS = 32
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def s8_matmul_reference(xq, sx, w_q, scale, out_dtype=torch.bfloat16):
    acc = xq.double() @ w_q.double()  # exact integer sums
    return (acc.float() * sx.float()[:, None]
            * scale.float()[None, :]).to(out_dtype)


def s8_matmul_bwd_reference(gq, sg, w_q, out_dtype=torch.bfloat16):
    acc = gq.double() @ w_q.double().t()  # exact integer sums
    return (acc.float() * sg.float()[:, None]).to(out_dtype)


def _transposed_storage(w_q: torch.Tensor) -> torch.Tensor:
    """The (N, K) row-major storage the kernel reads. QDense keeps its (K, N)
    weight as the transpose view of such a copy, made once at load time;
    any other layout is copied here, per call."""
    wt = w_q.t()
    return wt if wt.is_contiguous() else wt.contiguous()


def _aligned(name, *named):
    for label, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {label} is not 16-byte aligned")


# the w8a8 kernel's plan (csrc/s8_wgmma.cuh)
S8_BLOCK_K = 128     # bytes of the contraction a ring stage holds
S8_MAX_STAGES = 8
S8_MAX_SPLIT = 16
# fixed costs in the plan's unit, the time of one K slice of a 128-column
# tile (~0.28 us on an H100): a work unit's (ring fill, epilogue), and a
# split's: the int32 workspace's round trip and the second kernel on the
# card (~3 us), the workspace's allocation and the second launch on the
# host (~15 us), which counts because every split shape of the repository
# sits on a decode path that waits on the host (PERF.md)
S8_UNIT_COST = 2
S8_SPLIT_COST = 48


def s8_gemm_smem(block_m: int, block_n: int, stages: int) -> int:
    """Shared memory of the kernel: ``stages`` (A, B) stages of 128-byte K
    slices, the bf16 output tile, the stages' full and empty barriers, 16
    bytes of flags, 1024 bytes of alignment."""
    return (stages * (block_m + block_n) * S8_BLOCK_K + block_m * block_n * 2
            + 2 * stages * 8 + 16 + 1024)


def _s8_stages(bm: int, bn: int) -> int:
    """As deep a ring as fits in shared memory (2-8)."""
    return max(s for s in range(2, S8_MAX_STAGES + 1)
               if s8_gemm_smem(bm, bn, s) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def s8_qx_plan(r: int, k: int, n: int, sms: int = 132) -> tuple:
    """(block_m, block_n, stages) of ``s8_matmul_qx``, whose kernel does
    not split the contraction: ``s8_gemm_plan``'s rows a tile, the column
    width (256 or 128) whose busiest SM takes the least time (waves x
    block_n; ties to the wider), as deep a ring as fits. ``k`` does not
    change the plan."""
    bm = 64 if r <= 64 else 128
    tiles_m = -(-r // bm)
    bn = min((256, 128), key=lambda bn: -(-tiles_m * -(-n // bn) // sms) * bn)
    return bm, bn, _s8_stages(bm, bn)


@functools.lru_cache(maxsize=None)
def s8_gemm_plan(r: int, k: int, n: int, sms: int = 132) -> tuple:
    """(block_m, block_n, stages, split) of the w8a8 kernel for an (r, n)
    output over a contraction of k, from the shapes alone: 64 rows a tile
    (one consumer warpgroup) at r <= 64, else 128 (two); 128 or 256
    columns; the contraction cut into ``split`` ranges of K slices (none
    empty) only where the tiles alone are short of a wave of ``sms`` SMs.
    Of those, the one whose busiest SM takes the least time, counted as
    waves x (K slices a unit + S8_UNIT_COST) x block_n / 128, plus
    S8_SPLIT_COST with a split; ties go to fewer splits, then the wider
    tile. As deep a ring as fits in shared memory (2-8)."""
    bm = 64 if r <= 64 else 128
    steps = -(-k // S8_BLOCK_K)
    best = None
    for bn in (256, 128):
        units = -(-r // bm) * -(-n // bn)
        for split in (range(1, min(steps, S8_MAX_SPLIT) + 1) if units < sms
                      else (1,)):
            per = -(-steps // split)
            split = -(-steps // per)  # no empty split
            cost = (-(-units * split // sms) * (per + S8_UNIT_COST) * bn
                    // 128 + (S8_SPLIT_COST if split > 1 else 0))
            if best is None or (cost, split, -bn) < best[0]:
                best = ((cost, split, -bn), bn, split)
    _, bn, split = best
    return bm, bn, _s8_stages(bm, bn), split


def _s8_outputs(a, rows, k, cols):
    """The plan of a w8a8 kernel call with an (rows, cols) output over a
    contraction of k, its bf16 output, and its split's int32 workspace
    (None without a split)."""
    plan = s8_gemm_plan(rows, k, cols, _sm_count(a.device.index))
    out = torch.empty((rows, cols), dtype=torch.bfloat16, device=a.device)
    ws = (torch.empty((plan[3], rows, cols), dtype=torch.int32,
                      device=a.device) if plan[3] > 1 else None)
    return plan, out, ws


def _s8_matmul_cuda(xq, sx, w_q, scale, out_dtype):
    r, k = xq.shape
    k2, n = w_q.shape
    if k2 != k or sx.shape != (r,) or scale.shape != (n,):
        raise ValueError(f"s8_matmul: bad shapes xq {tuple(xq.shape)} sx "
                         f"{tuple(sx.shape)} w_q {tuple(w_q.shape)} scale "
                         f"{tuple(scale.shape)}")
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("s8_matmul kernel takes int8 xq and w_q")
    if out_dtype != torch.bfloat16:
        raise TypeError("s8_matmul kernel writes bf16")
    if k % 16 or n % 16:
        raise ValueError(f"s8_matmul kernel: K={k} and N={n} must be "
                         "multiples of 16")
    xq = xq.contiguous()
    wt = _transposed_storage(w_q)
    sx = sx.float().contiguous()
    scale = scale.float().contiguous()
    _aligned("s8_matmul", ("xq", xq), ("w_q", wt))
    plan, y, ws = _s8_outputs(xq, r, k, n)
    rc = kernels.library().thinkdiff_s8_gemm(
        kernels.ptr(xq), kernels.ptr(sx), kernels.ptr(wt), kernels.ptr(scale),
        kernels.ptr(y), kernels.ptr(ws), r, k, n, *plan,
        kernels.stream_of(xq))
    kernels.check_launch(rc, "s8_matmul")
    kernels.count_launch("s8_matmul")
    return y


def s8_matmul(xq, sx, w_q, scale, out_dtype=torch.bfloat16):
    """xq (R, K) int8, sx (R,) f32, w_q (K, N) int8, scale (N,) f32."""
    if xq.is_cuda:
        return _s8_matmul_cuda(xq, sx, w_q, scale, out_dtype)
    if xq.device.type == "cpu":
        return s8_matmul_reference(xq, sx, w_q, scale, out_dtype)
    raise NotImplementedError(f"s8_matmul: no kernel for {xq.device}")


def _s8_matmul_bwd_cuda(gq, sg, w_q, out_dtype):
    r, n = gq.shape
    k, n2 = w_q.shape
    if n2 != n or sg.shape != (r,):
        raise ValueError(f"s8_matmul_bwd: bad shapes gq {tuple(gq.shape)} sg "
                         f"{tuple(sg.shape)} w_q {tuple(w_q.shape)}")
    if gq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("s8_matmul_bwd kernel takes int8 gq and w_q")
    if out_dtype != torch.bfloat16:
        raise TypeError("s8_matmul_bwd kernel writes bf16")
    if n % 16 or k % 8:
        # K % 8: dx's rows start 16-byte aligned, as TMA stores them
        raise ValueError(f"s8_matmul_bwd kernel: N={n} must be a multiple of "
                         f"16 and K={k} of 8")
    if not w_q.is_contiguous():
        # copying the whole weight on every backward would hide a missing
        # training layout: the caller keeps the copy, made once at load
        raise ValueError("s8_matmul_bwd kernel reads w_q as a (K, N) row-major "
                         "tensor (QDense(train_layout=True) keeps one)")
    gq, w = gq.contiguous(), w_q
    sg = sg.float().contiguous()
    _aligned("s8_matmul_bwd", ("gq", gq), ("w_q", w))
    plan, dx, ws = _s8_outputs(gq, r, n, k)
    rc = kernels.library().thinkdiff_s8_gemm_bwd(
        kernels.ptr(gq), kernels.ptr(sg), kernels.ptr(w), kernels.ptr(dx),
        kernels.ptr(ws), r, k, n, *plan, kernels.stream_of(gq))
    kernels.check_launch(rc, "s8_matmul_bwd")
    kernels.count_launch("s8_matmul_bwd")
    return dx


def s8_matmul_bwd(gq, sg, w_q, out_dtype=torch.bfloat16):
    """gq (R, N) int8, sg (R,) f32, w_q (K, N) int8 -> dx (R, K). The
    kernel takes w_q row-major only; the plain version any layout."""
    if gq.is_cuda:
        return _s8_matmul_bwd_cuda(gq, sg, w_q, out_dtype)
    if gq.device.type == "cpu":
        return s8_matmul_bwd_reference(gq, sg, w_q, out_dtype)
    raise NotImplementedError(f"s8_matmul_bwd: no kernel for {gq.device}")


# ------------------------------- weight-only ---------------------------------

def int8_matmul_reference(x, w_q, scale, out_dtype=None):
    """(f32(x) @ f32(w_q)) * f32(scale), cast to ``out_dtype`` (x's dtype by
    default): the JAX ``int8_matmul_reference``."""
    out_dtype = out_dtype or x.dtype
    y = x.float() @ w_q.float()
    return (y * scale.float()[None]).to(out_dtype)


def _check_int8_operands(name, k, w_q, scale):
    """The shapes every weight-only kernel takes: w_q (K, N) int8, scale
    (N,), K and N multiples of 16 (every weight-only layer of the repo's
    configurations). Anything else raises a ValueError naming the shape."""
    if w_q.dim() != 2 or w_q.shape[0] != k or scale.shape != (w_q.shape[1],):
        raise ValueError(f"{name}: bad shapes K={k}, w_q {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    n = w_q.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"{name} kernel: K={k} and N={n} must be multiples "
                         "of 16")
    if w_q.dtype != torch.int8:
        raise TypeError(f"{name} kernel takes an int8 weight")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the GEMV's plan (csrc/int8_gemv.cu): a work unit is GEMV_BLOCKS columns
# (32, 64 or 128) x a K range of whole stages; a stage holds GEMV_STAGE_BYTES
# of the weight (block_n columns x GEMV_STAGE_BYTES / block_n bytes of k);
# persistent CTAs, one an SM at most, each a contiguous run of the units
# (K range by K range, column tile fastest)
GEMV_BLOCKS = (128, 64, 32)
GEMV_STAGE_BYTES = 16384
GEMV_MAX_STAGES = 8
# the plan's costs, in stages of one SM (~0.8 us each on an H100, the
# consumers' rate; ``chip_smoke.gemv_sweep``, NVIDIA H100 80GB HBM3, 700
# W): a stage by unit width (narrow units copy more, smaller TMA boxes a
# stage) and above 16 rows (two m16 tiles); a unit's epilogue; a split's
# partial sums, fence, counters and closing reads (measured +3-4 us at 2
# ranges, +8 us at 4)
GEMV_STAGE_COST = {128: 1.0, 64: 1.06, 32: 1.15}
GEMV_MT2_COST = 1.22
GEMV_UNIT_COST = 0.5
GEMV_SPLIT_FIXED = 5.0
GEMV_SPLIT_RANGE = 1.0


def gemv_smem(r: int, f32: bool, stages: int, block_n: int) -> int:
    """Shared memory of the GEMV (``GemvTile::smem``): ``stages`` ring
    stages of the 16 KB weight tile and the stage's x (16 or 32 rows of
    16384 / block_n k, bf16 or f32), the eight warps' sums, the barriers,
    1024 bytes of alignment."""
    mt = 1 if r <= 16 else 2
    cg = block_n // 32
    slices = 8 // cg
    sk = 64 * slices
    stage = GEMV_STAGE_BYTES + sk * (4 if f32 else 2) * 16 * mt
    return stages * stage + 8 * mt * 16 * 32 * 4 + 2 * stages * 8 + 1024


@functools.lru_cache(maxsize=None)
def gemv_plan(r: int, k: int, n: int, sms: int = 132,
              f32: bool = False) -> tuple:
    """(block_n, per, stages, ctas) of the GEMV for r <= 32 rows of an (r,
    k) @ (k, n) product, from the shapes alone. Units are block_n columns x
    K ranges of ``per`` stages (none empty), and ctas = min(units, sms)
    persistent CTAs take them in contiguous runs. Of every width and cut,
    the one whose busiest SM takes the least time, counted in stages: its
    units' stages (GEMV_STAGE_COST by width, GEMV_MT2_COST above 16 rows)
    and GEMV_UNIT_COST a unit, plus a split's GEMV_SPLIT_FIXED and
    GEMV_SPLIT_RANGE a K range; ties go to fewer ranges, then wider units;
    a width whose ring would hold fewer than 3 stages (f32 x at 32
    columns) is not taken. Then as deep a ring as fits in shared memory
    (3-8)."""
    mt_cost = GEMV_MT2_COST if r > 16 else 1.0
    best = None
    for block_n in GEMV_BLOCKS:
        if gemv_smem(r, f32, 3, block_n) > SMEM_LIMIT:
            continue  # under 32 KB of weight in flight
        steps = -(-k // (GEMV_STAGE_BYTES // block_n))
        tiles = -(-n // block_n)
        stage = mt_cost * GEMV_STAGE_COST[block_n]
        for splits in range(1, steps + 1):
            per = -(-steps // splits)
            if -(-steps // per) != splits:
                continue  # the same cut as fewer ranges
            units = tiles * splits
            waves = -(-units // min(units, sms))
            cost = waves * (per * stage + GEMV_UNIT_COST) + (
                GEMV_SPLIT_FIXED + GEMV_SPLIT_RANGE * splits if splits > 1
                else 0)
            key = (cost, splits, -block_n)
            if best is None or key < best[0]:
                best = (key, block_n, per, min(units, sms))
    _, block_n, per, ctas = best
    stages = max(s for s in range(2, GEMV_MAX_STAGES + 1)
                 if gemv_smem(r, f32, s, block_n) <= SMEM_LIMIT)
    return block_n, per, stages, ctas


# a split GEMV's f32 partial sums (splits, GEMV_ROWS, N) and its counters
# (one int a 32-column tile, the narrowest, left at 0 by every launch), per
# device, stream, N and split: allocated at the first call of a shape,
# never per call
_GEMV_WORKSPACE: dict = {}


def _gemv_workspace(device, stream: int, n: int, splits: int):
    key = (device.index, stream, n, splits)
    got = _GEMV_WORKSPACE.get(key)
    if got is None:
        got = _GEMV_WORKSPACE[key] = (
            torch.empty((splits, GEMV_ROWS, n), dtype=torch.float32,
                        device=device),
            torch.zeros((-(-n // 32),), dtype=torch.int32, device=device))
    return got


def _int8_matmul_cuda(x, w_q, scale, out_dtype):
    k = x.shape[-1]
    _check_int8_operands("int8_matmul", k, w_q, scale)
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError("int8_matmul kernel takes and writes bf16 or f32, not "
                        f"{x.dtype} -> {out_dtype}")
    n = w_q.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    wt = _transposed_storage(w_q)
    scale = scale.float().contiguous()
    _aligned("int8_matmul", ("x", x2), ("w_q", wt))
    r = x2.shape[0]
    y = torch.empty((r, n), dtype=out_dtype, device=x.device)
    f32 = x.dtype == torch.float32
    sms = _sm_count(x.device.index)
    stream = kernels.stream_of(x)
    lib = kernels.library()
    for r0 in range(0, r, GEMV_ROWS):
        xs, ys = x2[r0:r0 + GEMV_ROWS], y[r0:r0 + GEMV_ROWS]
        rows = xs.shape[0]
        block_n, per, stages, ctas = gemv_plan(rows, k, n, sms, f32)
        splits = -(-(-(-k // (GEMV_STAGE_BYTES // block_n))) // per)
        ws, cnt = (_gemv_workspace(x.device, stream, n, splits)
                   if splits > 1 else (None, None))
        rc = lib.thinkdiff_int8_gemv(
            kernels.ptr(xs), kernels.ptr(wt), kernels.ptr(scale),
            kernels.ptr(ys), kernels.ptr(ws), kernels.ptr(cnt), rows, k, n,
            block_n, per, stages, ctas, int(f32),
            int(out_dtype == torch.float32), stream)
        kernels.check_launch(rc, "int8_matmul")
        kernels.count_launch("int8_matmul")
    return y.reshape(*lead, n)


def int8_matmul(x, w_q, scale, out_dtype=None):
    """x (..., K) @ int8 w_q (K, N) * scale (N,) -> (..., N) in
    ``out_dtype`` (x's dtype by default): the weight-only product of a
    decode step. On the card, one GEMV launch per 32 rows; K and N must be
    multiples of 16 there."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return _int8_matmul_cuda(x, w_q, scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, out_dtype)
    raise NotImplementedError(f"int8_matmul: no kernel for {x.device}")


def int8_matmul_wide_fwd_reference(x, w_q, scale):
    """The wide forward's arithmetic: x rounded to bf16 (the kernels' MXU /
    tensor-core operand), then ``int8_matmul_reference`` in x's dtype."""
    return int8_matmul_reference(x.to(torch.bfloat16), w_q, scale, x.dtype)


def int8_matmul_wide_bwd_reference(g, w_q, scale, out_dtype):
    """dx = f32(bf16(f32(g) * scale)) @ f32(w_q)^T, cast to ``out_dtype``:
    the Pallas ``_wide_bwd_kernel`` rounds g * scale to bf16 before its
    product."""
    gs = (g.float() * scale.float()).to(torch.bfloat16).float()
    return (gs @ w_q.float().t()).to(out_dtype)


# the weight-only wide kernels' plan (csrc/int8_wide.cu): a work unit is
# `block` output rows (128 or 256) x 128 output columns in the forward,
# and 128 rows x 256 columns in the input gradient (which converts g half
# as often a product, and a stage ahead, in three buffers)
WIDE_BLOCK_K = 64    # contraction a ring stage
WIDE_MAX_STAGES = 8
# relative time of one contraction stage of a forward unit by its block: a
# 128-row unit does half the products of a 256 one but takes more than
# half as long (measured 0.0808 against 0.0556 ms at twice the units,
# R411 K4096 N8192, NVIDIA H100 80GB HBM3 700 W, ``chip_smoke.wide_sweep``)
WIDE_STAGE_COST = {256: 8, 128: 5}
WIDE_UNIT_COST = 2   # a unit's ring fill and epilogue, in stages


def wide_smem(block: int, stages: int, backward: bool = False,
              f32: bool = False) -> int:
    """Shared memory of a wide kernel (``WideTile::smem``): ``stages`` ring
    stages of the activation (block rows of 64, bf16, or f32 g in the input
    gradient) and the int8 weight (8 KB; the gradient's 256-column units
    16 KB) and, in the gradient, a 1 KB slot of the stage's scales; for
    the input gradient three converted tiles of block rows x 64 bf16; a
    staging tile of bf16 outputs for each of the two consumer warpgroups;
    the barriers; 1024 bytes of alignment."""
    cols = 256 if backward else 128
    raw = block * WIDE_BLOCK_K * (4 if backward and f32 else 2) + cols * 64
    cvt = 3 if backward else 0
    if backward:
        raw += 1024  # the stage's column scales
    return (stages * raw + cvt * block * 128 + 2 * block * cols
            + (2 * stages + cvt) * 8 + 1024)


@functools.lru_cache(maxsize=None)
def wide_plan(r: int, k: int, n: int, sms: int = 132, f32: bool = False,
              backward: bool = False) -> tuple:
    """(block, stages) of a wide kernel for an (r, n) output over a
    contraction of k. Forward: units of block rows (128 or 256) x 128
    columns, the block whose busiest SM takes the least time, counted as
    waves x (stages a unit + WIDE_UNIT_COST) x WIDE_STAGE_COST[block], ties
    to 256. Input gradient: 128 rows x 256 columns. Then as deep a ring as
    fits in shared memory (2-8)."""
    steps = -(-k // WIDE_BLOCK_K)
    best = None
    for block in ((128,) if backward else (256, 128)):
        fits = [st for st in range(2, WIDE_MAX_STAGES + 1)
                if wide_smem(block, st, backward, f32) <= SMEM_LIMIT]
        units = -(-r // block) * -(-n // (256 if backward else 128))
        cost = (-(-units // sms) * (steps + WIDE_UNIT_COST)
                * WIDE_STAGE_COST[block])
        if best is None or cost < best[0]:
            best = (cost, block, max(fits))
    return best[1], best[2]


def _int8_wide_cuda(name, a, w_q, scale, out_dtype, backward):
    k, n = w_q.shape
    _check_int8_operands(name, k, w_q, scale)
    if a.dtype not in _KERNEL_DTYPES or out_dtype != a.dtype:
        raise TypeError(f"{name} kernel takes bf16 or f32 and writes the same "
                        f"type, not {a.dtype} -> {out_dtype}")
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    if a2.shape[1] != (n if backward else k):
        raise ValueError(f"{name}: input {tuple(a.shape)} for w_q "
                         f"{tuple(w_q.shape)}")
    f32 = a.dtype == torch.float32
    if f32 and not backward:
        # the forward's product operand is bf16(x): rounding here gives the
        # kernel's bits (the input gradient scales f32 g before its rounding,
        # so it takes f32 as it is)
        a2 = a2.to(torch.bfloat16)
    wt = _transposed_storage(w_q)
    scale = scale.float().contiguous()
    _aligned(name, ("input", a2), ("w_q", wt), ("scale", scale))
    rows, cols = a2.shape[0], (k if backward else n)
    plan = wide_plan(rows, a2.shape[1], cols, _sm_count(a.device.index),
                     f32 and backward, backward)
    out = torch.empty((rows, cols), dtype=out_dtype, device=a.device)
    fn = (kernels.library().thinkdiff_int8_wide_bwd if backward
          else kernels.library().thinkdiff_int8_wide_fwd)
    rc = fn(kernels.ptr(a2), kernels.ptr(wt), kernels.ptr(scale),
            kernels.ptr(out), rows, k, n, int(f32), *plan,
            kernels.stream_of(a))
    kernels.check_launch(rc, name)
    kernels.count_launch(name)
    return out.reshape(*a.shape[:-1], cols)


def int8_matmul_wide_fwd(x, w_q, scale):
    """x (..., K) -> (..., N) in x's dtype (bf16 products, f32 sums)."""
    if x.is_cuda:
        return _int8_wide_cuda("int8_matmul_wide_fwd", x, w_q, scale,
                               x.dtype, backward=False)
    if x.device.type == "cpu":
        return int8_matmul_wide_fwd_reference(x, w_q, scale)
    raise NotImplementedError(f"int8_matmul_wide: no kernel for {x.device}")


def int8_matmul_wide_bwd(g, w_q, scale, out_dtype):
    """g (..., N) -> dx (..., K) in ``out_dtype``."""
    if g.is_cuda:
        return _int8_wide_cuda("int8_matmul_wide_bwd", g, w_q, scale,
                               out_dtype, backward=True)
    if g.device.type == "cpu":
        return int8_matmul_wide_bwd_reference(g, w_q, scale, out_dtype)
    raise NotImplementedError(f"int8_matmul_wide: no kernel for {g.device}")


class _Int8MatmulWide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        ctx.x_dtype = x.dtype
        return int8_matmul_wide_fwd(x, w_q, scale)

    @staticmethod
    def backward(ctx, g):
        w_q, scale = ctx.saved_tensors
        # frozen weight: no gradient for w_q or scale (JAX returns None)
        return int8_matmul_wide_bwd(g.to(ctx.x_dtype), w_q, scale,
                                    ctx.x_dtype), None, None


def int8_matmul_wide(x, w_q, scale):
    """x (..., K) @ int8 w_q (K, N) * scale (N,) -> (..., N) in x's dtype,
    streaming the weight as int8 in the forward and the input gradient
    (the JAX ``jax.custom_vjp`` of the same name; the weight is frozen)."""
    return _Int8MatmulWide.apply(x, w_q, scale)


# ------------------------- w8a8, quantize in kernel --------------------------

def s8_qx_supported(r: int, k: int, n: int) -> bool:
    """The JAX op's geometry gate (K 128-aligned and <= 4096, N with a
    128-multiple block), kept so that callers pick the same path in both
    packages; the port's kernel itself takes any K, N multiple of 16."""
    return bool(k <= 4096 and k % 128 == 0
                and any(n % b == 0 for b in (512, 384, 256, 128)))


def s8_matmul_qx_reference(x, w_q, scale, out_dtype=torch.bfloat16):
    """The pre-pass chain the kernel fuses: per-row absmax quantization
    (``_absmax_quant_rows``), then ``s8_matmul_reference``."""
    from thinkdiff_torch.ops.quant import _absmax_quant_rows

    xq, sx = _absmax_quant_rows(x)
    return s8_matmul_reference(xq, sx, w_q, scale, out_dtype)


# s8_matmul_qx's workspace per device, stream, shape and row tile: xq (R,
# K) int8, sx (R,) f32 and the ticket / exit / row-tile counters, which
# every launch leaves at 0. Two launches in flight at once must not share
# one: a CUDA graph keeps the workspace of the stream it was captured on,
# so its replay must not overlap another launch on that stream's.
_QX_WORKSPACE: dict = {}


def _qx_workspace(device, stream: int, r: int, k: int, bm: int):
    key = (device.index, stream, r, k, bm)
    got = _QX_WORKSPACE.get(key)
    if got is None:
        got = _QX_WORKSPACE[key] = (
            torch.empty((r, k), dtype=torch.int8, device=device),
            torch.empty((r,), dtype=torch.float32, device=device),
            torch.zeros((2 + -(-r // bm),), dtype=torch.int32, device=device))
    return got


def _s8_matmul_qx_cuda(x, w_q, scale, out_dtype):
    if x.dim() != 2:
        raise ValueError(f"s8_matmul_qx: x must be (R, K), not {tuple(x.shape)}")
    r, k = x.shape
    _check_int8_operands("s8_matmul_qx", k, w_q, scale)
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError("s8_matmul_qx kernel takes and writes bf16 or f32, "
                        f"not {x.dtype} -> {out_dtype}")
    n = w_q.shape[1]
    x = x.contiguous()
    wt = _transposed_storage(w_q)
    scale = scale.float().contiguous()
    _aligned("s8_matmul_qx", ("x", x), ("w_q", wt))
    y = torch.empty((r, n), dtype=out_dtype, device=x.device)
    plan = s8_qx_plan(r, k, n, _sm_count(x.device.index))
    stream = kernels.stream_of(x)
    ws = _qx_workspace(x.device, stream, r, k, plan[0])
    rc = kernels.library().thinkdiff_s8_gemm_qx(
        kernels.ptr(x), kernels.ptr(wt), kernels.ptr(scale), kernels.ptr(y),
        *map(kernels.ptr, ws), r, k, n, *plan, int(x.dtype == torch.float32),
        int(out_dtype == torch.float32), stream)
    kernels.check_launch(rc, "s8_matmul_qx")
    kernels.count_launch("s8_matmul_qx")
    return y


def s8_matmul_qx(x, w_q, scale, out_dtype=torch.bfloat16):
    """x (R, K) float, UNquantized; w_q (K, N) int8; scale (N,) f32: the
    w8a8 product with x quantized per row inside the kernel, numerics
    identical to ``_absmax_quant_rows`` + ``s8_matmul``."""
    if x.is_cuda:
        return _s8_matmul_qx_cuda(x, w_q, scale, out_dtype)
    if x.device.type == "cpu":
        return s8_matmul_qx_reference(x, w_q, scale, out_dtype)
    raise NotImplementedError(f"s8_matmul_qx: no kernel for {x.device}")
