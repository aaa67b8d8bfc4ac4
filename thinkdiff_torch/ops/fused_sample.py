"""Fused lm_head + token sampling for decode (counterpart of
thinkdiff_tpu/ops/fused_sample.py).

The sampler never materializes the (B, V) logits: the int8 lm_head streams
column tile by column tile, each tile's logits are biased (and perturbed)
in registers, and a running first-occurrence argmax leaves only (B,) token
ids. Two modes:

  noise=False  exact argmax of ``logits * inv_temp + biases``: greedy, the
               same ids as an argmax over the w8a8 logits.
  noise=True   Gumbel-max: argmax(logits / T + G), exact temperature-softmax
               sampling over the full vocabulary (no nucleus truncation).

Biases, applied before the noise (the masking order of ``sample_logits``):
``pad_bias`` -1e30 on the columns that pad the vocabulary to a whole number
of blocks; ``eos_bias`` -1e30 on EOS columns, scaled per row by ``blocked``
(1.0 while a row's EOS is still forbidden by min_tokens).

The noise is a counter-based hash of (seed, row, vocabulary column), so a
draw depends on neither the kernel's tiling nor the padding, and
``gumbel_noise`` reproduces the kernel's draws exactly.

Vocabulary-shard mode (a tensor-parallel lm_head, one shard a rank of the
model group): ``col0`` is the global vocabulary column of the pack's first
column; it enters the noise's hash and the argmax key, and with
``keys=True`` the call returns each row's 64-bit argmax key (the top bit
flipped, so int64 order is the keys' order) in place of the id. The MAX of
the shards' keys over the group (``keys_to_ids``) is exactly the
unsharded call's id: the larger value wins, and of equal values the lower
global column. ``col0=0`` with ids out is the unsharded call, bit for
bit. The TPU kernel drew
from the chip's own generator; the two give different streams of the same
law. On a CUDA tensor ``fused_lm_sample`` launches the hand-written kernel
of ``csrc/fused_sample.cu`` (x quantized in the same launch; one launch a
call up to 256 rows), whose batch tile, ring depth and grid
``sample_plan`` picks from the shapes; on a CPU tensor it runs
``fused_lm_sample_reference`` on the same noise.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops.flash_attention import SMEM_LIMIT
from thinkdiff_torch.ops.quant import _absmax_quant_rows

_NEG = -1e30
_M32 = 0xFFFFFFFF
_U_MAX = 1.0 - 2.0 ** -24  # the largest f32 below 1

# the CUDA kernel's plan (csrc/fused_sample.cu): 64 vocabulary rows a block
# (wgmma's M), 128 bytes of D a ring stage, at most SAMPLE_ROWS batch rows a
# launch (two batch tiles of 128)
SAMPLE_BLOCK = 64
SAMPLE_BK = 128
SAMPLE_ROWS = 256
SAMPLE_MAX_STAGES = 8  # a ring's; a CTA runs two rings, one a warpgroup
SAMPLE_WIDTHS = (8, 16, 32, 64, 128)  # wgmma widths of a batch tile


def sample_smem(n: int, tiles: int, stages: int) -> int:
    """Shared memory of the kernel (``SampleTile::smem``): two rings of
    ``stages`` stages (a 64-row weight slice and the batch tile's slice of
    xq), their barriers, the keys, sx and blocked of every batch column, 16
    bytes of flags, 1024 bytes of alignment."""
    stage = (SAMPLE_BLOCK + n) * SAMPLE_BK
    return 2 * stages * stage + 4 * stages * 8 + tiles * n * 16 + 16 + 1024


@functools.lru_cache(maxsize=None)
def sample_plan(b: int, d: int, vp: int, sms: int = 132) -> tuple:
    """(n, tiles, stages, ctas) of the kernel for b <= 256 rows, from the
    shapes alone: one batch tile of n = b rounded up to a wgmma width of
    SAMPLE_WIDTHS (the two warpgroups take alternate vocabulary blocks), or
    above 128 rows two of 128 (warpgroup w takes tile w of every block);
    the rings as deep as fit (at most 8 each). One CTA an SM, each with a
    contiguous run of blocks (two or more with one batch tile, where the
    vocabulary has them, so that both warpgroups work). ``d`` does not
    change the plan: every stage holds one 128-byte slice of it."""
    if not 1 <= b <= SAMPLE_ROWS:
        raise ValueError(f"sample_plan: {b} rows, the kernel takes 1-256")
    blocks = vp // SAMPLE_BLOCK
    tiles = 1 if b <= 128 else 2
    n = next(w for w in SAMPLE_WIDTHS if w >= b) if tiles == 1 else 128
    ctas = min(sms, max(1, blocks // 2) if tiles == 1 else blocks)
    stages = max(s for s in range(2, SAMPLE_MAX_STAGES + 1)
                 if sample_smem(n, tiles, s) <= SMEM_LIMIT)
    return n, tiles, stages, ctas


def sample_blocks(plan: tuple, vp: int) -> list:
    """The vocabulary blocks [lo, hi) of each CTA of a plan (the kernel's
    split of Vp / 64 blocks)."""
    blocks, ctas = vp // SAMPLE_BLOCK, plan[3]
    return [(c * blocks // ctas, (c + 1) * blocks // ctas)
            for c in range(ctas)]


def argmax_key(value: float, col: int) -> int:
    """The kernel's 64-bit argmax key of an f32 value at a column: the
    value's order-preserving bits (-0.0 taken as +0.0) over 0xFFFFFFFF -
    col, so that the larger key holds the larger value, and of equal values
    the lower column."""
    v = np.float32(value)
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))
    ordered = (~u & _M32) if u & 0x80000000 else u | 0x80000000
    return (ordered << 32) | (_M32 - int(col))


def key_column(key: int) -> int:
    """The column a key encodes."""
    return _M32 - (key & _M32)


_TOP = -(1 << 63)  # the int64 with only the top bit set


def argmax_keys(values: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``argmax_key`` of f32 ``values`` at int64 ``cols`` (same shape), with
    the top bit flipped: int64 tensors whose signed order is the keys'
    unsigned order (the kernel's keys output)."""
    v = torch.where(values == 0, torch.zeros_like(values), values)
    u = v.float().view(torch.int32).long() & _M32
    ordered = torch.where(u >= (1 << 31), ~u & _M32, u | (1 << 31))
    return ((ordered ^ (1 << 31)) << 32) | (_M32 - cols.long())


def keys_to_ids(keys: torch.Tensor) -> torch.Tensor:
    """The vocabulary ids of int64 argmax keys (``argmax_keys``' layout)."""
    return _M32 - (keys & _M32)


def bits_to_gumbel(bits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (any integer tensor holding values < 2^32) ->
    Gumbel(0, 1) f32: u = (top 24 bits + 0.5) * 2^-24, g = -log(-log(u)),
    the JAX package's transform, with one repair: for top bits 2^24 - 1 the
    f32 sum rounds to 2^24, u to 1.0 and g to +inf, a column that would win
    every argmax (padding and blocked EOS columns included); u is clamped
    to the largest f32 below 1 instead."""
    top24 = (bits.long() & _M32) >> 8
    u = torch.clamp((top24.float() + 0.5) * (2.0 ** -24), max=_U_MAX)
    return -torch.log(-torch.log(u))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32, the kernel's hash (a bijection of 32-bit words)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed2: torch.Tensor, rows: int, cols: int,
                 col0: int = 0) -> torch.Tensor:
    """The kernel's Gumbel draws as a (rows, cols) f32 tensor on seed2's
    device, for the global columns col0 .. col0 + cols - 1:
    bits = mix32(mix32(((row << 20) | col) ^ seed[0]) ^ seed[1])."""
    dev = seed2.device
    s = seed2.long() & _M32
    key = ((torch.arange(rows, device=dev)[:, None] << 20)
           | (col0 + torch.arange(cols, device=dev))[None, :])
    return bits_to_gumbel(_mix32(_mix32(key ^ s[0]) ^ s[1]))


def pack_lm_head(kernel_q, kernel_scale, input_scale=None,
                 eos_ids: Sequence[int] = (), block_n: int = 2048
                 ) -> Dict[str, Any]:
    """Pad the (D, V) int8 lm_head to a block_n-multiple vocabulary Vp and
    build the bias vectors, once per engine. Returns the JAX package's pack
    {q (Vp/bn, D, bn), scale, inv_input, pad_bias, eos_bias, block_n,
    vocab} plus ``qt``, the (Vp, D) K-contiguous storage the CUDA kernel
    reads; ``q`` is a view of it in the JAX layout, not a second copy."""
    w = kernel_q if isinstance(kernel_q, torch.Tensor) else torch.from_numpy(
        np.asarray(kernel_q))
    device = w.device
    d, v = w.shape
    bn = int(block_n)
    while bn > 128 and bn > v:  # tiny test vocabularies: the 128 floor
        bn //= 2
    vp = -(-v // bn) * bn
    qt = torch.zeros((vp, d), dtype=torch.int8, device=device)
    qt[:v] = w.t().to(device=device, dtype=torch.int8)
    scale = torch.ones(vp, dtype=torch.float32, device=device)
    scale[:v] = torch.as_tensor(kernel_scale, dtype=torch.float32,
                                device=device)
    pad_bias = torch.zeros(vp, dtype=torch.float32, device=device)
    pad_bias[v:] = _NEG
    eos_bias = torch.zeros(vp, dtype=torch.float32, device=device)
    for e in eos_ids:
        if 0 <= int(e) < v:
            eos_bias[int(e)] = _NEG
    inv_input = (1.0 / torch.as_tensor(input_scale, dtype=torch.float32,
                                       device=device)
                 if input_scale is not None
                 else torch.ones(d, dtype=torch.float32, device=device))
    return {"q": qt.view(vp // bn, bn, d).permute(0, 2, 1), "qt": qt,
            "scale": scale, "inv_input": inv_input, "pad_bias": pad_bias,
            "eos_bias": eos_bias, "block_n": bn, "vocab": v}


def pack_tied_embedding(embedding: torch.Tensor,
                        eos_ids: Sequence[int] = ()) -> Dict[str, Any]:
    """The pack of a tied-embedding lm_head (2B): the (V, D) table quantized
    per token (absmax / 127, round half to even, clip +-127), which is the
    kernel's (Vp, D) layout already. Greedy fused and exact (the bf16
    attend() product) are then no longer bit-identical."""
    w = embedding.float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    del w
    return pack_lm_head(q.t(), scale, eos_ids=eos_ids)


def _quantize_input(x: torch.Tensor, pack):
    xs = x.float() * pack["inv_input"][None]
    return _absmax_quant_rows(xs)


def fused_lm_sample_reference(x, pack, blocked, *, temperature: float,
                              noise: Optional[torch.Tensor] = None,
                              col0: int = 0, keys: bool = False):
    """The plain version: the exact int32 logits (float64 sums), the same
    f32 arithmetic in the same order as the kernel, then argmax (first
    occurrence). ``noise`` (B, Vp) f32, e.g. ``gumbel_noise(seed2, B, Vp,
    col0)``, is added when given; inv_temp is 1/T then (else 1). With
    ``keys`` the (B,) int64 argmax keys of the best columns, at global
    column ``col0`` + the pack's column (``argmax_keys``)."""
    xq, sx = _quantize_input(x, pack)
    qt = pack["qt"]
    acc = (xq.double() @ qt.double().t()).float()             # exact sums
    inv_temp = 1.0 / temperature if (noise is not None
                                     and temperature > 0) else 1.0
    logits = acc * sx[:, None] * pack["scale"][None]
    per = (logits * inv_temp + pack["pad_bias"][None]
           + blocked.float()[:, None] * pack["eos_bias"][None])
    if noise is not None:
        per = per + noise
    best = torch.argmax(per, dim=-1)
    if not keys:
        return best
    return argmax_keys(per.gather(1, best[:, None])[:, 0], best + col0)


# the kernel's workspace per device, stream and shape: xq (B, D) int8, sx
# (B,) f32, 3 counters and the (B,) argmax keys, all left at 0 by every
# launch; allocated at the first call of a shape, never per call. Two
# launches in flight at once must not share one: a CUDA graph keeps the
# workspace of the stream it was captured on, so its replay must not
# overlap another launch on that stream's.
_WORKSPACE: dict = {}


def _sample_workspace(device, stream: int, b: int, d: int):
    key = (device.index, stream, b, d)
    got = _WORKSPACE.get(key)
    if got is None:
        got = _WORKSPACE[key] = (
            torch.empty((b, d), dtype=torch.int8, device=device),
            torch.empty((b,), dtype=torch.float32, device=device),
            torch.zeros((3,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int64, device=device))
    return got


def _fused_lm_sample_cuda(x, pack, blocked, seed2, temperature, noise,
                          col0=0, keys=False):
    qt = pack["qt"]
    vp, d = qt.shape
    b = x.shape[0]
    if x.shape != (b, d) or blocked.shape != (b,):
        raise ValueError(f"fused_lm_sample: bad shapes x {tuple(x.shape)} "
                         f"blocked {tuple(blocked.shape)} pack ({vp}, {d})")
    if qt.dtype != torch.int8 or not qt.is_contiguous():
        raise TypeError("fused_lm_sample kernel takes the pack's contiguous "
                        "int8 (Vp, D) storage")
    if not x.is_floating_point():
        raise TypeError(f"fused_lm_sample kernel takes float x, not {x.dtype}")
    if d % 16 or vp % 128 or col0 < 0 or col0 + vp > (1 << 20) or b >= 4096:
        raise ValueError(f"fused_lm_sample kernel: D={d} must be a multiple "
                         f"of 16, Vp={vp} of 128, col0={col0} + Vp <= 2^20, "
                         f"B={b} < 4096")
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    x = x.contiguous()
    for label, t in (("x", x), ("pack qt", qt),
                     ("pack inv_input", pack["inv_input"])):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_lm_sample kernel: {label} is not "
                             "16-byte aligned")
    seed = seed2.to(device=x.device, dtype=torch.int32).contiguous()
    blk = blocked.to(device=x.device, dtype=torch.float32).contiguous()
    ids = torch.empty((b,), dtype=torch.int64, device=x.device)
    inv_temp = 1.0 / temperature if (noise and temperature > 0) else 1.0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = kernels.stream_of(x)
    lib = kernels.library()
    for r0 in range(0, b, SAMPLE_ROWS):
        rows = min(SAMPLE_ROWS, b - r0)
        plan = sample_plan(rows, d, vp, sms)
        ws = _sample_workspace(x.device, stream, rows, d)
        rc = lib.thinkdiff_fused_sample(
            kernels.ptr(x[r0:r0 + rows]), kernels.ptr(pack["inv_input"]),
            kernels.ptr(qt), kernels.ptr(pack["scale"]),
            kernels.ptr(pack["pad_bias"]), kernels.ptr(pack["eos_bias"]),
            kernels.ptr(blk[r0:r0 + rows]), kernels.ptr(seed),
            *map(kernels.ptr, ws), kernels.ptr(ids[r0:r0 + rows]), rows, d, vp,
            r0, int(col0), int(bool(keys)), float(inv_temp),
            int(bool(noise)), int(x.dtype == torch.float32), *plan, stream)
        kernels.check_launch(rc, "fused_lm_sample")
        kernels.count_launch("fused_lm_sample")
    return ids


def fused_lm_sample(x, pack, blocked, seed2, *, temperature: float,
                    noise: bool, col0: int = 0,
                    keys: bool = False) -> torch.Tensor:
    """x (B, D) float hidden states; pack from ``pack_lm_head``; blocked (B,)
    f32 (1.0 = EOS masked for the row); seed2 (2,) int32 on x's device
    (read only when noise). Returns (B,) int64 token ids; for a vocabulary
    shard whose first column is global column ``col0``, with ``keys`` the
    (B,) int64 argmax keys (``keys_to_ids`` of their MAX over the shards
    is the unsharded id).

    The QDense w8a8 lm_head semantics: x / input_scale in f32 -> per-row
    absmax int8 -> s8 x s8 product -> float(acc) * sx * kernel_scale."""
    if x.is_cuda:
        return _fused_lm_sample_cuda(x, pack, blocked, seed2, temperature,
                                     noise, col0, keys)
    if x.device.type == "cpu":
        g = (gumbel_noise(seed2, x.shape[0], pack["qt"].shape[0], col0)
             if noise else None)
        return fused_lm_sample_reference(x, pack, blocked,
                                         temperature=temperature, noise=g,
                                         col0=col0, keys=keys)
    raise NotImplementedError(f"fused_lm_sample: no kernel for {x.device}")
