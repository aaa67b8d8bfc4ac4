"""The w8a8 kernel's plan (``s8_gemm_plan``) at every shape the main paths
give it, and the wrappers' checks, which raise before any launch. CPU only:
the kernels themselves are held against their plain versions on the card
(tests/test_torch_gpu.py)."""

import pytest
import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops import int8_matmul as im

SMS = 132  # an H100's SMs

# (rows, contraction, output columns) of every w8a8 call on a main path:
# the flan-t5-xxl projections at the packed batch's 1024 rows and the
# lm_head at a CE chunk's 512, forward (#2) and input gradient (#7, the
# contraction over N); the 2B LM's projections at the dense decode (R8),
# the paged decode (R256) and a prefill chunk batch (R4096); the 7B LM's at
# lvlm-text's decode (R16) and prefill (R2048)
_TRAIN = ((1024, 4096, 12288), (1024, 4096, 4096), (1024, 4096, 8192),
          (1024, 4096, 20480), (1024, 10240, 4096), (512, 4096, 32128))
_2B = ((1536, 2048), (1536, 1536), (1536, 17920), (8960, 1536))
_7B = ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584))
MAIN_PATH_SHAPES = sorted(
    set(_TRAIN) | {(r, n, k) for r, k, n in _TRAIN}
    | {(r, k, n) for r in (8, 256, 4096) for k, n in _2B}
    | {(r, k, n) for r in (16, 2048) for k, n in _7B})


@pytest.mark.parametrize("r,k,n", MAIN_PATH_SHAPES)
def test_s8_gemm_plan_fits_and_fills_the_card(r, k, n):
    """Shared memory within the block's limit; 64-row tiles only where the
    call has at most 64 rows; a split of the contraction only where the
    tiles alone are short of a wave, with no split empty (the C entry
    refuses one), and then the busiest SM walks fewer K slices than it
    would unsplit."""
    bm, bn, stages, split = im.s8_gemm_plan(r, k, n, SMS)
    assert im.s8_gemm_smem(bm, bn, stages) <= im.SMEM_LIMIT
    assert 2 <= stages <= im.S8_MAX_STAGES and bn in (128, 256)
    assert bm == (64 if r <= 64 else 128)
    steps = -(-k // im.S8_BLOCK_K)
    per = -(-steps // split)
    assert 1 <= split <= im.S8_MAX_SPLIT
    assert (split - 1) * per < steps <= split * per
    units = -(-r // bm) * -(-n // bn)
    if units >= SMS:
        assert split == 1
    if split > 1:
        assert -(-units * split // SMS) * per < steps


@pytest.mark.parametrize("r,k,n,split", [
    (256, 8960, 1536, True), (16, 18944, 3584, True), (8, 8960, 1536, True),
    (16, 3584, 4608, False), (256, 1536, 2048, False), (8, 1536, 1536, False),
    (1024, 4096, 20480, False), (512, 32128, 4096, False)])
def test_s8_gemm_plan_splits_where_the_grid_is_short(r, k, n, split):
    """The long contractions of a short grid split: the serving R256 and
    dense R8 down (70 K slices), the 7B R16 down (148). The shorter ones
    (the 2B qkv and o, 12 K slices; the 7B qkv, 28) do not: the split's
    fixed cost outweighs its gain. Neither do wi_fused (640 tiles) and the
    lm_head chunk's input gradient (128 tiles of 128 x 128 over 132
    SMs)."""
    assert (im.s8_gemm_plan(r, k, n, SMS)[3] > 1) == split


def _misaligned(shape):
    """An int8 tensor whose start is one byte past a 16-byte boundary."""
    n = shape[0] * shape[1]
    return torch.zeros(n + 16, dtype=torch.int8)[1:n + 1].view(shape)


_FWD_BAD = {
    "k_not_16": (lambda: (torch.zeros(4, 40, dtype=torch.int8),
                          torch.zeros(40, 32, dtype=torch.int8)), ValueError),
    "n_not_16": (lambda: (torch.zeros(4, 64, dtype=torch.int8),
                          torch.zeros(64, 40, dtype=torch.int8)), ValueError),
    "xq_unaligned": (lambda: (_misaligned((4, 64)),
                              torch.zeros(64, 32, dtype=torch.int8)),
                     ValueError),
    "w_float": (lambda: (torch.zeros(4, 64, dtype=torch.int8),
                         torch.zeros(64, 32)), TypeError),
}
_BWD_BAD = {
    "n_not_16": (lambda: (torch.zeros(4, 40, dtype=torch.int8),
                          torch.zeros(64, 40, dtype=torch.int8)), ValueError),
    "k_not_8": (lambda: (torch.zeros(4, 64, dtype=torch.int8),
                         torch.zeros(66, 64, dtype=torch.int8)), ValueError),
    "w_not_row_major": (lambda: (torch.zeros(4, 64, dtype=torch.int8),
                                 torch.zeros(64, 32, dtype=torch.int8).t()),
                        ValueError),
    "gq_unaligned": (lambda: (_misaligned((4, 64)),
                              torch.zeros(32, 64, dtype=torch.int8)),
                     ValueError),
}


@pytest.fixture
def no_launch(monkeypatch):
    """Fail where a wrapper reaches the kernel library."""
    def library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(kernels, "library", library)
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("case", sorted(_FWD_BAD))
def test_s8_matmul_kernel_wrapper_raises_before_launch(no_launch, case):
    make, err = _FWD_BAD[case]
    xq, w = make()
    with pytest.raises(err):
        im._s8_matmul_cuda(xq, torch.ones(xq.shape[0]), w,
                           torch.ones(w.shape[1]), torch.bfloat16)


@pytest.mark.parametrize("case", sorted(_BWD_BAD))
def test_s8_matmul_bwd_kernel_wrapper_raises_before_launch(no_launch, case):
    make, err = _BWD_BAD[case]
    gq, w = make()
    with pytest.raises(err):
        im._s8_matmul_bwd_cuda(gq, torch.ones(gq.shape[0]), w, torch.bfloat16)


# s8_matmul_qx (#12): the flan-t5-xxl training shapes the ops phase and the
# kernel table use, R33 / R300 edges, and short grids where #2's plan splits
QX_SHAPES = [(1024, 4096, 20480), (1024, 4096, 4096), (1024, 4096, 12288),
             (33, 128, 128), (300, 4096, 1552), (1, 4096, 4096),
             (64, 8192, 1024), (16, 18944, 3584), (256, 8960, 1536)]


def _qx_busiest(r, n, bm, bn):
    """Units of the busiest CTA of the kernel's persistent grid (s8_grid:
    min(units, SMS) CTAs, CTA c taking units c, c + grid, ...)."""
    units = -(-r // bm) * -(-n // bn)
    grid = min(units, SMS)
    return max(len(range(c, units, grid)) for c in range(grid)), units, grid


@pytest.mark.parametrize("r,k,n", QX_SHAPES)
def test_s8_qx_plan_fits_covers_and_fills(r, k, n):
    """The quantize-in-kernel GEMM's plan: shared memory within the limit
    (its flags included) with the ring as deep as fits, row tiles a whole
    number of quantization tickets (8 rows), the CTAs' shares of the
    tiles within one of each other and one CTA an SM wherever there are
    that many tiles, and of the two column widths the one whose busiest
    CTA does the least work (tiles x width), the wider on a tie."""
    bm, bn, stages = im.s8_qx_plan(r, k, n, SMS)
    assert im.s8_gemm_smem(bm, bn, stages) <= im.SMEM_LIMIT
    assert (stages == im.S8_MAX_STAGES
            or im.s8_gemm_smem(bm, bn, stages + 1) > im.SMEM_LIMIT)
    assert bm % 8 == 0 and bn in (128, 256) and 2 <= stages <= im.S8_MAX_STAGES
    busiest, units, grid = _qx_busiest(r, n, bm, bn)
    assert busiest * grid - units < grid  # within one tile of the mean
    assert grid == min(units, SMS)
    work = {w: _qx_busiest(r, n, bm, w)[0] * w for w in (128, 256)}
    assert work[bn] == min(work.values())
    assert bn == 256 or work[128] < work[256]


@pytest.mark.parametrize("r,k,n", [
    (1024, 4096, 20480), (1024, 4096, 4096),
    (64, 8192, 1024), (16, 18944, 3584)])
def test_s8_qx_plan_is_the_gemm_tile_without_a_split(r, k, n):
    """The kernel takes no split of the contraction, so its plan is #2's
    tile where #2 does not split (the training shapes: 640 and 128 tiles
    of 32 K slices); where #2 splits a short grid over a long
    contraction, the qx plan keeps the same rows a tile and one launch."""
    plan = im.s8_qx_plan(r, k, n, SMS)
    gemm = im.s8_gemm_plan(r, k, n, SMS)
    assert len(plan) == 3 and plan[0] == gemm[0]
    if gemm[3] == 1:
        assert plan == gemm[:3]


_QX_BAD = {
    "k_not_16": (lambda: (torch.zeros(4, 40), torch.zeros(40, 32, dtype=torch.int8)),
                 ValueError),
    "n_not_16": (lambda: (torch.zeros(4, 64), torch.zeros(64, 40, dtype=torch.int8)),
                 ValueError),
    "x_3d": (lambda: (torch.zeros(2, 4, 64), torch.zeros(64, 32, dtype=torch.int8)),
             ValueError),
    "x_half": (lambda: (torch.zeros(4, 64, dtype=torch.float16),
                        torch.zeros(64, 32, dtype=torch.int8)), TypeError),
    "w_float": (lambda: (torch.zeros(4, 64), torch.zeros(64, 32)), TypeError),
    "x_unaligned": (lambda: (torch.zeros(4 * 64 + 4)[1:257].view(4, 64),
                             torch.zeros(64, 32, dtype=torch.int8)), ValueError),
}


@pytest.mark.parametrize("case", sorted(_QX_BAD))
def test_s8_matmul_qx_kernel_wrapper_raises_before_launch(no_launch, case):
    make, err = _QX_BAD[case]
    x, w = make()
    with pytest.raises(err):
        im._s8_matmul_qx_cuda(x, w, torch.ones(w.shape[-1]), torch.bfloat16)
