"""The port's hand-written kernels on a CUDA card, held against their plain
PyTorch versions on the same inputs. Marked ``gpu``: without a card every
test skips. JAX-free, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops.flash_attention import flash_attention, mha_reference
from thinkdiff_torch.ops.int8_matmul import s8_matmul, s8_matmul_reference
from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference
from thinkdiff_torch.ops.quant import _absmax_quant_rows, quantize_weight

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.library()  # build once; a compile error fails here
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _randn(shape, seed, device, dtype=torch.bfloat16):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        device=device, dtype=dtype)


# flash attention: bf16 in and out. Tolerance 2e-2 + 2e-2*|ref|: the kernel
# rounds P to bf16 before the PV product (as the Pallas kernel does), and
# both outputs round to bf16 (ulp 2^-7 of the value).
FLASH_CASES = {
    "vision_d80": dict(b=2, hq=4, hkv=4, tq=200, tk=200, d=80),
    "lm_prefill_d128": dict(b=2, hq=12, hkv=2, tq=130, tk=130, d=128,
                            causal=True, pad_bias=True),
    "d64_kv_mask": dict(b=2, hq=2, hkv=1, tq=70, tk=90, d=64, kv_mask=True),
    "d64_segments": dict(b=2, hq=2, hkv=2, tq=96, tk=96, d=64, segments=True),
    "d128_full_bias_scale1": dict(b=1, hq=2, hkv=2, tq=65, tk=33, d=128,
                                  full_bias=True, sm_scale=1.0),
    # q, k, v as (B, T, H, D) memory seen as (B, H, T, D): the vision
    # block's fused qkv slices and T5's head-transposed projections
    "strided_d80_vision": dict(b=2, hq=16, hkv=16, tq=260, tk=260, d=80,
                               strided=True),
    "strided_d64_t5_self": dict(b=2, hq=8, hkv=8, tq=96, tk=96, d=64,
                                strided=True, causal=True, full_bias=True,
                                sm_scale=1.0, segments=True),
    # the greedy T5 decode: a few query rows over 411 conditioning rows
    "decode_tq32_tk411_kv_mask": dict(b=1, hq=8, hkv=8, tq=32, tk=411, d=64,
                                      strided=True, kv_mask=True,
                                      sm_scale=1.0),
    "decode_tq3_tk411_kv_mask": dict(b=2, hq=4, hkv=4, tq=3, tk=411, d=64,
                                     kv_mask=True),
    # a T5 decode step's self-attention: an odd length and the relative
    # bias in the layout the T5 layer gives it (rows padded to 16 bytes)
    "decode_self_t15_rel_bias": dict(b=1, hq=8, hkv=8, tq=15, tk=15, d=64,
                                     causal=True, full_bias=True,
                                     padded_bias=True, sm_scale=1.0),
    "ragged_tail_tk1000": dict(b=1, hq=2, hkv=2, tq=130, tk=1000, d=128),
    "ragged_tail_tk1000_d80": dict(b=1, hq=2, hkv=2, tq=70, tk=1000, d=80),
    "causal_t300": dict(b=2, hq=2, hkv=2, tq=300, tk=300, d=64, causal=True),
    "gqa_12_2_pad_bias_t300": dict(b=2, hq=12, hkv=2, tq=300, tk=300, d=128,
                                   causal=True, pad_bias=True, strided=True),
    "d80_full_bias": dict(b=1, hq=2, hkv=2, tq=130, tk=200, d=80,
                          full_bias=True),
    # FLUX.1-dev's joint attention: 128 aligned tokens + a 1024² image's
    # 4096, and embedding_type "both"'s 411 + 4096 (no tile multiple), the
    # q/k/v head-transposed views of the projections, held at
    # FLUX_FLASH_REL * max|ref| (``scaled``); CLIP-L's causal layer
    "flux_joint_t4224": dict(b=1, hq=24, hkv=24, tq=4224, tk=4224, d=128,
                             strided=True, scaled=True),
    "flux_joint_ragged_t4507": dict(b=1, hq=24, hkv=24, tq=4507, tk=4507,
                                    d=128, strided=True, scaled=True),
    "clip_l_causal_t77": dict(b=1, hq=12, hkv=12, tq=77, tk=77, d=64,
                              strided=True, causal=True),
    # BLIP-2's ViT-g: 16 heads of 88 over 257 tokens, as its block hands
    # them over (head-transposed views of three 1408-wide projections, no
    # copy: 176-byte head offsets, 2816-byte rows), and contiguous; block_q
    # 64 and 128 at a few query rows
    "vit_g_d88_t257": dict(b=2, hq=16, hkv=16, tq=257, tk=257, d=88),
    "vit_g_d88_projection_views": dict(b=2, hq=16, hkv=16, tq=257, tk=257,
                                       d=88, projection=True),
    "d88_kv_mask_tq40": dict(b=2, hq=2, hkv=2, tq=40, tk=257, d=88,
                             kv_mask=True),
    "d88_causal_t130": dict(b=1, hq=4, hkv=4, tq=130, tk=130, d=88,
                            causal=True),
    # CogVideoX-5b's joint attention at D64, q/k/v views of contiguous
    # (B, T, H, D) tensors: 226 text tokens + one latent frame's 1,350
    # (T1576, a 40-row tail) at its 48 heads, and the 49-frame length
    # (T17776, a 112-row tail) at two heads (the full 48:
    # test_cogvideox_joint_attention_full_shape)
    "cogvideox_joint_t1576_d64": dict(b=1, hq=48, hkv=48, tq=1576, tk=1576,
                                      d=64, projection=True, scaled=True),
    "cogvideox_joint_t17776_d64_h2": dict(b=1, hq=2, hkv=2, tq=17776,
                                          tk=17776, d=64, projection=True,
                                          scaled=True),
    # the CoBSAT scorer's CLIP-L ViT: 32 images, 16 heads of 64 over 257
    # tokens, bidirectional, head-transposed views of the projections
    "clip_l_vision_b32_t257_d64": dict(b=32, hq=16, hkv=16, tq=257, tk=257,
                                       d=64, projection=True),
    # Llama-2-7B in a LoRA step: B4 H32 T512 D128, causal
    "llama_causal_b4_t512_d128": dict(b=4, hq=32, hkv=32, tq=512, tk=512,
                                      d=128, projection=True, causal=True),
}


# FLUX's joint rows spread the softmax over ~T/e keys, so |out| ~ 0.025 and
# the absolute floor above would pass a kernel that lost a whole tile: they
# are held at 2e-2 * max|ref| (~4e-3; the kernel errs 9.8e-4, one bf16 ulp
# of the largest outputs), chip_smoke.py's FLUX_FLASH_REL
FLUX_FLASH_REL = 2e-2


def _flash_inputs(cuda, b, hq, hkv, tq, tk, d, strided, projection=False):
    if projection:  # (B, T, H * D) projections seen as (B, H, T, D)
        return tuple(_randn((b, t, h * d), s, cuda).reshape(b, t, h, d)
                     .transpose(1, 2) for t, h, s in ((tq, hq, 0), (tk, hkv, 1),
                                                       (tk, hkv, 2)))
    if not strided:
        return (_randn((b, hq, tq, d), 0, cuda), _randn((b, hkv, tk, d), 1, cuda),
                _randn((b, hkv, tk, d), 2, cuda))
    q = _randn((b, tq, 3, hq, d), 0, cuda)[:, :, 1].transpose(1, 2)
    kv = _randn((b, tk, 2, hkv, d), 1, cuda)
    return q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case):
    from thinkdiff_torch.ops.flash_attention import (
        _forward_cuda, kernel_bias, logsumexp_reference)

    c = dict(FLASH_CASES[case])
    b, hq, hkv, tq, tk, d = (c.pop(k) for k in ("b", "hq", "hkv", "tq", "tk", "d"))
    q, k, v = _flash_inputs(cuda, b, hq, hkv, tq, tk, d, c.get("strided"),
                            c.get("projection", False))
    kw = dict(causal=c.get("causal", False), sm_scale=c.get("sm_scale"))
    if c.get("pad_bias"):
        lens = torch.tensor([tk, tk - 37], device=cuda)
        valid = torch.arange(tk, device=cuda)[None] < lens[:, None]
        kw["bias"] = (1.0 - valid.float())[:, None, None, :] * -1e30
    if c.get("full_bias"):
        kw["bias"] = _randn((1, hq, tq, tk), 3, cuda, torch.float32) * 0.5
        if c.get("padded_bias"):
            kw["bias"] = kernel_bias(kw["bias"])
    if c.get("kv_mask"):
        lens = torch.tensor([[tk - 11 * (i % 2) - tk // 2 * (i % 2)]
                             for i in range(b)], device=cuda)
        kw["kv_mask"] = (torch.arange(tk, device=cuda)[None] < lens).int()
    if c.get("segments"):
        seg = (torch.arange(tq, device=cuda)[None] // 40 + 1).repeat(b, 1)
        seg[1, -10:] = 0
        kw["q_segment_ids"] = kw["kv_segment_ids"] = seg
    before = kernels.launch_counts()["flash_attention_fwd"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1
    ref = mha_reference(q, k, v, **kw)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    if c.get("scaled"):
        tol = FLUX_FLASH_REL * ref.float().abs().max()
    else:
        tol = 2e-2 + 2e-2 * ref.float().abs()
    assert (err <= tol).all(), float(err.max())
    # the lse the backward reads: a few f32 ulps (chip_smoke.py's LSE_TOL)
    args = (kw.get("bias"), kw.get("kv_mask"), kw["causal"],
            kw["sm_scale"] or d ** -0.5, kw.get("q_segment_ids"),
            kw.get("kv_segment_ids"))
    _, lse = _forward_cuda(q, k, v, *args, with_lse=True)
    lse_ref = logsumexp_reference(q, k, *args)
    assert float((lse - lse_ref).abs().max()) <= 3e-5


def test_flash_attention_d88_refuses_an_unaligned_view(cuda):
    """A D = 88 view whose start is 8 bytes off a 16-byte boundary is no
    operand for the tensor maps: the kernel raises and launches nothing
    (it never copies), while the aligned view next to it runs."""
    from thinkdiff_torch.ops.flash_attention import _tma_fits

    buf = _randn((1, 64, 4, 96), 0, cuda)
    bad = buf[..., 4:92].transpose(1, 2)
    good = buf[..., 8:96].transpose(1, 2)
    assert not _tma_fits(bad) and _tma_fits(good)
    before = kernels.launch_counts()["flash_attention_fwd"]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(bad, good, good)
    assert kernels.launch_counts()["flash_attention_fwd"] == before
    out = flash_attention(good, good, good)
    ref = mha_reference(good, good, good)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("t", [4224, 4507])
def test_flux_flash_limit_rejects_planted_faults(cuda, t):
    """The FLUX rows' limit is tight enough to matter: on their inputs, the
    plain version with one 128-key tile skipped, or with the ragged tail of
    T4507 dropped, errs beyond FLUX_FLASH_REL * max|ref| against the sound
    plain version, while the kernel stays within it."""
    q, k, v = _flash_inputs(cuda, 1, 24, 24, t, t, 128, True)
    ref = mha_reference(q, k, v).float()
    limit = FLUX_FLASH_REL * float(ref.abs().max())
    assert float((flash_attention(q, k, v).float() - ref).abs().max()) <= limit
    keeps = [torch.cat([torch.arange(2048), torch.arange(2176, t)])]
    if t % 128:
        keeps.append(torch.arange(t - t % 128))
    for keep in keeps:
        keep = keep.to(cuda)
        out = mha_reference(q, k[:, :, keep], v[:, :, keep]).float()
        assert float((out - ref).abs().max()) > limit


def test_cogvideox_joint_attention_full_shape(cuda):
    """B1 H48 T17776 D64 as the CogVideoX block hands it over: one launch,
    within FLUX_FLASH_REL * max|ref| of mha_reference taken two heads at a
    time (the whole f32 score tensor would take 61 GB), and that limit
    rejects a skipped 128-key tile and the dropped 112-key tail."""
    t, h = 17776, 48
    q, k, v = _flash_inputs(cuda, 1, h, h, t, t, 64, False, projection=True)
    plain = lambda q, k, v: torch.cat([mha_reference(
        q[:, i:i + 2], k[:, i:i + 2], v[:, i:i + 2]) for i in range(0, h, 2)],
        dim=1).float()
    before = kernels.launch_counts()["flash_attention_fwd"]
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1
    ref = plain(q, k, v)
    limit = FLUX_FLASH_REL * float(ref.abs().max())
    assert float((out.float() - ref).abs().max()) <= limit
    for keep in (torch.cat([torch.arange(2048), torch.arange(2176, t)]),
                 torch.arange(t - t % 128)):
        keep = keep.to(cuda)
        bad = plain(q, k[:, :, keep], v[:, :, keep])
        assert float((bad - ref).abs().max()) > limit


def test_flash_attention_all_masked_rows(cuda):
    """Rows whose keys are all masked get the plain version's uniform
    softmax over the Tk keys and an lse of -1e30: a batch row with no valid
    key, and query rows whose segment id no key carries."""
    from thinkdiff_torch.ops.flash_attention import (
        _forward_cuda, logsumexp_reference)

    b, h, tq, tk, d = 2, 4, 150, 200, 64
    q, k, v = _flash_inputs(cuda, b, h, h, tq, tk, d, True)
    kv_mask = torch.ones((b, tk), dtype=torch.int32, device=cuda)
    kv_mask[1] = 0
    q_seg = torch.ones((b, tq), dtype=torch.int32, device=cuda)
    q_seg[0, -20:] = 0  # no key has segment 0
    kv_seg = torch.ones((b, tk), dtype=torch.int32, device=cuda)
    args = (None, kv_mask, False, d ** -0.5, q_seg, kv_seg)
    out, lse = _forward_cuda(q, k, v, *args, with_lse=True)
    torch.cuda.synchronize()
    ref = mha_reference(q, k, v, *args)
    uniform = v.float().mean(dim=2, keepdim=True)  # the uniform softmax
    assert (out[1].float() - uniform[1]).abs().max() <= 2e-2
    assert (out[0, :, -20:].float() - uniform[0]).abs().max() <= 2e-2
    err = (out.float() - ref.float()).abs()
    assert (err <= 2e-2 + 2e-2 * ref.float().abs()).all(), float(err.max())
    lse_ref = logsumexp_reference(q, k, *args)
    neg_big = float(torch.tensor(-1e30))  # -1e30 in f32
    assert torch.equal(lse[1], lse_ref[1]) and float(lse[1].max()) == neg_big
    assert float((lse - lse_ref).abs().max()) <= 3e-5


def test_flash_attention_kernel_rejects_what_tma_cannot_take(cuda):
    """No fallback: a head dim outside {64, 80, 88, 128}, a head dim that is not
    contiguous, or a start that is not 16-byte aligned raises."""
    q = _randn((1, 2, 64, 96), 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = _randn((1, 2, 64, 128), 0, cuda)[..., ::2]
    with pytest.raises(ValueError, match="strides"):
        flash_attention(q, q, q)
    q = _randn((1, 2, 64, 68), 0, cuda)[..., 4:]
    with pytest.raises(ValueError, match="strides"):
        flash_attention(q, q, q)


# (R, K, N) of the w8a8 forward: ragged R (1, 17, 65, 333), K and N that
# are not multiples of the 128-byte K slice or of the tile (4112, 9872,
# 32128), every shape whose plan splits the contraction (the serving R256
# and dense R8 down, the 7B R16 down) and the 7B R16 qkv
S8_FWD_SHAPES = [(1, 64, 16), (8, 1536, 2048), (300, 8960, 1536),
                 (130, 1536, 17920), (1, 4096, 4096), (17, 4112, 1536),
                 (65, 4096, 9872), (333, 4112, 4096), (512, 4096, 32128),
                 (256, 8960, 1536), (16, 18944, 3584), (8, 8960, 1536),
                 (16, 3584, 4608)]


@pytest.mark.parametrize("r,k,n", S8_FWD_SHAPES)
def test_s8_matmul_kernel_exact(cuda, r, k, n):
    """Exact int32 sums and the same f32 epilogue: within 1 bf16 ulp (in
    practice equal) of the float64 plain version, in one launch whatever
    the plan's split."""
    x = _randn((r, k), 4, cuda, torch.float32)
    w = _randn((k, n), 5, cuda, torch.float32) * 0.02
    xq, sx = _absmax_quant_rows(x)
    qw = quantize_weight(w)
    before = kernels.launch_counts()["s8_matmul"]
    out = s8_matmul(xq, sx, qw["q"], qw["scale"])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["s8_matmul"] == before + 1
    ref = s8_matmul_reference(xq, sx, qw["q"], qw["scale"])
    err = (out.float() - ref.float()).abs()
    assert (err <= _bf16_ulp(ref)).all(), float(err.max())


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("r,k,n", [(256, 8960, 1536), (16, 18944, 3584),
                                   (65, 4112, 9872)])
def test_s8_split_gives_the_bits_of_no_split(cuda, monkeypatch, bwd, r, k, n):
    """Every split of the contraction (the plan's, none, and others, ring
    depths 2 and the deepest) and both tile widths give the same bits."""
    from thinkdiff_torch.ops import int8_matmul as im

    xq, sx = _absmax_quant_rows(_randn((r, k), 6, cuda, torch.float32))
    w = quantize_weight(_randn((k, n), 7, cuda, torch.float32))
    plan = im.s8_gemm_plan
    if bwd:  # contraction over k: gq (R, k), the weight (n, k) row-major
        w_nk = w["q"].t().contiguous()
        run = lambda: im.s8_matmul_bwd(xq, sx, w_nk)
    else:
        run = lambda: im.s8_matmul(xq, sx, w["q"], w["scale"])
    bm, _, _, chosen = plan(r, k, n)  # (rows, contraction, columns) both ways
    ref = run()
    outs = []
    for bn in (128, 256):
        for split in sorted({1, 2, 5, chosen}):
            for stages in (2, max(s for s in range(2, 9)
                                  if im.s8_gemm_smem(bm, bn, s)
                                  <= im.SMEM_LIMIT)):
                monkeypatch.setattr(im, "s8_gemm_plan", lambda *a, c=(
                    bm, bn, stages, split): c)
                outs.append(run())
    monkeypatch.setattr(im, "s8_gemm_plan", plan)
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, ref)


def test_s8_matmul_kernel_rejects_unaligned_k(cuda):
    xq = torch.zeros((4, 40), dtype=torch.int8, device=cuda)
    w = torch.zeros((40, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        s8_matmul(xq, torch.ones(4, device=cuda), w, torch.ones(32, device=cuda))


@pytest.mark.parametrize("rows,d,dtype", [
    (24 * 4224, 128, torch.bfloat16), (24 * 4507, 128, torch.bfloat16),
    (7, 64, torch.float32), (4096, 1536, torch.bfloat16),
    (33, 1280, torch.bfloat16), (5, 1000, torch.bfloat16),
    (3, 1001, torch.float32)] + [
    (r, d, dt) for r in (1, 7, 4096) for d in (1536, 3584, 4096)
    for dt in (torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    x = _randn((rows, d), 6, cuda, dtype) * 3.0
    scale = _randn((d,), 7, cuda, dtype)
    out = rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    ref = rmsnorm_reference(x, scale, 1e-6)
    err = (out.float() - ref.float()).abs()
    # reduction order differs from the plain version's: 1 bf16 ulp, or f32
    # rounding of a 1e-6-relative sum difference
    tol = _bf16_ulp(ref) if dtype == torch.bfloat16 else 1e-5 * (
        1 + ref.float().abs())
    assert (err <= tol).all(), float(err.max())


def _paged_inputs(cuda, slots, h, hkv, page, lengths, seed=0):
    """bf16 pools with each slot's pages drawn from a shuffled free list,
    page 0 (trash) and every position past a slot's length filled with
    garbage that must not leak into the output."""
    rs = np.random.RandomState(seed)
    d = 128
    mp = max(-(-int(n) // page) for n in lengths)
    npages = [-(-int(n) // page) for n in lengths]
    ids = rs.permutation(np.arange(1, 1 + sum(npages) + 3))
    table = np.zeros((slots, mp), np.int32)
    o = 0
    for s, n in enumerate(npages):
        table[s, :n] = ids[o:o + n]
        o += n
    pool = len(ids) + 1
    k = _randn((pool, hkv, page, d), seed + 1, cuda)
    v = _randn((pool, hkv, page, d), seed + 2, cuda)
    k[0], v[0] = 3e3, -3e3
    for s, n in enumerate(lengths):
        off = int(n) % page
        if off:
            last = int(table[s, npages[s] - 1])
            k[last, :, off:], v[last, :, off:] = 1e3, -1e3
    q = _randn((slots, h, d), seed + 3, cuda)
    return (q, k, v, torch.from_numpy(table).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))


# paged decode: bf16 pools, f32 softmax in both; tolerance 4e-3 + 1e-2*|ref|
# covers the bf16 rounding of both outputs (up to one ulp apart, 2^-8 at
# |ref| < 1) and another summation order
@pytest.mark.parametrize("slots,h,hkv,page,lengths", [
    (6, 12, 2, 64, [1, 64, 65, 130, 600, 7]),
    (4, 8, 2, 16, [1, 16, 17, 100]),
    (3, 4, 4, 64, [200, 3, 129]),
    (5, 28, 4, 64, [1, 64, 65, 640, 333]),      # G 7, the 7B's geometry
    (4, 16, 2, 32, [31, 32, 33, 320]),          # G 8, page 32
    (3, 12, 2, 16, [1, 1024, 16]),              # a slot of MP x page
])
def test_paged_attention_kernel_matches_plain(cuda, slots, h, hkv, page,
                                              lengths):
    from thinkdiff_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    q, k, v, table, lens = _paged_inputs(cuda, slots, h, hkv, page, lengths)
    before = kernels.launch_counts()["paged_attention"]
    out = paged_attention(q, k, v, table, lens)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == before + 1
    ref = paged_attention_reference(q, k, v, table, lens)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert (err <= 4e-3 + 1e-2 * ref.float().abs()).all(), float(err.max())


def _paged_check(out, ref, live):
    err = (out.float() - ref.float()).abs()[live]
    assert torch.isfinite(out.float()).all()
    assert (err <= 4e-3 + 1e-2 * ref.float().abs()[live]).all(), float(err.max())


@pytest.mark.parametrize("page", [16, 64])
def test_paged_attention_every_plan_matches_plain(cuda, monkeypatch, page):
    """Every unit size the plan can pick (1 stage .. all of MP), with the
    units of a slot combined in the same launch, agrees with the plain
    version; a slot of length 0, whose output is not defined, reads no page
    and gets zeros, never NaN (the gather formulation averages its masked
    positions instead); the trash page is poisoned."""
    from thinkdiff_torch.ops import paged_attention as pa

    lengths = [0, 1, 64, 65, 7 * page + 3, 9 * page, 300, 2]
    q, k, v, table, lens = _paged_inputs(cuda, 8, 12, 2, page, lengths)
    ref = pa.paged_attention_reference(q, k, v, table, lens)
    live = lens > 0
    mp, pps = table.shape[1], 64 // page
    for ppu in range(pps, mp + pps, pps):
        monkeypatch.setattr(pa, "paged_plan", lambda *a, c=ppu: c)
        out = pa.paged_attention(q, k, v, table, lens.long())
        torch.cuda.synchronize()
        _paged_check(out, ref, live)
        assert (out[~live] == 0).all()


def test_paged_attention_repeats_and_graph_replays_give_the_same_bits(cuda):
    """Two calls give the same bits, the second allocates no workspace, and
    a launch captured in a CUDA graph and replayed on new queries and
    lengths gives the eager call's bits: the split's counters are back at 0
    after every launch."""
    from thinkdiff_torch.ops import paged_attention as pa

    lengths = [640, 1, 65, 300, 600, 2, 129, 640] * 4
    q, k, v, table, lens = _paged_inputs(cuda, 32, 12, 2, 64, lengths)
    assert -(-table.shape[1] // pa.paged_plan(32, 2, table.shape[1], 64,
                                             132)) > 1  # split
    first = pa.paged_attention(q, k, v, table, lens)
    held = dict(pa._WORKSPACE)
    assert torch.equal(first, pa.paged_attention(q, k, v, table, lens))
    assert pa._WORKSPACE == held  # no allocation after the first call
    qs, ls = q.clone(), lens.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(qs, k, v, table, ls)  # the stream's workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = pa.paged_attention(qs, k, v, table, ls)
    for seed in (5, 6):
        qs.copy_(_randn(tuple(q.shape), seed, cuda))
        ls.copy_(torch.flip(lens, (0,)) if seed == 6 else lens)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pa.paged_attention(qs, k, v, table, ls))


def _sample_case(cuda, b, d, v, seed=0):
    from thinkdiff_torch.ops.fused_sample import pack_lm_head

    w = _randn((d, v), seed, cuda, torch.float32) * 0.05
    qw = quantize_weight(w)
    pack = pack_lm_head(qw["q"], qw["scale"], eos_ids=[3, v - 1])
    x = _randn((b, d), seed + 1, cuda, torch.float32)
    blocked = (torch.arange(b, device=cuda) % 3 == 0).float()
    return x, pack, blocked


@pytest.mark.parametrize("b,d,v", [(5, 64, 300), (64, 1536, 20000),
                                   (130, 1536, 5000), (256, 1536, 20000),
                                   (1, 1536, 5000), (8, 1536, 20000),
                                   (17, 1536, 5000), (200, 1536, 5000),
                                   (16, 3584, 5000), (64, 3584, 3000)])
@pytest.mark.parametrize("noise", [False, True])
def test_fused_sample_kernel_matches_plain(cuda, b, d, v, noise):
    """Ids identical to the plain version on the same inputs: exact int32
    sums, the same f32 operations in the same order, and with noise the
    same keyed Gumbel draws (gumbel_noise)."""
    from thinkdiff_torch.ops.fused_sample import (
        fused_lm_sample, fused_lm_sample_reference, gumbel_noise)

    x, pack, blocked = _sample_case(cuda, b, d, v)
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=cuda)
    got = fused_lm_sample(x, pack, blocked, seed, temperature=0.6,
                          noise=noise)
    torch.cuda.synchronize()
    g = gumbel_noise(seed, b, pack["qt"].shape[0]) if noise else None
    want = fused_lm_sample_reference(x, pack, blocked, temperature=0.6,
                                     noise=g)
    assert torch.equal(got, want)
    assert (got < v).all()
    assert not ((blocked > 0) & ((got == 3) | (got == v - 1))).any()


def _sample_check(x, pack, blocked, seed, noise):
    from thinkdiff_torch.ops.fused_sample import (
        fused_lm_sample, fused_lm_sample_reference, gumbel_noise)

    got = fused_lm_sample(x, pack, blocked, seed, temperature=0.6,
                          noise=noise)
    torch.cuda.synchronize()
    g = gumbel_noise(seed, x.shape[0], pack["qt"].shape[0]) if noise else None
    want = fused_lm_sample_reference(x, pack, blocked, temperature=0.6,
                                     noise=g)
    return got, want


@pytest.mark.parametrize("b", [16, 64])
def test_fused_sample_bf16_x_with_input_scales(cuda, b):
    """The serving path's input: bf16 hidden states, and a pack with input
    scales (x * inv_input before the row's absmax, one rounded product)."""
    from thinkdiff_torch.ops.fused_sample import pack_lm_head

    d, v = 3584, 4000
    qw = quantize_weight(_randn((d, v), 60, cuda, torch.float32) * 0.05)
    iscale = torch.from_numpy(np.random.RandomState(61).rand(d).astype(
        np.float32) + 0.5).to(cuda)
    pack = pack_lm_head(qw["q"], qw["scale"], input_scale=iscale,
                        eos_ids=[3])
    x = _randn((b, d), 62, cuda)
    blocked = (torch.arange(b, device=cuda) % 2 == 0).float()
    seed = torch.tensor([5, 6], dtype=torch.int32, device=cuda)
    for noise in (False, True):
        got, want = _sample_check(x, pack, blocked, seed, noise)
        assert torch.equal(got, want)


def _sample_plans(b, d, vp, sms):
    """Every plan the kernel takes for b rows: the batch tiles sample_plan
    picks, rings of 2, 3 and the deepest, one CTA, a few, and one an SM."""
    from thinkdiff_torch.ops import fused_sample as fs

    n, tiles = fs.sample_plan(b, d, vp, sms)[:2]
    blocks = vp // fs.SAMPLE_BLOCK
    fit = [s for s in range(2, fs.SAMPLE_MAX_STAGES + 1)
           if fs.sample_smem(n, tiles, s) <= fs.SMEM_LIMIT]
    return [(n, tiles, stages, ctas)
            for stages in sorted({2, 3, max(fit)})
            for ctas in sorted({1, min(3, blocks), min(blocks, sms)})]


@pytest.mark.parametrize("b,d,v", [(5, 1536, 3000), (64, 1536, 9000),
                                   (130, 256, 3000), (16, 3584, 2000)])
def test_fused_sample_every_plan_matches_plain(cuda, monkeypatch, b, d, v):
    """Rings of 2, 3 and the deepest, CTAs from one
    (every block in one CTA) to one an SM (one block a CTA at some shapes:
    one warpgroup idle; odd counts: one warpgroup a block more): the ids
    of the plain version, with and without noise."""
    from thinkdiff_torch.ops import fused_sample as fs

    x, pack, blocked = _sample_case(cuda, b, d, v, seed=3)
    seed = torch.tensor([77, -5], dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    vp = pack["qt"].shape[0]
    plans = _sample_plans(b, d, vp, sms)
    assert len(plans) >= 3
    for plan in plans:
        monkeypatch.setattr(fs, "sample_plan", lambda *a, c=plan: c)
        for noise in (False, True):
            got, want = _sample_check(x, pack, blocked, seed, noise)
            assert torch.equal(got, want), (plan, noise)


def test_fused_sample_repeats_graph_replays_and_two_streams(cuda):
    """One launch a call; two calls give the same ids and allocate no
    workspace; a launch captured in a CUDA graph and replayed on new hidden
    states gives the eager call's ids (the keys and counters are back at 0
    after every launch); two streams at once, each with its own workspace,
    give the ids of each call alone."""
    from thinkdiff_torch.ops import fused_sample as fs

    x, pack, blocked = _sample_case(cuda, 64, 1536, 20000, seed=4)
    seed = torch.tensor([11, 12], dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()["fused_lm_sample"]
    first = fs.fused_lm_sample(x, pack, blocked, seed, temperature=0.6,
                               noise=True)
    assert kernels.launch_counts()["fused_lm_sample"] == before + 1
    held = dict(fs._WORKSPACE)
    assert torch.equal(first, fs.fused_lm_sample(
        x, pack, blocked, seed, temperature=0.6, noise=True))
    assert fs._WORKSPACE == held
    xs = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fs.fused_lm_sample(xs, pack, blocked, seed, temperature=0.6,
                           noise=True)  # the stream's workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fs.fused_lm_sample(xs, pack, blocked, seed, temperature=0.6,
                                 noise=True)
    for s in (5, 6):
        xs.copy_(_randn((64, 1536), s, cuda, torch.float32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fs.fused_lm_sample(
            xs, pack, blocked, seed, temperature=0.6, noise=True))
    xs2 = [_randn((64, 1536), s, cuda, torch.float32) for s in (7, 8)]
    alone = [fs.fused_lm_sample(a, pack, blocked, seed, temperature=0.6,
                                noise=True) for a in xs2]
    streams = [torch.cuda.Stream() for _ in xs2]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for i, (st, a) in enumerate(zip(streams, xs2)):
            with torch.cuda.stream(st):
                outs[i].append(fs.fused_lm_sample(
                    a, pack, blocked, seed, temperature=0.6, noise=True))
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert torch.equal(o, alone[i])


# flash backward (dq kernel with delta, dk/dv kernel) vs the plain FA2
# backward on the same bf16 inputs and the kernel forward's lse. The kernels
# round P and dS to bf16 for their products and dq/dk/dv to bf16 at the end
# (2^-8 relative each); the plain version keeps f32. Tolerance: 1.5e-2 of
# the tensor's largest magnitude, twice the largest error chip_smoke.py
# measured at the training shapes (0.0075).
BWD_CASES = {
    "t5_self": dict(b=2, hq=4, hkv=4, tq=256, tk=256, d=64, causal=True,
                    rel_bias=True, segments=True),
    "t5_cross": dict(b=2, hq=4, hkv=4, tq=200, tk=256, d=64, kv_mask=True,
                     segments=True),
    "ragged_causal": dict(b=1, hq=2, hkv=2, tq=77, tk=77, d=64, causal=True),
    "gqa_d128": dict(b=2, hq=8, hkv=2, tq=130, tk=90, d=128, kv_mask=True),
    # Tq != Tk, neither a multiple of a tile; the causal keys past Tq see no
    # row (a dk/dv CTA with no q tile writes zeros)
    "ragged_200x333": dict(b=2, hq=4, hkv=4, tq=200, tk=333, d=64,
                           causal=True, rel_bias=True, kv_mask=True),
    # a bias without a query axis ((B, 1, 1, Tk), read once a key)
    "row_bias_d128": dict(b=2, hq=4, hkv=2, tq=100, tk=150, d=128,
                          row_bias=True, causal=True),
    "row_bias_d64": dict(b=2, hq=4, hkv=4, tq=130, tk=70, d=64,
                         row_bias=True, kv_mask=True),
    # more key tiles than the dq ring holds (sweep 1 reloads every tile
    # through the ring), and more q tiles than the dk/dv ring holds
    "reload_rel_bias_256x1024": dict(b=2, hq=4, hkv=4, tq=256, tk=1024, d=64,
                                     rel_bias=True, reload=True),
    "reload_causal_d128": dict(b=2, hq=4, hkv=2, tq=640, tk=640, d=128,
                               causal=True, kv_mask=True, reload=True),
    # D = 128 with Tq <= 64: the 128-row dq CTA, its second warpgroup past Tq
    "short_d128": dict(b=2, hq=4, hkv=4, tq=48, tk=200, d=128, row_bias=True,
                       kv_mask=True),
    # Llama-2-7B in a LoRA step: B4 H32 T512 D128, causal
    "llama_causal_b4_t512_d128": dict(b=4, hq=32, hkv=32, tq=512, tk=512,
                                      d=128, causal=True),
}


def _bwd_inputs(cuda, c):
    b, hq, hkv, tq, tk, d = (c[k] for k in ("b", "hq", "hkv", "tq", "tk", "d"))
    q = _randn((b, hq, tq, d), 20, cuda)
    k = _randn((b, hkv, tk, d), 21, cuda)
    v = _randn((b, hkv, tk, d), 22, cuda)
    do = _randn((b, hq, tq, d), 23, cuda)
    kw = dict(bias=None, kv_mask=None, causal=c.get("causal", False),
              sm_scale=1.0 if d == 64 else d ** -0.5, q_segment_ids=None,
              kv_segment_ids=None)
    if c.get("rel_bias"):
        kw["bias"] = _randn((1, hq, tq, tk), 24, cuda, torch.float32) * 0.5
    if c.get("row_bias"):
        kw["bias"] = _randn((b, 1, 1, tk), 25, cuda, torch.float32)
    if c.get("kv_mask"):
        kw["kv_mask"] = (torch.arange(tk, device=cuda)[None]
                         < torch.tensor([[tk], [tk - 31]], device=cuda)[:b]).int()
    if c.get("segments"):
        qs = (torch.arange(tq, device=cuda)[None] // 50 + 1).repeat(b, 1)
        ks = (torch.arange(tk, device=cuda)[None] // 60 + 1).repeat(b, 1)
        qs[1, -20:] = 0            # pad query rows
        ks[:, -16:] = 0
        if tq == tk:
            ks = qs.clone()
        else:                      # pad keys masked: pad rows see no key
            kw["kv_mask"] = (ks > 0).int()
        kw["q_segment_ids"], kw["kv_segment_ids"] = qs.int(), ks.int()
    return q, k, v, do, kw


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_kernels_match_plain(cuda, case):
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        logsumexp_reference)

    from thinkdiff_torch.ops.flash_attention import flash_bwd_tiles

    c = BWD_CASES[case]
    q, k, v, do, kw = _bwd_inputs(cuda, c)
    args = [kw[n] for n in ("bias", "kv_mask", "causal", "sm_scale",
                            "q_segment_ids", "kv_segment_ids")]
    if c.get("reload"):  # the case reaches the ring's reuse in both kernels
        (_, _, dq_stages), (_, _, dkv_stages) = flash_bwd_tiles(
            c["tq"], c["tk"], c["d"], "tile" if c.get("rel_bias") else None)
        assert -(-c["tk"] // 64) > dq_stages
        assert -(-c["tq"] // 64) > dkv_stages
    qr = q.detach().requires_grad_(True)
    out = flash_attention(qr, k, v, **kw)  # the forward kernel, with lse
    lse = logsumexp_reference(q, k, *args)
    before = kernels.launch_counts()
    got = flash_attention_backward(q, k, v, *args, lse, do)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_attention_dq"] == before["flash_attention_dq"] + 1
    assert after["flash_attention_dkv"] == before["flash_attention_dkv"] + 1
    want = flash_attention_backward_reference(q, k, v, *args, lse, do)
    for g, w, n in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all(), n
        err = (g.float() - w.float()).abs().max()
        assert err <= 1.5e-2 * w.float().abs().max(), (n, float(err))
    # through autograd: the same kernels from the saved forward lse
    out.backward(do)
    assert (qr.grad.float() - want[0].float()).abs().max() <= (
        1.5e-2 * want[0].float().abs().max())


@pytest.mark.parametrize("cross", [False, True])
def test_flash_backward_takes_the_t5_layout_without_copies(cuda, cross):
    """q, k, v as the T5 layer hands them (head-transposed views of the
    fused qkv / q and kv_fused projections) and dO the head-transposed view
    of a contiguous (B, T, H*D) gradient: the kernels match the plain
    version, dq, dk, dv come back as views of (B, T, H, D) memory, and the
    backward allocates its outputs and delta, no copy of an operand."""
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        kernel_bias, logsumexp_reference)

    b, h, t, d = 2, 4, 256, 64
    heads = lambda x: x.reshape(b, t, h, d).transpose(1, 2)
    seg = (torch.arange(t, device=cuda)[None] // 50 + 1).repeat(b, 1).int()
    seg[1, -20:] = 0
    if cross:
        q = heads(_randn((b, t, h * d), 30, cuda))
        k, v = (heads(x) for x in _randn((b, t, 2 * h * d), 31, cuda).split(
            h * d, dim=-1))
        kenc = (torch.arange(t, device=cuda)[None] // 70 + 1).repeat(b, 1)
        kenc = kenc.int()
        kenc[:, -16:] = 0
        kw = dict(bias=None, kv_mask=(kenc > 0).int(), causal=False,
                  sm_scale=1.0, q_segment_ids=seg, kv_segment_ids=kenc)
    else:
        q, k, v = (heads(x) for x in _randn((b, t, 3 * h * d), 32, cuda).split(
            h * d, dim=-1))
        kw = dict(bias=kernel_bias(_randn((1, h, t, t), 33, cuda,
                                          torch.float32) * 0.5),
                  kv_mask=None, causal=True, sm_scale=1.0, q_segment_ids=seg,
                  kv_segment_ids=seg)
    do = heads(_randn((b, t, h * d), 34, cuda))
    args = [kw[n] for n in ("bias", "kv_mask", "causal", "sm_scale",
                            "q_segment_ids", "kv_segment_ids")]
    lse = logsumexp_reference(q, k, *args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = flash_attention_backward(q, k, v, *args, lse, do)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    outs = sum(g.numel() * g.element_size() for g in got) + lse.numel() * 4
    assert extra <= outs + 4096, (extra, outs)  # a copy of q is 262144 B
    want = flash_attention_backward_reference(q, k, v, *args, lse, do)
    for g, w, n in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.transpose(1, 2).is_contiguous(), (n, g.stride())
        err = (g.float() - w.float()).abs().max()
        assert err <= 1.5e-2 * w.float().abs().max(), (n, float(err))


def test_flash_backward_pad_rows_add_exactly_nothing(cuda):
    """Pad query rows of a packed cross-attention see no key: with their dO
    poisoned (1e4), dq is 0 there and dk, dv are bit-identical to the run
    with that dO zeroed."""
    from thinkdiff_torch.ops.flash_attention import (
        _allowed, _forward_cuda, flash_attention_backward,
        logsumexp_reference)

    q, k, v, do, kw = _bwd_inputs(cuda, BWD_CASES["t5_cross"])
    args = [kw[n] for n in ("bias", "kv_mask", "causal", "sm_scale",
                            "q_segment_ids", "kv_segment_ids")]
    ok = _allowed(q, k, kw["kv_mask"], False, kw["q_segment_ids"],
                  kw["kv_segment_ids"])
    dead = ~ok.any(-1)            # (B, 1, Tq)
    assert dead.any()
    lse = logsumexp_reference(q, k, *args)
    _, lse_k = _forward_cuda(q, k, v, *args, with_lse=True)
    assert torch.isfinite(lse_k).all()
    live = dead.logical_not()[..., None].to(do.dtype)
    poisoned = torch.where(dead[..., None], torch.full_like(do, 1e4), do)
    a = flash_attention_backward(q, k, v, *args, lse_k, poisoned)
    b = flash_attention_backward(q, k, v, *args, lse_k, do * live)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.float()).all() for x in a)
    assert (a[0].float() * dead[..., None]).abs().max() == 0
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    # the kernel's lse is the plain logsumexp on every row with a key
    # (a few f32 ulps: 7.6e-6 measured at the training shapes)
    err = (lse_k - lse).abs()[dead.logical_not().expand_as(lse)]
    assert err.max() <= 3e-5, float(err.max())


@pytest.mark.parametrize("r,k,n", [
    (1, 64, 16), (333, 4096, 4096), (130, 4096, 16 * 617), (512, 4096, 32128),
    (17, 4104, 1536), (65, 4112, 4096), (1, 4096, 20480), (1024, 4096, 20480),
    (256, 1536, 8960), (16, 3584, 18944)])
def test_s8_matmul_bwd_kernel_identical(cuda, r, k, n):
    """Exact int32 sums and the same f32 epilogue, rounded to bf16 once:
    identical to the float64 plain version, in one launch (ragged R; K =
    4104, 4112 and N = 9872, 32128 not multiples of the tile; the
    contraction of the lm_head chunk and wi_fused; the split shapes N 8960
    at R256 and N 18944 at R16)."""
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul_bwd, s8_matmul_bwd_reference)

    g = _randn((r, n), 25, cuda, torch.float32)
    gq, sg = _absmax_quant_rows(g)
    w = quantize_weight(_randn((k, n), 26, cuda, torch.float32))["q"]
    before = kernels.launch_counts()["s8_matmul_bwd"]
    out = s8_matmul_bwd(gq, sg, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["s8_matmul_bwd"] == before + 1
    assert torch.equal(out, s8_matmul_bwd_reference(gq, sg, w))


def test_autograd_step_through_w8a8_and_rmsnorm(cuda):
    """x -> rmsnorm (Triton forward, plain backward) -> w8a8 QDense (s8
    forward, s8 input-gradient backward from the (K, N) copy): the kernels
    launch, and x's gradient agrees with the same step through the plain
    versions on the CPU (bf16 activations, int8 requantization of each
    side's own dy: 2e-2 of the largest element)."""
    from thinkdiff_torch.models.qdense import QDense
    from thinkdiff_torch.models.bridge import load_params

    qw = quantize_weight(_randn((256, 384), 27, cuda, torch.float32) * 0.05)
    params = {"kernel_q": qw["q"].cpu(), "kernel_scale": qw["scale"].cpu(),
              "input_scale": torch.ones(256)}
    grads = []
    for dev in (cuda, torch.device("cpu")):
        layer = load_params(QDense(256, 384, torch.bfloat16, "w8a8",
                                   device=dev, train_layout=True), params)
        x = _randn((3, 40, 256), 28, dev).requires_grad_(True)
        scale = _randn((256,), 29, dev).requires_grad_(True)
        kernels.reset_launch_counts()
        y = layer(rmsnorm(x, scale))
        (y.float() ** 2).mean().backward()
        counts = kernels.launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert counts["rmsnorm"] == 1 and counts["s8_matmul"] == 1
            assert counts["s8_matmul_bwd"] == 1
        grads.append((x.grad.float().cpu(), scale.grad.float().cpu()))
    for g, w in zip(*grads):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max() <= 2e-2 * w.abs().max()


def test_w8a8_backward_without_the_kn_copy_raises(cuda):
    """A serving QDense keeps no (K, N) row-major copy: its backward on the
    card raises rather than copying the int8 weight on every call."""
    from thinkdiff_torch.models.qdense import QDense
    from thinkdiff_torch.models.bridge import load_params

    qw = quantize_weight(_randn((256, 384), 30, cuda, torch.float32))
    layer = load_params(QDense(256, 384, torch.bfloat16, "w8a8", device=cuda),
                        {"kernel_q": qw["q"].cpu(),
                         "kernel_scale": qw["scale"].cpu(),
                         "input_scale": torch.ones(256)})
    assert layer.kernel_q_kn is None
    x = _randn((4, 256), 31, cuda).requires_grad_(True)
    y = layer(x)
    before = kernels.launch_counts()["s8_matmul_bwd"]
    with pytest.raises(ValueError, match="row-major"):
        y.float().sum().backward()
    assert kernels.launch_counts()["s8_matmul_bwd"] == before


def _qdense_layout(w_q: torch.Tensor) -> torch.Tensor:
    """A (K, N) int8 weight as QDense keeps it: the transpose view of an
    (N, K) row-major copy, the storage the weight-only kernels read."""
    return w_q.t().contiguous().t()


def _int8_weight(k, n, seed, cuda):
    qw = quantize_weight(_randn((k, n), seed, cuda, torch.float32) * 0.05)
    return _qdense_layout(qw["q"]), qw["scale"]


# the weight-only GEMV: bf16 x and output; exact products (int8 and bf16 in
# bf16 mma, f32 sums), so the kernel and the plain f32 product differ by the
# order of their f32 sums only and round to bf16 once each: one bf16 ulp of
# the value, plus 1e-5 of the largest output where a sum near zero makes
# that ulp smaller than the f32 summation error
@pytest.mark.parametrize("r,k,n", [(1, 4096, 32128), (32, 4096, 32128),
                                   (8, 4096, 4096), (17, 10240, 4096),
                                   (3, 64, 48), (32, 4096, 10240),
                                   (70, 256, 96), (15, 4096, 4096),
                                   (16, 4096, 10240), (31, 10240, 4096),
                                   (1, 512, 16), (16, 1040, 4112)])
def test_int8_matmul_kernel_within_one_ulp(cuda, r, k, n):
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference)

    x = _randn((r, k), 40, cuda)
    w, s = _int8_weight(k, n, 41, cuda)
    before = kernels.launch_counts()["int8_matmul"]
    out = int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int8_matmul"] == before + -(-r // 32)
    ref = int8_matmul_reference(x, w, s)
    assert out.dtype == torch.bfloat16 and out.shape == (r, n)
    err = (out.float() - ref.float()).abs()
    tol = _bf16_ulp(ref) + 1e-5 * ref.float().abs().max()
    assert (err <= tol).all(), float(err.max())


def test_int8_matmul_kernel_f32(cuda):
    """f32 x is split into three bf16 terms in the kernel: its products are
    exact, so an f32 output agrees with the plain f32 product to 1e-5 of
    its largest element."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference)

    x = _randn((5, 512), 42, cuda, torch.float32) * 3.0
    w, s = _int8_weight(512, 384, 43, cuda)
    out = int8_matmul(x, w, s)
    ref = int8_matmul_reference(x, w, s)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("xt,yt", [(torch.float32, torch.float32),
                                   (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("r,k,n", [(1, 4096, 4096), (17, 4096, 10240),
                                   (32, 1040, 16)])
def test_int8_matmul_kernel_f32_in_and_out(cuda, xt, yt, r, k, n):
    """f32 x (three bf16 terms, exact products) and f32 y, split and not:
    within 1e-5 of the largest output of the plain f32 product, and one
    bf16 ulp more where y is bf16."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference)

    x = _randn((r, k), 45, cuda, xt) * 3.0
    w, s = _int8_weight(k, n, 46, cuda)
    out = int8_matmul(x, w, s, yt)
    ref = int8_matmul_reference(x, w, s, torch.float32)
    assert out.dtype == yt
    tol = 1e-5 * ref.abs().max() + (_bf16_ulp(ref) if yt == torch.bfloat16
                                    else 0.0)
    assert ((out.float() - ref).abs() <= tol).all()


@pytest.mark.parametrize("r,k,n", [(8, 4096, 4096), (32, 4096, 10240),
                                   (1, 10240, 4096), (16, 4096, 32128)])
def test_int8_gemv_every_plan_matches_plain(cuda, monkeypatch, r, k, n):
    """Every unit width, splits of K from none to one stage a range, CTAs
    from one to a unit each (two an SM among them, which a 3-stage ring
    lets co-reside), and ring depths 3 and the deepest that fits all agree
    with the plain version to its tolerance."""
    from thinkdiff_torch.ops import int8_matmul as im

    x = _randn((r, k), 47, cuda)
    w, s = _int8_weight(k, n, 48, cuda)
    ref = im.int8_matmul_reference(x, w, s)
    tol = _bf16_ulp(ref) + 1e-5 * ref.float().abs().max()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for block_n in im.GEMV_BLOCKS:
        steps = -(-k // (im.GEMV_STAGE_BYTES // block_n))
        tiles = -(-n // block_n)
        deepest = max(st for st in range(2, im.GEMV_MAX_STAGES + 1)
                      if im.gemv_smem(r, False, st, block_n) <= im.SMEM_LIMIT)
        for per in sorted({1, 2, 3, steps // 2 or 1, steps}):
            units = tiles * -(-steps // per)
            for ctas in sorted({1, units // 3 + 1, min(units, sms),
                                min(units, 2 * sms)}):
                for stages in sorted({3, deepest}):
                    plan = (block_n, per, stages, ctas)
                    monkeypatch.setattr(im, "gemv_plan", lambda *a, c=plan: c)
                    out = im.int8_matmul(x, w, s)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs()
                    assert (err <= tol).all(), (plan, float(err.max()))


def test_int8_gemv_split_co_resident_on_two_streams(cuda, monkeypatch):
    """A split plan at two CTAs an SM with a 3-stage ring (two kernels'
    CTAs share the SMs), launched on two streams at once, each stream with
    its own workspace: every launch gives the bits of one call alone."""
    from thinkdiff_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    w, s = _int8_weight(4096, 32128, 53, cuda)
    xs = [_randn((8, 4096), seed, cuda) for seed in (54, 55)]
    plan = (128, 16, 3, 2 * sms)  # 251 tiles x 2 K ranges
    monkeypatch.setattr(im, "gemv_plan", lambda *a: plan)
    alone = [im.int8_matmul(x, w, s) for x in xs]
    for a, x in zip(alone, xs):
        ref = im.int8_matmul_reference(x, w, s).float()
        tol = _bf16_ulp(ref) + 1e-5 * ref.abs().max()
        assert ((a.float() - ref).abs() <= tol).all()
    streams = [torch.cuda.Stream() for _ in xs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                outs[i].append(im.int8_matmul(x, w, s))
    torch.cuda.synchronize()
    for i in range(2):
        for out in outs[i]:
            assert torch.equal(out, alone[i])


def test_int8_gemv_repeats_and_graph_replays_give_the_same_bits(cuda):
    """Two calls give the same bits, the second allocates no workspace, and
    a launch captured in a CUDA graph and replayed on new inputs gives the
    eager call's bits: the split's counters are back at 0 after every
    launch."""
    from thinkdiff_torch.ops import int8_matmul as im

    w, s = _int8_weight(10240, 1024, 49, cuda)
    x = _randn((32, 10240), 50, cuda)
    block_n, per = im.gemv_plan(32, 10240, 1024, 132)[:2]
    assert -(-(10240 // (im.GEMV_STAGE_BYTES // block_n)) // per) > 1  # split
    first = im.int8_matmul(x, w, s)
    held = dict(im._GEMV_WORKSPACE)
    assert torch.equal(first, im.int8_matmul(x, w, s))
    assert im._GEMV_WORKSPACE == held
    xs = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(xs, w, s)  # the stream's workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = im.int8_matmul(xs, w, s)
    for seed in (51, 52):
        xs.copy_(_randn((32, 10240), seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, im.int8_matmul(xs, w, s))


def test_int8_matmul_kernel_rejects_unaligned_k(cuda):
    from thinkdiff_torch.ops.int8_matmul import int8_matmul

    x = _randn((4, 40), 44, cuda)
    with pytest.raises(ValueError, match="K=40"):
        int8_matmul(x, torch.zeros((40, 32), dtype=torch.int8, device=cuda),
                    torch.ones(32, device=cuda))


@pytest.mark.parametrize("r,k,n,dtype", [(300, 1024, 1552, torch.bfloat16),
                                         (1024, 4096, 4096, torch.bfloat16),
                                         (33, 256, 96, torch.float32)])
def test_int8_matmul_wide_kernels_match_plain(cuda, r, k, n, dtype):
    """Forward (#10) and input gradient (#11), directly and through
    autograd, against the plain versions, which round x and g * scale to
    bf16 as the kernels do: 2e-2 of the largest element (the JAX test's
    tolerance; in practice f32 summation order and one bf16 rounding)."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul_wide, int8_matmul_wide_bwd, int8_matmul_wide_bwd_reference,
        int8_matmul_wide_fwd, int8_matmul_wide_fwd_reference)

    x = _randn((r, k), 45, cuda, dtype)
    g = _randn((r, n), 46, cuda, dtype)
    w, s = _int8_weight(k, n, 47, cuda)
    y = int8_matmul_wide_fwd(x, w, s)
    dx = int8_matmul_wide_bwd(g, w, s, dtype)
    torch.cuda.synchronize()
    for got, want in ((y, int8_matmul_wide_fwd_reference(x, w, s)),
                      (dx, int8_matmul_wide_bwd_reference(g, w, s, dtype))):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max(), float(err)
    xr = x.detach().requires_grad_(True)
    before = kernels.launch_counts()
    out = int8_matmul_wide(xr, w, s)
    out.backward(g)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["int8_matmul_wide_fwd"] == before["int8_matmul_wide_fwd"] + 1
    assert after["int8_matmul_wide_bwd"] == before["int8_matmul_wide_bwd"] + 1
    assert torch.equal(out, y) and torch.equal(xr.grad, dx)


def _wide_operands(r, k, n, dtype, cuda):
    x = _randn((r, k), 53, cuda, dtype)
    g = _randn((r, n), 54, cuda, dtype)
    w, s = _int8_weight(k, n, 55, cuda)
    return x, g, w, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,k,n", [(1, 4096, 4112), (33, 1552, 4096),
                                   (411, 4096, 8192), (1000, 4112, 1552),
                                   (1000, 1552, 10240)])
def test_int8_matmul_wide_ragged_shapes(cuda, r, k, n, dtype):
    """#10 and #11 at ragged row counts and at K and N that are multiples of
    16 but not of the tile (the TMA copies read zeros past the edges, the
    TMA stores clip), in bf16 and f32, against the plain versions (2e-2 of
    the largest element, the JAX test's tolerance), one launch each and the
    same bits on a second call."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul_wide_bwd, int8_matmul_wide_bwd_reference,
        int8_matmul_wide_fwd, int8_matmul_wide_fwd_reference)

    x, g, w, s = _wide_operands(r, k, n, dtype, cuda)
    before = kernels.launch_counts()
    y = int8_matmul_wide_fwd(x, w, s)
    dx = int8_matmul_wide_bwd(g, w, s, dtype)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["int8_matmul_wide_fwd"] == before["int8_matmul_wide_fwd"] + 1
    assert after["int8_matmul_wide_bwd"] == before["int8_matmul_wide_bwd"] + 1
    for got, want in ((y, int8_matmul_wide_fwd_reference(x, w, s)),
                      (dx, int8_matmul_wide_bwd_reference(g, w, s, dtype))):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max(), float(err)
    assert torch.equal(int8_matmul_wide_fwd(x, w, s), y)
    assert torch.equal(int8_matmul_wide_bwd(g, w, s, dtype), dx)


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("r,k,n,dtype", [(411, 4096, 8192, torch.bfloat16),
                                         (1000, 1552, 4112, torch.bfloat16),
                                         (33, 4096, 1552, torch.float32)])
def test_int8_wide_every_plan_gives_the_same_bits(cuda, monkeypatch, bwd, r,
                                                  k, n, dtype):
    """Both tile widths at ring depths 2 and the deepest that fits (the plan
    picks among these by shape) give the plan's own bits: each output's sum
    runs over the contraction in one order, with no split or atomics."""
    from thinkdiff_torch.ops import int8_matmul as im

    x, g, w, s = _wide_operands(r, k, n, dtype, cuda)
    f32_g = bwd and dtype == torch.float32
    if bwd:
        run = lambda: im.int8_matmul_wide_bwd(g, w, s, dtype)
    else:
        run = lambda: im.int8_matmul_wide_fwd(x, w, s)
    ref = run()
    plan = im.wide_plan
    outs = []
    for bn in (128, 256):
        fits = [st for st in range(2, im.WIDE_MAX_STAGES + 1)
                if im.wide_smem(bn, st, bwd, f32_g) <= im.SMEM_LIMIT]
        for stages in sorted({fits[0], fits[-1]}) if fits else ():
            monkeypatch.setattr(im, "wide_plan", lambda *a, c=(bn, stages): c)
            outs.append(run())
    monkeypatch.setattr(im, "wide_plan", plan)
    torch.cuda.synchronize()
    assert outs  # f32 g fits one unit and a two-stage ring only
    for out in outs:
        assert torch.equal(out, ref)


def test_int8_matmul_wide_autograd_launches_once_each(cuda):
    """Through autograd at lvlm-text's kv_fused shape: one forward and one
    input-gradient launch, and the gradient the direct call gives."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul_wide, int8_matmul_wide_bwd)

    x, g, w, s = _wide_operands(411, 4096, 8192, torch.bfloat16, cuda)
    xr = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    int8_matmul_wide(xr, w, s).backward(g)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "int8_matmul_wide_fwd": 1, "int8_matmul_wide_bwd": 1}
    assert torch.equal(xr.grad, int8_matmul_wide_bwd(g, w, s, torch.bfloat16))


@pytest.mark.parametrize("r,k,n,dtype", [(33, 128, 128, torch.float32),
                                         (300, 4096, 1552, torch.bfloat16),
                                         (1024, 4096, 4096, torch.bfloat16),
                                         (300, 4096, 1552, torch.float32),
                                         (8, 4096, 4096, torch.bfloat16),
                                         (64, 8192, 1024, torch.bfloat16)])
def test_s8_matmul_qx_kernel_identical(cuda, r, k, n, dtype):
    """Per-row scales, IEEE division, round half to even and exact int32
    sums: identical to the plain pre-pass chain, with an all-zero row (the
    1e-30 scale floor) and exact halves at scale 1."""
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul_qx, s8_matmul_qx_reference)

    x = _randn((r, k), 48, cuda, torch.float32) * 3.0
    x[1] = 0.0
    x[2] = 0.0
    x[2, :4] = torch.tensor([127.0, 0.5, -1.5, 2.5])
    x = x.to(dtype)
    w, s = _int8_weight(k, n, 49, cuda)
    before = kernels.launch_counts()["s8_matmul_qx"]
    out = s8_matmul_qx(x, w, s, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["s8_matmul_qx"] == before + 1
    assert torch.equal(out, s8_matmul_qx_reference(x, w, s, dtype))


def test_weight_only_qdense_takes_the_gemv_at_32_rows(cuda):
    """A weight-only QDense launches the GEMV at <= 32 rows and not above,
    and agrees with the same layer on the CPU (bf16 outputs of the same
    function: one bf16 ulp, plus the ulp lost where the CPU's wide branch
    rounds its product to bf16 before the scale)."""
    from thinkdiff_torch.models.bridge import load_params
    from thinkdiff_torch.models.qdense import QDense

    qw = quantize_weight(_randn((256, 384), 50, cuda, torch.float32) * 0.05)
    params = {"kernel_q": qw["q"].cpu(), "kernel_scale": qw["scale"].cpu()}
    for rows, gemv in ((8, True), (32, True), (40, False)):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            layer = load_params(QDense(256, 384, torch.bfloat16, True,
                                       device=dev), params)
            x = _randn((rows, 256), 51, dev)
            before = kernels.launch_counts()["int8_matmul"]
            outs.append(layer(x).float().cpu())
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert (kernels.launch_counts()["int8_matmul"]
                        == before + int(gemv))
        got, want = outs
        assert ((got - want).abs() <= 2 * _bf16_ulp(want)
                + 1e-5 * want.abs().max()).all()


def test_activation_scale_on_the_card_is_a_reciprocal_product(cuda):
    """The per-row scale the card's plain quantization computes, which the
    quantize-in-kernel GEMM reproduces: PyTorch's CUDA division by a Python
    scalar multiplies by its f32 reciprocal, so the scale is max(amax,
    1e-30) * fl(1/127), bit for bit, where the CPU divides."""
    x = _randn((512, 4096), 52, cuda, torch.float32) * 3.0
    _, s = _absmax_quant_rows(x)
    amax = torch.clamp(x.abs().amax(dim=-1), min=1e-30)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        127.0, dtype=torch.float32)
    assert torch.equal(s, amax * inv.to(cuda))
    _, s_cpu = _absmax_quant_rows(x.cpu())
    assert torch.equal(s_cpu, amax.cpu() / torch.tensor(127.0))


@pytest.mark.parametrize("xt,yt", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_s8_matmul_qx_mixed_dtypes_identical(cuda, xt, yt):
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul_qx, s8_matmul_qx_reference)

    x = (_randn((200, 1024), 70, cuda, torch.float32) * 3.0).to(xt)
    w, s = _int8_weight(1024, 2048, 71, cuda)
    out = s8_matmul_qx(x, w, s, yt)
    torch.cuda.synchronize()
    assert out.dtype == yt
    assert torch.equal(out, s8_matmul_qx_reference(x, w, s, yt))


@pytest.mark.parametrize("r,k,n", [(300, 4096, 1552), (64, 2048, 2048)])
def test_s8_qx_every_plan_identical(cuda, monkeypatch, r, k, n):
    """Both row tiles and both column widths, rings of 2, 3 and the
    deepest, bf16 and f32 out: identical to the plain pre-pass chain."""
    from thinkdiff_torch.ops import int8_matmul as im

    x = _randn((r, k), 72, cuda, torch.float32) * 3.0
    x[3] = 0.0
    w, s = _int8_weight(k, n, 73, cuda)
    for yt in (torch.bfloat16, torch.float32):
        want = im.s8_matmul_qx_reference(x, w, s, yt)
        for bm in (64, 128):
            for bn in (128, 256):
                fit = [st for st in range(2, im.S8_MAX_STAGES + 1)
                       if im.s8_gemm_smem(bm, bn, st) <= im.SMEM_LIMIT]
                for stages in sorted({2, 3, max(fit)}):
                    plan = (bm, bn, stages)
                    monkeypatch.setattr(im, "s8_qx_plan",
                                        lambda *a, c=plan: c)
                    out = im.s8_matmul_qx(x, w, s, yt)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (plan, yt)


def test_s8_qx_repeats_graph_replays_and_two_streams(cuda):
    """One launch a call; repeated calls give the same bits and allocate
    no workspace; a CUDA-graph replay on new x gives the eager call's bits
    (ticket, ready and exit counters back at 0 after every launch); two
    streams at once give each call's bits alone. One row (32 tiles of 64
    x 128: a short grid) and 1024 (128 tiles of 128 x 256)."""
    from thinkdiff_torch.ops import int8_matmul as im

    w, s = _int8_weight(4096, 4096, 74, cuda)
    for r in (1, 1024):
        x = _randn((r, 4096), 75, cuda) * 3.0
        before = kernels.launch_counts()["s8_matmul_qx"]
        first = im.s8_matmul_qx(x, w, s)
        assert kernels.launch_counts()["s8_matmul_qx"] == before + 1
        held = dict(im._QX_WORKSPACE)
        assert torch.equal(first, im.s8_matmul_qx(x, w, s))
        assert im._QX_WORKSPACE == held
        xs = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            im.s8_matmul_qx(xs, w, s)  # the stream's workspace
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = im.s8_matmul_qx(xs, w, s)
        for seed in (76, 77):
            xs.copy_(_randn((r, 4096), seed, cuda) * 3.0)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, im.s8_matmul_qx_reference(xs, w, s))
        xs2 = [_randn((r, 4096), seed, cuda) for seed in (78, 79)]
        alone = [im.s8_matmul_qx(a, w, s) for a in xs2]
        streams = [torch.cuda.Stream() for _ in xs2]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        outs = [[], []]
        for _ in range(10):
            for i, (st, a) in enumerate(zip(streams, xs2)):
                with torch.cuda.stream(st):
                    outs[i].append(im.s8_matmul_qx(a, w, s))
        torch.cuda.synchronize()
        for i in range(2):
            for o in outs[i]:
                assert torch.equal(o, alone[i])


def test_flux_qk_norm_in_the_projection_layout_is_one_launch(cuda):
    """FLUX's per-head q/k norm on the (B, S, H, D) projection itself (no
    head transpose, so no copy): one RMSNorm launch, within 1 bf16 ulp of
    the plain version."""
    from thinkdiff_torch.models.flux import QKNorm

    norm = QKNorm(128, torch.bfloat16, cuda)
    with torch.no_grad():
        norm.q_scale.copy_(_randn((128,), 8, cuda, torch.float32))
    q, k = (_randn((1, 4224, 24, 128), s, cuda) for s in (9, 10))
    before = kernels.launch_counts()["rmsnorm"]
    qn, kn = norm(q, k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rmsnorm"] == before + 2
    for out, x, s in ((qn, q, norm.q_scale), (kn, k, norm.k_scale)):
        ref = rmsnorm_reference(x, s.to(torch.bfloat16), 1e-6)
        assert out.shape == x.shape
        assert ((out.float() - ref.float()).abs() <= _bf16_ulp(ref)).all()


def test_flux_blocks_at_full_width_match_plain(cuda):
    """A FLUX.1-dev transformer cut to one double and one single block, at
    full width (hidden 3072, 24 heads of 128) on seeded random weights
    (q/k norm scales U(0.5, 1.5)), S_txt 128 + a 1024² image's 4096
    tokens: every kernel call against its plain version on the call's own
    inputs (the flash forward within FLUX_FLASH_REL * max|ref|, RMSNorm
    within one bf16 ulp), and the velocity through the kernels against the
    same forward with both replaced by their plain versions, cosine at
    least 0.999 (chip_smoke.py measures the whole model)."""
    from unittest import mock

    from thinkdiff_torch.models import flux as tfm
    from thinkdiff_torch.ops.flash_attention import mha_reference as mha

    cfg = tfm.FluxConfig.flux_dev(num_double_layers=1, num_single_layers=1)
    model = tfm.FluxTransformer(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("kernel"):
                p.copy_(torch.randn(p.shape, generator=gen, device=cuda)
                        * 0.02)
            elif name.endswith("scale"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen, device=cuda))
            else:
                p.zero_()
    img = torch.randn((1, 4096, 64), generator=gen, device=cuda)
    txt = torch.randn((1, 128, 4096), generator=gen, device=cuda)
    pooled = torch.randn((1, 768), generator=gen, device=cuda)
    args = (img, txt, pooled, torch.full((1,), 0.7, device=cuda),
            torch.from_numpy(tfm.make_img_ids(128, 128)).to(cuda),
            torch.zeros((128, 3), device=cuda),
            torch.full((1,), 3.5, device=cuda))
    errs = []

    def attention(q, k, v, *a):
        out, ref = flash_attention(q, k, v, *a), mha(q, k, v, *a).float()
        errs.append(float((out.float() - ref).abs().max())
                    / (FLUX_FLASH_REL * float(ref.abs().max())))
        return out

    def norm(x, s, eps=1e-6):
        out, ref = rmsnorm(x, s, eps), rmsnorm_reference(x, s, eps)
        errs.append(float(((out.float() - ref.float()).abs()
                           / _bf16_ulp(ref)).max()))
        return out

    with torch.no_grad():
        before = kernels.launch_counts()
        with mock.patch.object(tfm, "flash_attention", attention), \
                mock.patch.object(tfm, "rmsnorm", norm):
            got = model(*args).float()
        after = kernels.launch_counts()
        with mock.patch.object(tfm, "flash_attention", mha), \
                mock.patch.object(tfm, "rmsnorm", rmsnorm_reference):
            want = model(*args).float()
    assert after["flash_attention_fwd"] - before["flash_attention_fwd"] == 2
    assert after["rmsnorm"] - before["rmsnorm"] == 6
    assert len(errs) == 8 and max(errs) <= 1.0, errs
    assert torch.isfinite(got).all() and got.shape == (1, 4096, 64)
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(),
                                                dim=0)
    assert float(cos) >= 0.999, float(cos)


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("r,k,n", [(1024, 5120, 4096), (1024, 4096, 6144),
                                   (512, 4096, 16064), (256, 8960, 1536),
                                   (16, 18944, 3584), (65, 4112, 4096)])
def test_s8_int32_mode_gives_the_exact_sums(cuda, bwd, r, k, n):
    """#2 and #7 in their int32 mode (a model-sharded contraction's partial
    sums): identical to the float64 plain version and to torch._int_mm
    (above 16 rows, which it needs), in one counted launch, and the scales applied to them give the bf16 mode's
    bits (so a sum over ranks then scaled is the unsharded layer). Shapes:
    the shard phase's wo K5120, qkv N6144 and lm_head chunk N16064 at model
    2, and plans that split the contraction."""
    from thinkdiff_torch.ops import int8_matmul as im

    xq, sx = _absmax_quant_rows(_randn((r, k), 31, cuda, torch.float32))
    w = quantize_weight(_randn((k, n), 32, cuda, torch.float32) * 0.02)
    name = "s8_matmul_bwd_i32" if bwd else "s8_matmul_i32"
    # torch._int_mm takes more than 16 rows
    lib = torch._int_mm(xq, w["q"].contiguous()) if r > 16 else None
    before = kernels.launch_counts()[name]
    if bwd:  # contraction over k: gq (R, k), the weight (n, k) row-major
        w_nk = w["q"].t().contiguous()
        acc = im.s8_matmul_bwd_i32(xq, w_nk)
        ref = im.s8_matmul_bwd_i32_reference(xq, w_nk)
        scaled, bf16 = (im.s8_scaled(acc, sx, None),
                        im.s8_matmul_bwd(xq, sx, w_nk))
    else:
        acc = im.s8_matmul_i32(xq, w["q"])
        ref = im.s8_matmul_i32_reference(xq, w["q"])
        scaled, bf16 = (im.s8_scaled(acc, sx, w["scale"]),
                        im.s8_matmul(xq, sx, w["q"], w["scale"]))
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert acc.dtype == torch.int32 and torch.equal(acc, ref)
    if lib is not None:
        assert torch.equal(acc, lib)
    assert torch.equal(scaled, bf16)


@pytest.mark.parametrize("bwd", [False, True])
def test_s8_int32_mode_every_split_gives_the_same_sums(cuda, monkeypatch,
                                                       bwd):
    """The int32 mode at every split of the contraction (none, the plan's,
    others: the in-place sum of the splits' planes) and both tile widths:
    the same sums."""
    from thinkdiff_torch.ops import int8_matmul as im

    r, k, n = 256, 8960, 1536
    xq, _ = _absmax_quant_rows(_randn((r, k), 33, cuda, torch.float32))
    w = quantize_weight(_randn((k, n), 34, cuda, torch.float32))["q"]
    w_nk = w.t().contiguous()
    run = ((lambda: im.s8_matmul_bwd_i32(xq, w_nk)) if bwd
           else (lambda: im.s8_matmul_i32(xq, w)))
    plan = im.s8_gemm_plan
    bm, _, _, chosen = plan(r, k, n)
    ref = run()
    outs = []
    for bn in (128, 256):
        for split in sorted({1, 2, 5, chosen}):
            monkeypatch.setattr(im, "s8_gemm_plan", lambda *a, c=(
                bm, bn, 3, split): c)
            outs.append(run())
    monkeypatch.setattr(im, "s8_gemm_plan", plan)
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, ref)


# the vocabulary shards of the served lm_heads: 7B (D 3584, V 152064, untied)
# at model 2 and 4, 2B (D 1536, V 151936, tied) at model 2
SHARD_SAMPLE_CASES = {"7b_m2": (16, 3584, 152064, 2),
                      "7b_m4": (16, 3584, 152064, 4),
                      "2b_tied_m2": (64, 1536, 151936, 2)}


@pytest.mark.parametrize("case", sorted(SHARD_SAMPLE_CASES))
def test_fused_sample_shard_keys(cuda, case):
    """The kernel's vocabulary-shard mode at the served shard shapes: each
    shard's keys equal its plain version's, and their MAX over the shards
    is the unsharded kernel's ids on the same seed, with and without
    noise; col0 = 0 with ids out is the unsharded call."""
    from thinkdiff_torch.ops.fused_sample import (
        fused_lm_sample, fused_lm_sample_reference, gumbel_noise,
        keys_to_ids, pack_lm_head)

    b, d, v, shards = SHARD_SAMPLE_CASES[case]
    w = _randn((d, v), 80, cuda, torch.float32) * 0.05
    qw = quantize_weight(w)
    del w
    eos = [3, v // shards + 7, v - 1]
    x = _randn((b, d), 81, cuda)
    blocked = (torch.arange(b, device=cuda) % 3 == 0).float()
    seed = torch.tensor([77, 11], dtype=torch.int32, device=cuda)
    full = pack_lm_head(qw["q"], qw["scale"], eos_ids=eos)
    for noise in (False, True):
        want = fused_lm_sample(x, full, blocked, seed, temperature=0.6,
                               noise=noise)
        keys = []
        for s in range(shards):
            lo, hi = s * v // shards, (s + 1) * v // shards
            pack = pack_lm_head(qw["q"][:, lo:hi], qw["scale"][lo:hi],
                                eos_ids=[e - lo for e in eos if lo <= e < hi])
            got = fused_lm_sample(x, pack, blocked, seed, temperature=0.6,
                                  noise=noise, col0=lo, keys=True)
            g = (gumbel_noise(seed, b, pack["qt"].shape[0], lo) if noise
                 else None)
            plain = fused_lm_sample_reference(x, pack, blocked,
                                              temperature=0.6, noise=g,
                                              col0=lo, keys=True)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (case, noise, s)
            keys.append(got)
        assert torch.equal(keys_to_ids(torch.stack(keys).amax(0)), want), (
            case, noise)


def test_a_span_holds_the_launch_it_made(cuda, tmp_path):
    """The port's spans (core/trace.py) are on under a CUDA-only profiler
    and stamp the clock of its chrome trace: the cudaLaunchKernel of a
    kernel launched inside a span lies inside that span's interval on the
    exported trace, within 50 us."""
    import json

    from thinkdiff_torch.core import trace

    trace.clear()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        torch.cuda.synchronize()
        with trace.span("gpu.sleep"):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    (sp,) = trace.spans()
    trace.clear()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    ev = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    corr = next(e["args"]["correlation"] for e in ev
                if e.get("cat") == "kernel" and "spin_kernel" in e["name"])
    launch = next(e for e in ev if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") == corr)
    assert launch["name"] == "cudaLaunchKernel"
    a, b = (sp.start_ns - base) / 1e3, (sp.end_ns - base) / 1e3
    assert b - a < 5000, (a, b)
    assert a - 50 <= launch["ts"] and \
        launch["ts"] + launch["dur"] <= b + 50, (a, b, launch)
