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
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case):
    c = dict(FLASH_CASES[case])
    b, hq, hkv, tq, tk, d = (c.pop(k) for k in ("b", "hq", "hkv", "tq", "tk", "d"))
    q = _randn((b, hq, tq, d), 0, cuda)
    k = _randn((b, hkv, tk, d), 1, cuda)
    v = _randn((b, hkv, tk, d), 2, cuda)
    kw = dict(causal=c.get("causal", False), sm_scale=c.get("sm_scale"))
    if c.get("pad_bias"):
        lens = torch.tensor([tk, tk - 37], device=cuda)
        valid = torch.arange(tk, device=cuda)[None] < lens[:, None]
        kw["bias"] = (1.0 - valid.float())[:, None, None, :] * -1e30
    if c.get("full_bias"):
        kw["bias"] = _randn((1, hq, tq, tk), 3, cuda, torch.float32) * 0.5
    if c.get("kv_mask"):
        kw["kv_mask"] = (torch.arange(tk, device=cuda)[None]
                         < torch.tensor([[tk], [tk // 2]], device=cuda)).int()
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
    assert (err <= 2e-2 + 2e-2 * ref.float().abs()).all(), float(err.max())


@pytest.mark.parametrize("r,k,n", [(1, 64, 16), (8, 1536, 2048),
                                   (300, 8960, 1536), (130, 1536, 17920)])
def test_s8_matmul_kernel_exact(cuda, r, k, n):
    """Exact int32 sums and the same f32 epilogue: within 1 bf16 ulp (in
    practice equal) of the float64 plain version."""
    x = _randn((r, k), 4, cuda, torch.float32)
    w = _randn((k, n), 5, cuda, torch.float32) * 0.02
    xq, sx = _absmax_quant_rows(x)
    qw = quantize_weight(w)
    out = s8_matmul(xq, sx, qw["q"], qw["scale"])
    torch.cuda.synchronize()
    ref = s8_matmul_reference(xq, sx, qw["q"], qw["scale"])
    err = (out.float() - ref.float()).abs()
    assert (err <= _bf16_ulp(ref)).all(), float(err.max())


def test_s8_matmul_kernel_rejects_unaligned_k(cuda):
    xq = torch.zeros((4, 40), dtype=torch.int8, device=cuda)
    w = torch.zeros((40, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        s8_matmul(xq, torch.ones(4, device=cuda), w, torch.ones(32, device=cuda))


@pytest.mark.parametrize("rows,d,dtype", [(7, 64, torch.float32),
                                          (4096, 1536, torch.bfloat16),
                                          (33, 1280, torch.bfloat16)])
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


def _sample_case(cuda, b, d, v, seed=0):
    from thinkdiff_torch.ops.fused_sample import pack_lm_head

    w = _randn((d, v), seed, cuda, torch.float32) * 0.05
    qw = quantize_weight(w)
    pack = pack_lm_head(qw["q"], qw["scale"], eos_ids=[3, v - 1])
    x = _randn((b, d), seed + 1, cuda, torch.float32)
    blocked = (torch.arange(b, device=cuda) % 3 == 0).float()
    return x, pack, blocked


@pytest.mark.parametrize("b,d,v", [(5, 64, 300), (64, 1536, 20000),
                                   (130, 1536, 5000), (256, 1536, 20000)])
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

    q, k, v, do, kw = _bwd_inputs(cuda, BWD_CASES[case])
    args = [kw[n] for n in ("bias", "kv_mask", "causal", "sm_scale",
                            "q_segment_ids", "kv_segment_ids")]
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


@pytest.mark.parametrize("r,k,n", [(1, 64, 16), (333, 4096, 4096),
                                   (130, 4096, 16 * 617), (512, 4096, 32128)])
def test_s8_matmul_bwd_kernel_identical(cuda, r, k, n):
    """Exact int32 sums and the same f32 epilogue, rounded to bf16 once:
    identical to the float64 plain version (odd R; N = 9872 and 32128 are
    not multiples of 128)."""
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
