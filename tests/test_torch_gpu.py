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
