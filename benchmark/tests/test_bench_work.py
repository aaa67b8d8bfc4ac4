"""work/'s operation and byte counts against hand counts at the cells'
shapes."""

import pytest

from benchmark import harness
from benchmark.peaks import bound_s
from benchmark.work import attention, flux, rmsnorm, t5_aligner

T5 = harness.cell_files("train-lvlm-bs32")["config"]["t5"]
FLUX = harness.cell_files("flux-1024")["config"]
TR = dict(FLUX["transformer"], mlp_ratio=FLUX["mlp_ratio"])


def test_attention_counts():
    # FLUX joint attention B1 H24 T4224 D128: 4 * 24 * 128 * 4224^2
    a = attention.forward(1, 24, 4224, 4224, 128)
    assert a["ops"] == 4 * 24 * 128 * 4224 ** 2 == 219_244_658_688
    assert a["bytes"] == 2 * 24 * 128 * 4224 * 4
    # the bound is compute at this length: 0.2217 ms
    assert bound_s(a["bytes"], a["ops"]) == pytest.approx(
        219_244_658_688 / 989e12)
    # causal T5 self-attention keeps T(T+1)/2 pairs; its f32 bias read
    c = attention.forward(32, 64, 128, 128, 64, causal=True, bias_heads=64)
    assert c["ops"] == 4 * 32 * 64 * 64 * (128 * 129 // 2)
    assert c["bytes"] == 2 * 32 * 64 * 64 * 512 + 4 * 64 * 128 * 128
    b = attention.backward(32, 64, 96, 64, 64, kv_mask=True)
    assert b["ops"] == 8 * 32 * 64 * 64 * 96 * 64
    assert b["bytes"] == (2 * 32 * 64 * 64 * (4 * 96 + 4 * 64)
                          + 4 * 32 * 64 * 96 + 4 * 32 * 64)


def test_causal_pairs_ragged():
    assert attention.pairs(4, 4, True) == 10
    assert attention.pairs(2, 4, True) == 3 + 4
    assert attention.pairs(3, 5, False) == 15


def test_rmsnorm_counts():
    r = rmsnorm.forward(24 * 4224, 128)
    assert r["bytes"] == 2 * (2 * 24 * 4224 * 128 + 128)


def test_flux_step_ops_at_1024():
    img, txt = 4096, 128
    t, d, mlp = img + txt, 3072, 12288
    per_double = 2 * (4 * d * d + 2 * d * mlp) * t + 4 * d * t * t
    per_single = 2 * (3 * d * d + d * mlp + (d + mlp) * d) * t + 4 * d * t * t
    per_row = (19 * 2 * 2 * d * 6 * d + 38 * 2 * d * 3 * d
               + 2 * (256 * d + d * d) * 2 + 2 * (768 * d + d * d)
               + 2 * d * 2 * d)
    io = 2 * img * 64 * d * 2 + 2 * txt * 4096 * d
    want = 19 * per_double + 38 * per_single + per_row + io
    assert flux.step_ops(TR, 1, img, txt) == want
    # projections ~54.5 TFLOP, attention 57 x 219.2 G ~12.5 TFLOP a step
    assert 66e12 < want < 68e12


def test_flux_step_calls():
    calls = flux.step_calls(TR, 4, 1024, 128)
    att = [c for c in calls if c["op"] == "attention"]
    norms = [c for c in calls if c["op"] == "rmsnorm"]
    assert len(att) == 57 and len(norms) == 4 * 19 + 2 * 38
    assert att[0]["ops"] == 4 * 4 * 24 * 128 * 1152 ** 2


def test_t5_step_ops_one_sample():
    d, dff, inner, v, n = 4096, 10240, 4096, 32128, 24
    tok, s = 50, 40
    fwd_block = (2 * tok * 6 * d * inner + 2 * s * 2 * d * inner
                 + 2 * tok * 3 * d * dff + 4 * inner * tok * (tok + 1) / 2
                 + 4 * inner * tok * s)
    bwd_block = fwd_block + 4 * inner * tok * (tok + 1) / 2 \
        + 4 * inner * tok * s
    bwd_block0 = (2 * tok * d * inner + 2 * s * 2 * d * inner
                  + 2 * tok * 3 * d * dff + 6 * inner * tok * s)
    proj = 2 * s * (3584 * d + d * d)
    head = 2 * tok * d * v
    want = (proj + n * fwd_block + head) + ((n - 1) * bwd_block + bwd_block0
                                            + head + proj + 2 * s * d * d)
    assert t5_aligner.step_ops(T5, 3584, [tok], [s]) == pytest.approx(want)


def test_t5_step_calls():
    calls = t5_aligner.step_calls(T5, 32, 64, 96)
    assert len(calls) == 24 + 24 + 23 + 24
    assert calls[0]["ops"] == 4 * 32 * 64 * 64 * (64 * 65 // 2)
    assert calls[24]["ops"] == 4 * 32 * 64 * 64 * 64 * 96
