"""Port parity: int8 quantization, the s8 GEMM's plain version and QDense
against the JAX package (the Pallas s8 kernel in interpret mode)."""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.models.qdense import QDense as TQDense
from thinkdiff_torch.ops import quant as tq
from thinkdiff_torch.ops.int8_matmul import s8_matmul
from thinkdiff_tpu.models.t5 import QDense as JQDense
from thinkdiff_tpu.ops import quant as jq

jim = importlib.import_module("thinkdiff_tpu.ops.int8_matmul")


def _interpret():
    real = jim.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return real(*args, **kwargs)

    return mock.patch.object(jim.pl, "pallas_call", call)


def _weight(seed=0, k=64, n=48):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.05
    w[:, 3] = 0.0                                      # zero column: scale 1
    w[:5, 7] = [127.0, 0.5, 1.5, 2.5, -3.5]            # scale 1: exact halves
    w[5:, 7] = 0.0
    return w


def test_quantize_weight_identical():
    w = _weight()
    want = jq.quantize_weight(w)
    got = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    # round half to even, the zero-column scale, the +-127 clip
    assert got["q"][1:5, 7].tolist() == [0, 2, 2, -4]
    assert float(got["scale"][3]) == 1.0
    assert int(got["q"].abs().max()) == 127


def test_absmax_quant_rows_identical():
    rs = np.random.RandomState(1)
    x = rs.randn(16, 64).astype(np.float32) * 3.0
    x[2] = 0.0                                    # 1e-30 floor: zeros stay 0
    x[5, :4] = [127.0, 0.5, -1.5, 2.5]            # exact halves at s = 1
    x[5, 4:] = 0.0
    jx_q, jx_s = jq._absmax_quant_rows(jnp.asarray(x))
    t_q, t_s = tq._absmax_quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(jx_s))
    assert t_q[5, :4].tolist() == [127, 0, -2, 2]


@pytest.mark.parametrize("r,k,n", [(40, 128, 256), (96, 384, 128)])
def test_s8_matmul_int32_sum_bit_exact(r, k, n):
    """Unit scales and an f32 output make the epilogue the identity, so the
    outputs ARE the int32 sums (|sum| <= 384 * 127^2 < 2^24 is exact in
    f32): the port's float64 plain GEMM equals the Pallas kernel bit for bit."""
    rs = np.random.RandomState(2)
    xq = rs.randint(-127, 128, (r, k)).astype(np.int8)
    wq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    ones_r, ones_n = np.ones(r, np.float32), np.ones(n, np.float32)
    with _interpret():
        want = np.asarray(jim._s8_matmul_fused(
            jnp.asarray(xq), jnp.asarray(ones_r), jnp.asarray(wq),
            jnp.asarray(ones_n), jnp.float32))
    got = s8_matmul(torch.from_numpy(xq), torch.from_numpy(ones_r),
                    torch.from_numpy(wq), torch.from_numpy(ones_n),
                    torch.float32).numpy()
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,k,n", [(33, 128, 128), (64, 384, 256)])
def test_s8_matmul_epilogue_within_one_bf16_ulp(r, k, n):
    rs = np.random.RandomState(3)
    x = rs.randn(r, k).astype(np.float32)
    qw = jq.quantize_weight(rs.randn(k, n).astype(np.float32) * 0.05)
    xq, sx = jq._absmax_quant_rows(jnp.asarray(x))
    with _interpret():
        want = np.asarray(jim._s8_matmul_fused(
            xq, sx, jnp.asarray(qw["q"]), jnp.asarray(qw["scale"]),
            jnp.bfloat16)).astype(np.float32)
    got = s8_matmul(torch.from_numpy(np.array(xq)),
                    torch.from_numpy(np.array(sx)),
                    torch.from_numpy(qw["q"]), torch.from_numpy(qw["scale"]),
                    torch.bfloat16).float().numpy()
    _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
    assert (np.abs(got - want) <= np.ldexp(1.0, e - 8)).all()


def test_int8_dynamic_matmul_matches():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 64).astype(np.float32)
    qw = jq.quantize_weight(_weight(5))
    want = np.asarray(jq.int8_dynamic_matmul(
        jnp.asarray(x), jnp.asarray(qw["q"]), jnp.asarray(qw["scale"])))
    got = tq.int8_dynamic_matmul(torch.from_numpy(x), torch.from_numpy(qw["q"]),
                                 torch.from_numpy(qw["scale"])).numpy()
    # same int8 operands and exact sums; the f32 epilogue is one rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [False, "int8", "w8a8"])
def test_qdense_matches(quant):
    """QDense in each mode, with a bias and (w8a8) a non-identity
    input_scale that the port divides by in the model dtype first."""
    rs = np.random.RandomState(5)
    k, n = 64, 48
    x = rs.randn(3, 7, k).astype(np.float32)
    w = _weight(6, k, n)
    params = {"bias": rs.randn(n).astype(np.float32) * 0.1}
    if quant:
        qw = jq.quantize_weight(w)
        params.update(kernel_q=qw["q"], kernel_scale=qw["scale"])
        if quant == "w8a8":
            params["input_scale"] = (0.5 + rs.rand(k)).astype(np.float32)
    else:
        params["kernel"] = w
    jquant = True if quant == "int8" else quant
    want = np.asarray(JQDense(n, quant=jquant, use_bias=True).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    layer = load_params(TQDense(k, n, torch.float32, jquant, True), params)
    got = layer(torch.from_numpy(x)).numpy()
    # f32; the same integer products where quantized -> 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantize_tree_layout_and_min_size():
    tree = {"a": {"kernel": _weight(7)}, "b": {"kernel": np.ones((4, 4),
                                                                 np.float32)},
            "norm": {"weight": np.ones(8, np.float32)}}
    got = tq.quantize_tree(tree, min_size=100, w8a8=True)
    want = jq.quantize_tree(tree, min_size=100, w8a8=True)
    assert set(got["a"]) == set(want["a"]) == {"kernel_q", "kernel_scale",
                                               "input_scale"}
    assert set(got["b"]) == set(want["b"]) == {"kernel"}
    for key in ("kernel_q", "kernel_scale", "input_scale"):
        np.testing.assert_array_equal(np.asarray(got["a"][key]),
                                      np.asarray(want["a"][key]))


@pytest.mark.parametrize("r,k,n", [(40, 256, 128), (33, 128, 384)])
def test_s8_matmul_bwd_identical_to_pallas(r, k, n):
    """The input-gradient GEMM's plain version (float64 product, exact int32
    sums) equals the Pallas _s8_bwd_kernel in interpret mode bit for bit,
    with unit and with random row scales, f32 and bf16 out."""
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul_bwd, s8_matmul_bwd_reference)

    rs = np.random.RandomState(12)
    gq = rs.randint(-127, 128, (r, n)).astype(np.int8)
    wq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    for sg in (np.ones(r, np.float32), rs.rand(r).astype(np.float32) * 1e-3):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            with _interpret():
                want = np.asarray(jim._s8_matmul_fused_bwd(
                    jnp.asarray(gq), jnp.asarray(sg), jnp.asarray(wq),
                    jdt)).astype(np.float32)
            got = s8_matmul_bwd(torch.from_numpy(gq), torch.from_numpy(sg),
                                torch.from_numpy(wq), tdt).float().numpy()
            np.testing.assert_array_equal(got, want)
    exact = gq.astype(np.int64) @ wq.astype(np.int64).T
    ones = s8_matmul_bwd_reference(torch.from_numpy(gq), torch.ones(r),
                                   torch.from_numpy(wq), torch.float32)
    np.testing.assert_array_equal(ones.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dynamic_matmul_dx_matches_jax(dtype):
    """The w8a8 backward (scale-folded dy, per-row requantization, s8 dx)
    against JAX's _w8a8_bwd through jax.vjp: the same int8 operands from
    the same f32 arithmetic, so equal up to one rounding of the output.
    The weight and scale get no gradient."""
    rs = np.random.RandomState(13)
    x = rs.randn(3, 5, 64).astype(np.float32)
    dy = rs.randn(3, 5, 48).astype(np.float32)
    qw = jq.quantize_weight(_weight(14))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: jq.int8_dynamic_matmul(
        a, jnp.asarray(qw["q"]), jnp.asarray(qw["scale"])), jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(dy, jdt))[0], np.float32)
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    tqw, ts = torch.from_numpy(qw["q"]), torch.from_numpy(qw["scale"])
    y = tq.int8_dynamic_matmul(tx, tqw, ts, w_kn=tqw.contiguous())
    y.backward(torch.tensor(dy, dtype=tdt))
    got = tx.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
        assert (np.abs(got - want) <= np.ldexp(1.0, e - 8)).all()
    assert not tqw.requires_grad and not ts.requires_grad


def test_training_qdense_keeps_the_kn_copy():
    """A w8a8 QDense built to train keeps its kernel twice: the (N, K)
    storage the forward GEMM reads (kernel_q is its transpose view) and the
    (K, N) row-major copy the input-gradient GEMM reads; serving layers
    keep only the first."""
    qw = jq.quantize_weight(_weight(15))
    params = {"kernel_q": qw["q"], "kernel_scale": qw["scale"],
              "input_scale": np.ones(64, np.float32)}
    train = load_params(TQDense(64, 48, torch.float32, "w8a8",
                                train_layout=True), params)
    serve = load_params(TQDense(64, 48, torch.float32, "w8a8"), params)
    assert serve.kernel_q_kn is None
    assert train.kernel_q.t().is_contiguous()
    assert train.kernel_q_kn.is_contiguous()
    assert torch.equal(train.kernel_q_kn, torch.from_numpy(qw["q"]))
    x = torch.randn(4, 64, requires_grad=True)
    train(x).sum().backward()
    ref = x.detach().clone().requires_grad_(True)
    serve(ref).sum().backward()
    assert torch.equal(x.grad, ref.grad)
