"""Port parity: thinkdiff_torch.ops.norms against thinkdiff_tpu.ops.norms.

The JAX RMSNorm kernel runs as Pallas in interpret mode; the port takes its
plain path (CPU tensors). Inputs are made with numpy from a seed and fed to
both.
"""

import importlib
from unittest import mock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from thinkdiff_torch import kernels
from thinkdiff_torch.ops import norms as tn
from thinkdiff_tpu.ops import norms as jn


def _interpret(module):
    real = module.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return real(*args, **kwargs)

    return mock.patch.object(module.pl, "pallas_call", call)


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2.0).astype(np.float32)
    scale = rs.randn(shape[-1]).astype(np.float32)
    return x, scale


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 48), (1, 1536)])
def test_rmsnorm_f32_matches_pallas_kernel_and_reference(shape):
    x, scale = _inputs(shape, 0)
    fn = importlib.import_module("thinkdiff_tpu.ops.norms")
    with _interpret(fn):
        want_kernel = np.asarray(jn._rmsnorm_pallas(
            jnp.asarray(x), jnp.asarray(scale), 1e-6))
    want_ref = np.asarray(jn.rmsnorm_reference(
        jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = tn.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy()
    # f32: the same ops in another order of summation -> 1e-6
    np.testing.assert_allclose(got, want_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)
    assert kernels.launch_counts()["rmsnorm"] == 0  # CPU: plain path


@pytest.mark.parametrize("shape", [(7, 64), (4, 1536)])
def test_rmsnorm_bf16_within_one_ulp(shape):
    x, scale = _inputs(shape, 1)
    xb, sb = x.astype(ml_dtypes.bfloat16), scale.astype(ml_dtypes.bfloat16)
    fn = importlib.import_module("thinkdiff_tpu.ops.norms")
    with _interpret(fn):
        want = np.asarray(jn._rmsnorm_pallas(jnp.asarray(xb), jnp.asarray(sb),
                                             1e-6)).astype(np.float32)
    got = tn.rmsnorm(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                     torch.from_numpy(sb.astype(np.float32)).bfloat16(),
                     1e-6).float().numpy()
    # both compute in f32 and round once to bf16: within 1 bf16 ulp
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("with_affine", [True, False])
def test_layernorm_matches(with_affine):
    x, scale = _inputs((6, 80), 2)
    bias = np.random.RandomState(3).randn(80).astype(np.float32)
    s, b = (scale, bias) if with_affine else (None, None)
    want = np.asarray(jn.layernorm(
        jnp.asarray(x), None if s is None else jnp.asarray(s),
        None if b is None else jnp.asarray(b), 1e-6))
    got = tn.layernorm(torch.from_numpy(x),
                       None if s is None else torch.from_numpy(s),
                       None if b is None else torch.from_numpy(b), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_t5_layernorm_is_rmsnorm():
    assert tn.t5_layernorm is tn.rmsnorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gradients_match_jax(dtype):
    """dx and dscale of the port's autograd rmsnorm (the plain gradient of
    rmsnorm_reference) against jax.grad through JAX's custom VJP. f32:
    summation order only (1e-5); bf16 inputs: both sides round x, scale and
    the cotangent alike, the gradients to one bf16 ulp (4e-3 relative)."""
    import jax

    x, scale = _inputs((6, 48), 8)
    g = np.random.RandomState(9).randn(6, 48).astype(np.float32)
    if dtype == "bfloat16":
        x, scale, g = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                       for a in (x, scale, g))
    tdt = getattr(torch, dtype)
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    ts = torch.tensor(scale, dtype=tdt, requires_grad=True)
    tn.rmsnorm(tx, ts, 1e-6).backward(torch.tensor(g, dtype=tdt))
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b: jn.rmsnorm(a, b, 1e-6),
                     jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    jdx, jds = vjp(jnp.asarray(g, jdt))
    tol = 1e-5 if dtype == "float32" else 4e-3
    for got, want in ((tx.grad, jdx), (ts.grad, jds)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_rmsnorm_gradient_only_where_asked():
    """A frozen scale gets no gradient (T5's norms); x alone is
    differentiated, and the CPU path launches no kernel."""
    kernels.reset_launch_counts()
    x, scale = _inputs((3, 16), 10)
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale)
    tn.rmsnorm(tx, ts).sum().backward()
    assert tx.grad is not None and ts.grad is None
    assert kernels.launch_counts()["rmsnorm"] == 0


@pytest.mark.parametrize("d", [1536, 3584, 4096, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_reference_matches_jax_at_the_kernel_widths(d, dtype):
    """The plain version the CUDA kernel is held against, at the widths the
    kernel serves (the 2B and 7B LMs, flan-t5-xxl and the projector) and a
    width that is not a whole number of 16-byte vectors: equal to JAX's
    rmsnorm_reference to f32 rounding, within one bf16 ulp in bf16."""
    x, scale = _inputs((7, d), 3)
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(jn.rmsnorm_reference(
        jnp.asarray(x).astype(jt), jnp.asarray(scale).astype(jt), 1e-6)
    ).astype(np.float32)
    xt = torch.from_numpy(x).to(tt)
    st = torch.from_numpy(scale).to(tt)
    got = tn.rmsnorm_reference(xt, st, 1e-6).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
