"""Port parity: thinkdiff_torch.ops.flash_attention (its plain CPU path)
against the JAX Pallas forward kernel (interpret mode) and the JAX
reference, on the same seeded inputs. The CUDA kernel itself is held
against the same plain path in tests/test_torch_gpu.py."""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.ops import flash_attention as tf

jf = importlib.import_module("thinkdiff_tpu.ops.flash_attention")

CASES = {
    # vision tower: D=80, no mask
    "vision_d80": dict(b=2, hq=4, hkv=4, tq=48, tk=48, d=80),
    # LM prefill: D=128, GQA 4:1, causal plus a (B,1,1,T) -1e30 padding bias
    "lm_prefill_gqa_causal_pad": dict(b=2, hq=8, hkv=2, tq=40, tk=40, d=128,
                                      causal=True, pad_bias=True),
    "kv_mask": dict(b=2, hq=2, hkv=2, tq=24, tk=40, d=32, kv_mask=True),
    "segment_ids": dict(b=2, hq=2, hkv=1, tq=32, tk=32, d=32, segments=True),
    "sm_scale_1": dict(b=1, hq=2, hkv=2, tq=16, tk=24, d=64, sm_scale=1.0),
}


def _case(name):
    c = dict(CASES[name])
    b, hq, hkv, tq, tk, d = (c.pop(k) for k in
                             ("b", "hq", "hkv", "tq", "tk", "d"))
    rs = np.random.RandomState(0)
    q = rs.randn(b, hq, tq, d).astype(np.float32)
    k = rs.randn(b, hkv, tk, d).astype(np.float32)
    v = rs.randn(b, hkv, tk, d).astype(np.float32)
    kw = {"causal": c.get("causal", False),
          "sm_scale": c.get("sm_scale", d ** -0.5)}
    if c.get("pad_bias"):
        valid = np.arange(tk)[None] < np.asarray([tk, tk - 13])[:, None]
        kw["bias"] = ((1.0 - valid)[:, None, None, :] * -1e30).astype(np.float32)
    if c.get("kv_mask"):
        kw["kv_mask"] = (np.arange(tk)[None]
                         < np.asarray([tk, 17])[:, None]).astype(np.int32)
    if c.get("segments"):
        seg = np.repeat((np.arange(tq) // 10 + 1)[None], b, 0).astype(np.int32)
        seg[1, -5:] = 0
        kw["q_segment_ids"] = kw["kv_segment_ids"] = seg
    return q, k, v, kw


def _jax_kernel(q, k, v, kw):
    real = jf.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return real(*args, **kwargs)

    j = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
         for k_, v_ in kw.items()}
    with mock.patch.object(jf.pl, "pallas_call", call):
        return np.asarray(jf._flash_attention_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j.get("bias"),
            j.get("kv_mask"), j.get("q_segment_ids"), j.get("kv_segment_ids"),
            causal=j["causal"], sm_scale=j["sm_scale"], block_q=16,
            block_k=16))


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_kernel_and_reference(name):
    q, k, v, kw = _case(name)
    t = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
         for k_, v_ in kw.items()}
    got = tf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **t).numpy()
    j = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
         for k_, v_ in kw.items()}
    want_ref = np.asarray(jf.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **j))
    want_kernel = _jax_kernel(q, k, v, kw)
    # f32 throughout; the Pallas kernel's blockwise exp2-domain softmax and
    # the einsum references differ in summation order only -> 2e-5
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=0)
    rows = np.ones(q.shape[2], bool)
    if "bias" in kw:
        # the Pallas wrapper zero-pads a (B, 1, 1, T) bias along the query
        # axis, so only query row 0 sees it there; in causal prefill that
        # changes nothing for real rows (their keys are all valid) but the
        # padding query rows of a short sequence attend padding keys. The
        # port follows mha_reference; compare the kernel on real rows.
        rows = np.arange(q.shape[2]) < q.shape[2] - 13
        np.testing.assert_allclose(got[0], want_kernel[0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[:, :, rows], want_kernel[:, :, rows],
                               atol=2e-5, rtol=0)


def test_default_sm_scale_is_head_dim_rsqrt():
    q, k, v, _ = _case("vision_d80")
    a = tf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    b = tf.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=80 ** -0.5)
    assert torch.equal(a, b)
