"""Port parity: thinkdiff_torch.ops.flash_attention (its plain CPU paths,
forward and backward) against the JAX Pallas kernels (interpret mode) and
the JAX reference, on the same seeded inputs. The CUDA kernels themselves
are held against the same plain paths in tests/test_torch_gpu.py."""

import importlib
from unittest import mock

import jax
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


# --------------------------------------------------------------------------
# backward: the port's plain FA2 backward (what a CPU tensor runs, and what
# the dq / dk-dv kernels are held against on the card) vs the Pallas dq and
# dkv kernels in interpret mode and vs jax.vjp through mha_reference.

BWD_CASES = {
    # T5 self-attention: causal, the (1, H, T, T) relative bias, sm_scale 1
    "causal_rel_bias": dict(b=2, hq=4, hkv=4, tq=40, tk=40, d=64, causal=True,
                            rel_bias=True, sm_scale=1.0),
    # cross-attention: kv_mask and packed segments with an all-pad query row
    "cross_kv_mask_segments": dict(b=2, hq=2, hkv=2, tq=24, tk=40, d=64,
                                   kv_mask=True, segments=True, sm_scale=1.0),
    # packed self-attention: causal + segments + bias, ragged tails
    "packed_self": dict(b=2, hq=2, hkv=2, tq=37, tk=37, d=64, causal=True,
                        rel_bias=True, segments=True, sm_scale=1.0),
    "gqa_d128": dict(b=1, hq=4, hkv=2, tq=24, tk=33, d=128, kv_mask=True),
}


def _bwd_case(name):
    c = dict(BWD_CASES[name])
    b, hq, hkv, tq, tk, d = (c.pop(k) for k in
                             ("b", "hq", "hkv", "tq", "tk", "d"))
    rs = np.random.RandomState(7)
    q = rs.randn(b, hq, tq, d).astype(np.float32)
    k = rs.randn(b, hkv, tk, d).astype(np.float32)
    v = rs.randn(b, hkv, tk, d).astype(np.float32)
    do = rs.randn(b, hq, tq, d).astype(np.float32)
    kw = {"causal": c.get("causal", False),
          "sm_scale": c.get("sm_scale", d ** -0.5), "bias": None,
          "kv_mask": None, "q_segment_ids": None, "kv_segment_ids": None}
    if c.get("rel_bias"):
        kw["bias"] = (rs.randn(1, hq, tq, tk) * 0.5).astype(np.float32)
    if c.get("kv_mask"):
        kw["kv_mask"] = (np.arange(tk)[None]
                         < np.asarray([tk - 5, 17])[:b, None]).astype(np.int32)
    if c.get("segments"):
        qs = np.repeat((np.arange(tq) // 9 + 1)[None], b, 0).astype(np.int32)
        ks = np.repeat((np.arange(tk) // 13 + 1)[None], b, 0).astype(np.int32)
        qs[1, -4:] = 0                 # pad query rows: no key of segment 0
        ks[:, -3:] = 0
        if kw["kv_mask"] is not None:  # pad keys are masked as well
            kw["kv_mask"] = (kw["kv_mask"] * (ks > 0)).astype(np.int32)
        if tq == tk:
            ks = qs.copy()
        kw["q_segment_ids"], kw["kv_segment_ids"] = qs, ks
    return q, k, v, do, kw


def _dead_rows(q, k, kw):
    """(B, Tq) rows whose keys are all masked."""
    s = tf._allowed(torch.from_numpy(q), torch.from_numpy(k),
                    *[None if kw[n] is None else torch.from_numpy(kw[n])
                      for n in ("kv_mask",)], kw["causal"],
                    *[None if kw[n] is None else torch.from_numpy(kw[n])
                      for n in ("q_segment_ids", "kv_segment_ids")])
    if s is None:
        return np.zeros(q.shape[:1] + q.shape[2:3], bool)
    s = s.expand(q.shape[0], 1, q.shape[2], k.shape[2])
    return ~s.any(-1)[:, 0].numpy()


def _port_grads(q, k, v, do, kw):
    tq_, tk_, tv_ = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t = {n: (None if x is None else torch.from_numpy(x)) if isinstance(
        x, (np.ndarray, type(None))) else x for n, x in kw.items()}
    out = tf.flash_attention(tq_, tk_, tv_, **t)
    out.backward(torch.from_numpy(do))
    return [x.grad.numpy() for x in (tq_, tk_, tv_)]


def _jax_pallas_grads(q, k, v, do, kw):
    real = jf.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return real(*args, **kwargs)

    j = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
         for n, x in kw.items()}

    def f(q, k, v):
        return jf.flash_attention(q, k, v, j["bias"], j["kv_mask"],
                                  j["causal"], j["sm_scale"], 16, 16,
                                  j["q_segment_ids"], j["kv_segment_ids"])

    with mock.patch.object(jf.pl, "pallas_call", call), mock.patch.multiple(
            jf, _use_pallas=lambda q, k: True,
            _use_pallas_bwd=lambda ql, kl: True):
        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_matches_jax_kernels_and_vjp(name):
    """f32 throughout. Tolerance atol 2e-4, rtol 1e-3 (the Pallas package's
    own backward test): the Pallas kernels sum blockwise in another order
    and take p from an exp2-domain lse converted to natural log."""
    q, k, v, do, kw = _bwd_case(name)
    dead = _dead_rows(q, k, kw)
    got = _port_grads(q, k, v, do, kw)
    want = _jax_pallas_grads(q, k, v, do, kw)
    for g, w, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f"d{n}")
    # jax.vjp of mha_reference gives an all-masked row a uniform softmax and
    # so a gradient into v; the kernels give it P = 0. Same when dO is 0 on
    # those rows, as it is for the pad rows of a packed batch.
    do_live = do * (~dead)[:, None, :, None]
    j = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
         for n, x in kw.items()}
    _, vjp = jax.vjp(lambda q, k, v: jf.mha_reference(q, k, v, **j),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(do_live))]
    got = _port_grads(q, k, v, do_live, kw)
    for g, w, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f"d{n}")


def test_all_masked_rows_add_nothing_and_stay_finite():
    """A pad query row of a packed cross-attention sees no key. Its lse is
    finite, its dq is 0, and whatever its dO (here huge), dk and dv are
    exactly those of the same batch with that row's dO set to 0."""
    q, k, v, do, kw = _bwd_case("cross_kv_mask_segments")
    dead = _dead_rows(q, k, kw)
    assert dead.any() and not dead.all()
    lse = tf.logsumexp_reference(
        torch.from_numpy(q), torch.from_numpy(k), None,
        torch.from_numpy(kw["kv_mask"]), False, 1.0,
        torch.from_numpy(kw["q_segment_ids"]),
        torch.from_numpy(kw["kv_segment_ids"]))
    assert torch.isfinite(lse).all()
    poisoned = do.copy()
    poisoned[np.broadcast_to(dead[:, None, :, None], do.shape)] = 1e30
    a = _port_grads(q, k, v, poisoned, kw)
    b = _port_grads(q, k, v, do * (~dead)[:, None, :, None], kw)
    assert all(np.isfinite(x).all() for x in a)
    np.testing.assert_array_equal(a[0][np.broadcast_to(
        dead[:, None, :, None], q.shape)], 0.0)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_logsumexp_is_natural_log_and_matches_jax_kernel():
    """The lse the forward saves is the natural-log logsumexp of the masked
    scores: the Pallas kernel's output (converted from its exp2 domain)."""
    q, k, v, _, kw = _bwd_case("packed_self")
    t = {n: (None if x is None else torch.from_numpy(x)) if isinstance(
        x, (np.ndarray, type(None))) else x for n, x in kw.items()}
    got = tf.logsumexp_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 t["bias"], t["kv_mask"], t["causal"],
                                 t["sm_scale"], t["q_segment_ids"],
                                 t["kv_segment_ids"]).numpy()
    real = jf.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return real(*args, **kwargs)

    j = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
         for n, x in kw.items()}
    with mock.patch.object(jf.pl, "pallas_call", call):
        _, lse = jf._flash_attention_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j["bias"],
            j["kv_mask"], j["q_segment_ids"], j["kv_segment_ids"],
            causal=True, sm_scale=1.0, block_q=16, block_k=16,
            return_lse=True)
    want = np.asarray(lse).reshape(q.shape[0], q.shape[1], -1)[..., :q.shape[2]]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bias_gradient_is_refused():
    q, k, v, _, kw = _bwd_case("causal_rel_bias")
    bias = torch.tensor(kw["bias"], requires_grad=True)
    with pytest.raises(NotImplementedError):
        tf.flash_attention(torch.tensor(q, requires_grad=True),
                           torch.from_numpy(k), torch.from_numpy(v), bias,
                           causal=True, sm_scale=1.0)


# the forward kernel's tile choice at every shape the main paths give it:
# (Tq, D, bias, kv_mask, segments) -> (block_q, block_k, stages)
TILE_CHOICES = {
    "vision S1024 D80": ((1024, 80, None, False, False), (192, 64, 5)),
    "lm prefill T283 D128 pad bias": ((283, 128, "row", False, False),
                                      (128, 64, 5)),
    "t5 train self T256": ((256, 64, "tile", False, True), (128, 128, 2)),
    "t5 train cross T256": ((256, 64, None, True, True), (128, 128, 6)),
    "t5 yaml self T128 mask": ((128, 64, "tile", True, False), (128, 128, 2)),
    "t5 decode self T1": ((1, 64, "tile", False, False), (64, 128, 3)),
    "t5 decode self T32": ((32, 64, "tile", False, False), (64, 128, 3)),
    "t5 decode cross T16": ((16, 64, None, True, False), (64, 128, 6)),
}


@pytest.mark.parametrize("name", sorted(TILE_CHOICES))
def test_forward_tile_choice_is_a_function_of_the_shapes(name):
    args, want = TILE_CHOICES[name]
    tq, d = args[:2]
    got = tf.flash_fwd_tiles(*args)
    assert got == want
    block_q, block_k, stages = got
    # an instantiated (D, block_k) pair, 64-row tiles for the decode's few
    # rows, and a plan that fits the shared memory of a block
    assert (d, block_k) in {(64, 128), (80, 64), (128, 64)}
    assert block_q == (64 if tq <= 64 else 192 if d == 80 else 128)
    assert tf.flash_fwd_smem(d, *got, *args[2:]) <= tf.SMEM_LIMIT
    # the deepest ring that fits
    assert 2 <= stages <= tf.MAX_STAGES
    if stages < tf.MAX_STAGES:
        assert tf.flash_fwd_smem(d, block_q, block_k, stages + 1,
                                 *args[2:]) > tf.SMEM_LIMIT


def test_forward_operand_checks_raise_before_any_launch():
    """The kernel's operand rules, held on CPU tensors (the checks run
    before the library is touched): a head dim outside {64, 80, 128}, a
    head dim that is not contiguous, other strides that are not multiples
    of 16 bytes."""
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tf._forward_cuda(q, q, q, None, None, False, 1.0, None, None, False)
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="strides"):
        tf._forward_cuda(q, q, q, None, None, False, 1.0, None, None, False)
    q = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., 4:]
    with pytest.raises(ValueError, match="strides"):
        tf._forward_cuda(q, q, q, None, None, False, 1.0, None, None, False)
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(TypeError, match="bf16"):
        tf._forward_cuda(q, q, q, None, None, False, 1.0, None, None, False)
    # head-transposed views of (B, T, 3, H, D) memory pass the checks
    qkv = torch.zeros((1, 8, 3, 2, 80), dtype=torch.bfloat16)
    for i in range(3):
        tf._tma_operand(qkv[:, :, i].transpose(1, 2), "q")


def test_bias_operand_layout():
    """A relative bias whose rows are not 16 bytes apart, or not f32, is
    converted once into the kernel's layout (kernel_bias: padded rows,
    values unchanged); one already in it, or a (B, 1, 1, Tk) padding row,
    passes as it is."""
    rs = np.random.RandomState(0)
    odd = torch.from_numpy(rs.randn(1, 2, 15, 15).astype(np.float32))
    got, strides = tf._bias_operand(odd, 3, 2, 15, 15)
    assert got is not odd and torch.equal(got, odd)
    assert got.stride() == (2 * 15 * 16, 15 * 16, 16, 1)
    assert strides == (0, 15 * 16, 16)
    laid = tf.kernel_bias(odd)
    assert tf._bias_operand(laid, 3, 2, 15, 15)[0] is laid
    row = torch.from_numpy(rs.randn(3, 1, 1, 15).astype(np.float32))
    got, strides = tf._bias_operand(row, 3, 2, 15, 15)
    assert got is row and strides == (15, 0, 0)
    got, _ = tf._bias_operand(odd.to(torch.bfloat16), 3, 2, 15, 15)
    assert got.dtype == torch.float32


# the backward kernels' tiles at the shapes the training paths give them:
# (Tq, Tk, D, bias) -> ((block_q, block_k, stages) of dq, the same of dk/dv)
BWD_TILE_CHOICES = {
    "t5 train self T256": ((256, 256, 64, "tile"),
                           ((128, 64, 4), (64, 64, 2))),
    "t5 train cross T256": ((256, 256, 64, None),
                            ((64, 64, 4), (64, 64, 4))),
    "t5 yaml self T128": ((128, 128, 64, "tile"),
                          ((64, 64, 2), (64, 64, 2))),
    "gqa D128 T256": ((256, 256, 128, None), ((128, 64, 4), (64, 64, 4))),
    "D128 rel bias T256": ((256, 256, 128, "tile"),
                           ((128, 64, 2), (64, 64, 3))),
    "ragged 200x333 rel bias": ((200, 333, 64, "tile"),
                                ((128, 64, 4), (64, 64, 2))),
    "short Tq 40 row bias": ((40, 300, 64, "row"),
                             ((64, 64, 5), (64, 64, 2))),
    # more key tiles than the dq ring holds: sweep 1 reloads through it
    "long 256x1024 rel bias": ((256, 1024, 64, "tile"),
                               ((128, 64, 4), (64, 64, 2))),
    "long causal D128 T640": ((640, 640, 128, None),
                              ((128, 64, 5), (64, 64, 5))),
    "short D128 Tq 48 row bias": ((48, 200, 128, "row"),
                                  ((128, 64, 4), (64, 64, 2))),
}


@pytest.mark.parametrize("name", sorted(BWD_TILE_CHOICES))
def test_backward_tile_choice_is_a_function_of_the_shapes(name):
    args, want = BWD_TILE_CHOICES[name]
    tq, tk, d, bias = args
    got = tf.flash_bwd_tiles(*args)
    assert got == want
    for kernel, (block_q, block_k, stages), tiles in (
            ("dq", got[0], -(-tk // 64)), ("dkv", got[1], -(-tq // 64))):
        assert (block_q, block_k)[kernel == "dq"] == 64  # the tile
        assert 2 <= stages <= tf.MAX_STAGES
        smem = tf.flash_bwd_smem(kernel, d, block_q, block_k, stages, bias)
        assert smem <= tf.SMEM_LIMIT
        # dk/dv: always 64 keys a CTA; dq: 64 rows where two CTAs with the
        # whole key ring share an SM at D = 64 (or Tq <= 64 there), else 128
        wide = (block_k, block_q)[kernel == "dq"]
        if kernel == "dkv":
            assert wide == 64
        elif d == 128:
            assert wide == 128
        elif wide == 128:
            assert tiles > tf.MAX_STAGES or tf.flash_bwd_smem(
                kernel, d, 64, 64, max(2, tiles), bias) > tf.TWO_PER_SM
        # the ring holds every tile of the call, or as many as fit
        limit = tf.TWO_PER_SM if d == 64 and wide == 64 and (
            kernel == "dkv" or tq > 64) else tf.SMEM_LIMIT
        if stages < max(2, tiles):
            assert tf.flash_bwd_smem(kernel, d, block_q, block_k, stages + 1,
                                     bias) > limit
        else:
            assert stages == max(2, tiles)


@pytest.mark.parametrize("d", tf.BACKWARD_HEAD_DIMS)
@pytest.mark.parametrize("bias", [None, "row", "tile"])
def test_backward_smem_fits_each_head_dim_and_bias(d, bias):
    """Every tile choice fits the shared memory of a block, and at the
    training length (T = 256, D = 64) the dq kernel's ring holds all four
    key tiles with their bias: sweep 1 reloads nothing."""
    for tq, tk in ((1, 1), (40, 300), (256, 256), (1000, 77), (2048, 2048)):
        for kernel, (block_q, block_k, stages) in zip(
                ("dq", "dkv"), tf.flash_bwd_tiles(tq, tk, d, bias)):
            assert tf.flash_bwd_smem(kernel, d, block_q, block_k, stages,
                                     bias) <= tf.SMEM_LIMIT
    if d == 64:
        assert tf.flash_bwd_tiles(256, 256, 64, bias)[0][2] == 4


def test_backward_operand_checks_raise_before_any_launch():
    """The backward kernels' operand rules, held on CPU tensors (the checks
    run before the library is touched): a head dim outside {64, 128} (D =
    80 has a forward kernel only), q, k, v that are not bf16, segment ids
    without their pair, a dO or lse of the wrong shape, strides TMA cannot
    read."""
    def args(d=64, dtype=torch.bfloat16, q_seg=None, kv_seg=None, do=None,
             lse=None, q=None):
        x = torch.zeros((1, 2, 8, d), dtype=dtype)
        q = x if q is None else q
        return (q, x, x, None, None, False, 1.0, q_seg, kv_seg,
                torch.zeros((1, 2, 8)) if lse is None else lse,
                x if do is None else do)

    for fn in (tf.flash_dq_cuda,
               lambda *a: tf.flash_dkv_cuda(*a, torch.zeros((1, 2, 8)))):
        for d in (80, 96):
            with pytest.raises(ValueError, match="head dim"):
                fn(*args(d))
        with pytest.raises(TypeError, match="bf16"):
            fn(*args(dtype=torch.float32))
        seg = torch.ones((1, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="pairs"):
            fn(*args(q_seg=seg))
        with pytest.raises(ValueError, match="dO"):
            fn(*args(do=torch.zeros((1, 2, 7, 64), dtype=torch.bfloat16)))
        with pytest.raises(ValueError, match="dO"):
            fn(*args(lse=torch.zeros((1, 2, 9))))
        with pytest.raises(ValueError, match="strides"):
            fn(*args(q=torch.zeros((1, 2, 8, 128),
                                   dtype=torch.bfloat16)[..., ::2]))


def test_backward_operands_take_head_transposed_views_without_a_copy():
    """q, k, v as head-transposed views of (B, T, 3, H, D) memory and dO as
    the head-transposed view of a (B, T, H * D) gradient (the T5 layer's
    layout) go to the kernels as they are; a dO that TMA cannot read is
    copied once into (B, T, H, D) memory."""
    b, t, h, d = 2, 8, 2, 64
    qkv = torch.randn((b, t, 3, h, d)).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, t, h * d)).to(torch.bfloat16).reshape(
        b, t, h, d).transpose(1, 2)
    lse = torch.zeros((b, h, t))
    ops = tf._backward_operands(q, k, v, None, None, None, None, lse, do)
    assert all(x is y for x, y in zip(ops[:4], (q, k, v, do)))
    assert ops[4] is lse
    # dO broadcast along the rows (stride 0): copied, values unchanged
    wide = torch.randn((b, h, 1, d)).to(torch.bfloat16).expand(b, h, t, d)
    got = tf._backward_operands(q, k, v, None, None, None, None, lse,
                                wide)[3]
    assert got is not wide and torch.equal(got, wide)
    assert got.transpose(1, 2).is_contiguous()
