"""Port parity: the CLIP-L text encoder (thinkdiff_torch.models.clip_text)
against the JAX package at tiny geometry on the CPU, on the same parameters
bridged key for key: last hidden states and the pooled output (the first
EOS of a row, the last position of a row without one), in f32 and bf16;
``convert_clip_text`` on the committed HF-layout golden."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import randomize
from thinkdiff_torch.models import clip_text as tc
from thinkdiff_torch.models.bridge import flatten, load_params
from thinkdiff_tpu.models import clip_text as jc
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root

GOLDENS = default_root()


def _jax_clip(**kw):
    cfg = jc.CLIPTextConfig.tiny(**kw)
    model = jc.CLIPTextEncoder(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 9), jnp.int32))
    return model, jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def clip_params():
    params = randomize(_jax_clip()[1], np.random.RandomState(7))
    # embeddings at the scale of a trained CLIP's (~0.02-0.1)
    params["token_embedding"]["embedding"] *= 0.5
    return params


def _ids():
    """Row 0: an EOS at 3 before the one at the end (pooled at the first);
    row 1: no EOS at all (pooled at the last position); row 2: CLIP's
    padding, EOS repeated to the end."""
    rs = np.random.RandomState(8)
    ids = rs.randint(1, 98, (3, 12)).astype(np.int64)
    ids[0, 3] = ids[0, -1] = 99
    ids[2, 5:] = 99
    return ids


def _run(params, ids, dtype_j, dtype_t):
    model, _ = _jax_clip(dtype=dtype_j)
    jh, jp = model.apply({"params": params}, jnp.asarray(ids))
    port = load_params(tc.CLIPTextEncoder(tc.CLIPTextConfig.tiny(
        dtype=dtype_t)), params)
    with torch.no_grad():
        th, tp = port(torch.from_numpy(ids))
    return ((np.asarray(jh, np.float32), np.asarray(jp, np.float32)),
            (th.float().numpy(), tp.float().numpy()))


def test_encoder_and_pooled_match_jax_f32(clip_params):
    """f32: measured max |port - JAX| 2.4e-6 at max |hidden| 3.4; limit 2e-5.
    The pooled rows are the first-EOS, last-position and padded rows'."""
    ids = _ids()
    (jh, jp), (th, tp) = _run(clip_params, ids, jnp.float32, torch.float32)
    np.testing.assert_allclose(th, jh, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tp, jp, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tp, th[np.arange(3), [3, 11, 5]])


def test_encoder_bf16_drift_within_jax(clip_params):
    """bf16: the port's error against the f32 encoder at most twice JAX's
    bf16 error (max and mean), hidden states and pooled (measured on the
    hidden states 0.80x and 1.12x)."""
    ids = _ids()
    (truth_h, truth_p), _ = _run(clip_params, ids, jnp.float32, torch.float32)
    (jh, jp), (th, tp) = _run(clip_params, ids, jnp.bfloat16, torch.bfloat16)
    for got, want, truth in ((th, jh, truth_h), (tp, jp, truth_p)):
        j_err, p_err = np.abs(want - truth), np.abs(got - truth)
        assert 0 < j_err.max() and p_err.max() <= 2.0 * j_err.max()
        assert p_err.mean() <= 2.0 * j_err.mean()


def test_convert_clip_text_matches_jax_and_golden():
    sd = dict(np.load(GOLDENS / "clip_text_ckpt.npz"))
    io = dict(np.load(GOLDENS / "clip_text_io.npz"))
    want, got = (flatten(jc.convert_clip_text(sd)),
                 flatten(tc.convert_clip_text(sd)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = load_params(tc.CLIPTextEncoder(tc.CLIPTextConfig.tiny()),
                       tc.convert_clip_text(sd))
    with torch.no_grad():
        hidden, pooled = port(torch.from_numpy(io["input_ids"]))
    np.testing.assert_allclose(hidden.numpy(), io["last_hidden"], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), io["pooled"], atol=ATOL,
                               rtol=RTOL)


def test_clip_l_geometry():
    j, t = jc.CLIPTextConfig.clip_l(), tc.CLIPTextConfig.clip_l()
    for name in ("vocab_size", "hidden_size", "intermediate_size",
                 "num_layers", "num_heads", "max_positions",
                 "layer_norm_eps", "eos_token_id"):
        assert getattr(j, name) == getattr(t, name), name
    assert t.hidden_size // t.num_heads == 64
