"""Port parity: the FLUX VAE decoder (thinkdiff_torch.models.flux_vae)
against the JAX package at tiny geometry on the CPU, on the same parameters
bridged key for key (conv kernels in flax's (kh, kw, in, out)), in f32 and
bf16; ``convert_vae_decoder`` on the committed diffusers-layout golden; the
2x nearest upsample bit for bit against ``jax.image.resize``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_flux import randomize
from thinkdiff_torch.models import flux_vae as tv
from thinkdiff_torch.models.bridge import flatten, load_params, params_of
from thinkdiff_tpu.models import flux_vae as jv
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root

GOLDENS = default_root()


def _jax_vae(**kw):
    cfg = jv.VAEConfig.tiny(**kw)
    model = jv.VAEDecoder(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4, 4, cfg.latent_channels)))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def vae_params():
    return randomize(_jax_vae()[1], np.random.RandomState(4))


def _z(seed=5, shape=(2, 6, 5, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(params, dtype):
    return load_params(tv.VAEDecoder(tv.VAEConfig.tiny(dtype=dtype)), params)


def test_decoder_matches_jax_f32(vae_params):
    """f32, summation order only: measured max |port - JAX| 2.0e-6 at
    max |out| 2.9; limit 2e-5."""
    model, _ = _jax_vae()
    z = _z()
    want = np.asarray(model.apply({"params": vae_params}, jnp.asarray(z)))
    with torch.no_grad():
        got = _port(vae_params, torch.float32)(torch.from_numpy(z))
    assert got.shape == (2, 12, 10, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_decoder_bf16_drift_within_jax(vae_params):
    """bf16: the port's error against the f32 decoder at most twice JAX's
    bf16 error (max and mean), as for the transformer (measured 0.53x and
    0.69x)."""
    z = _z()
    truth = np.asarray(_jax_vae()[0].apply({"params": vae_params},
                                           jnp.asarray(z)))
    jm, _ = _jax_vae(dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": vae_params}, jnp.asarray(z)),
                      np.float32)
    with torch.no_grad():
        got = _port(vae_params, torch.bfloat16)(torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    j_err, p_err = np.abs(want - truth), np.abs(got - truth)
    assert 0 < j_err.max() and p_err.max() <= 2.0 * j_err.max()
    assert p_err.mean() <= 2.0 * j_err.mean()


def test_conv_kernel_keeps_the_jax_layout(vae_params):
    """Each conv's parameter is the JAX (kh, kw, in, out) kernel (so the
    bridge round-trips the tree), over memory whose (out, in, kh, kw) view
    is channels_last: the layout the convolutions take without a copy."""
    m = _port(vae_params, torch.float32)
    for name, conv in m.named_modules():
        if isinstance(conv, tv.Conv):
            w = conv.kernel.permute(3, 2, 0, 1)
            assert w.is_contiguous(memory_format=torch.channels_last), name
    back = flatten(params_of(m))
    for k, v in flatten(vae_params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_convert_vae_decoder_matches_jax_and_golden():
    sd = dict(np.load(GOLDENS / "flux_vae_ckpt.npz"))
    io = dict(np.load(GOLDENS / "flux_vae_io.npz"))
    want, got = (flatten(jv.convert_vae_decoder(sd)),
                 flatten(tv.convert_vae_decoder(sd)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.no_grad():
        out = _port(tv.convert_vae_decoder(sd), torch.float32)(
            torch.from_numpy(io["z"]))
    np.testing.assert_allclose(out.numpy(), io["out"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_upsample_bit_for_bit(dtype):
    """F.interpolate(nearest) at 2x on an NCHW view of NHWC memory equals
    jax.image.resize(..., "nearest") exactly."""
    x = np.random.RandomState(6).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x, dtype), (2, 10, 14, 3), "nearest"), np.float32)
    got = F.interpolate(torch.from_numpy(x).to(getattr(torch, dtype))
                        .permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  want)
