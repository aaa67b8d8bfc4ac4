"""Port parity: the CogVideoX 3D causal VAE decoder
(thinkdiff_torch.models.cogvideox_vae) against the JAX package at tiny
geometry on the CPU, on the same parameters bridged key for key: its blocks
(causal conv, spatial norm with the split first frame, resnet, temporal
upsample), the decoder in f32 and bf16, the decoder on the committed
self-golden, ``decode_latents`` monolithic and tiled (uint8 frames against
JAX's), one tile covering the latents equal to the monolithic decode, the
tile rule and starts, and ``convert_cogvideox_vae``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import randomize
from thinkdiff_torch.models import cogvideox_vae as tv
from thinkdiff_torch.models.bridge import flatten, load_params, params_of
from thinkdiff_tpu.models import cogvideox_vae as jv
from thinkdiff_tpu.models.golden_pack import (
    ATOL, RTOL, default_root, unflatten_params)

GOLDENS = default_root()


def _zeros_like_init(module, *inputs):
    """A zero tree of ``module``'s parameter structure (``jax.eval_shape``
    of its init: nothing is compiled)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *inputs)["params"]
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def _jax_decoder(**kw):
    cfg = jv.CogVideoXVAEConfig.tiny(**kw)
    dec = jv.CogVideoXVAEDecoder(cfg)
    return dec, _zeros_like_init(dec, jnp.zeros((1, 3, 4, 4,
                                                  cfg.latent_channels)))


@pytest.fixture(scope="module")
def vae_params():
    return randomize(_jax_decoder()[1], np.random.RandomState(4))


def _z(shape=(2, 3, 6, 5, 4), seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(params, dtype=torch.float32):
    return load_params(tv.CogVideoXVAEDecoder(
        tv.CogVideoXVAEConfig.tiny(dtype=dtype)), params)


def _block(jmod, tmod, inputs, seed=6):
    """A JAX block and the port's on seeded parameters of JAX's tree:
    (JAX's output, the port's)."""
    params = randomize(_zeros_like_init(jmod, *map(jnp.asarray, inputs)),
                       np.random.RandomState(seed))
    want = np.asarray(jmod.apply({"params": params}, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = load_params(tmod, params)(*map(torch.from_numpy, inputs))
    return want, got.numpy()


# the blocks in f32 on seeded weights (outputs up to ~30): summation order
# only, held relative to the largest output (measured up to 7e-7 of it)
BLOCK_REL = 5e-6


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BLOCK_REL * np.abs(want).max())


def test_causal_conv_matches_jax_and_is_causal():
    x = _z((1, 4, 6, 5, 3))
    want, got = _block(jv.CausalConv3d(7, (3, 3, 3)),
                       tv.CausalConv3d(3, 7, (3, 3, 3)), (x,))
    assert got.shape == (1, 4, 6, 5, 7)
    _close(got, want)
    # frame t sees frames <= t only: a change at frame 3 leaves 0-2 alone
    conv = tv.CausalConv3d(3, 7, (3, 3, 3))
    torch.nn.init.normal_(conv.conv.kernel)
    x2 = x.copy()
    x2[:, 3] += 1.0
    with torch.no_grad():
        y1, y2 = conv(torch.from_numpy(x)), conv(torch.from_numpy(x2))
    assert torch.equal(y1[:, :3], y2[:, :3])
    assert (y1[:, 3] - y2[:, 3]).abs().max() > 1e-3
    w1, w2 = _block(jv.CausalConv3d(7, (1, 1, 1)),
                    tv.CausalConv3d(3, 7, (1, 1, 1)), (x,))
    _close(w2, w1)


@pytest.mark.parametrize("t,tz", [(5, 3), (4, 2), (3, 3)],
                         ids=["split-first", "even", "same"])
def test_spatial_norm_matches_jax(t, tz):
    """2n+1 frames against n+1 latents resize the first frame alone."""
    f, zq = _z((1, t, 8, 6, 8)), _z((1, tz, 4, 3, 4), seed=7)
    want, got = _block(jv.SpatialNorm3D(4), tv.SpatialNorm3D(8, 4, 4,
                                                             torch.float32),
                       (f, zq))
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)],
                         ids=["same", "shortcut"])
def test_resnet_block_matches_jax(cin, cout):
    x, zq = _z((1, 3, 4, 4, cin)), _z((1, 3, 2, 2, 4), seed=8)
    want, got = _block(jv.ResnetBlock3D(cout, 4),
                       tv.ResnetBlock3D(cin, cout, 4, 4, torch.float32),
                       (x, zq))
    assert got.shape == (1, 3, 4, 4, cout)
    _close(got, want)


@pytest.mark.parametrize("compress,t", [(True, 3), (False, 3), (True, 1)],
                         ids=["time", "space", "one-frame"])
def test_upsample_matches_jax(compress, t):
    """T -> 2T - 1 with the first frame single (compress_time), space 2x."""
    x = _z((2, t, 3, 4, 6))
    want, got = _block(jv.Upsample3D(6, compress_time=compress),
                       tv.Upsample3D(6, compress, torch.float32), (x,))
    assert got.shape == (2, 2 * t - 1 if compress else t, 6, 8, 6)
    _close(got, want)


def test_decoder_matches_jax_f32(vae_params):
    """f32: measured max |port - JAX| 2.4e-5 at max |out| 24.7 (seeded
    weights, unscaled), within 2e-5 + 2e-5 |want|. 3 latent frames decode to
    5 (one temporal level), 2x in space."""
    dec, _ = _jax_decoder()
    z = _z()
    want = np.asarray(dec.apply({"params": vae_params}, jnp.asarray(z)))
    with torch.no_grad():
        got = _port(vae_params)(torch.from_numpy(z))
    assert got.shape == (2, 5, 12, 10, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_decoder_bf16_drift_within_jax(vae_params):
    """bf16: the port's error against the f32 decoder at most twice JAX's
    own bf16 error (max and mean), as for the transformers."""
    z = _z()
    truth = np.asarray(_jax_decoder()[0].apply({"params": vae_params},
                                               jnp.asarray(z)))
    jm, _ = _jax_decoder(dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": vae_params}, jnp.asarray(z)),
                      np.float32)
    with torch.no_grad():
        got = _port(vae_params, torch.bfloat16)(torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    j_err, p_err = np.abs(want - truth), np.abs(got - truth)
    assert 0 < j_err.max() and p_err.max() <= 2.0 * j_err.max()
    assert p_err.mean() <= 2.0 * j_err.mean()


def test_decoder_on_the_golden():
    flat = dict(np.load(GOLDENS / "cogvideox_vae_ckpt.npz"))
    io = dict(np.load(GOLDENS / "cogvideox_vae_io.npz"))
    with torch.no_grad():
        out = _port(unflatten_params(flat))(torch.from_numpy(io["z"]))
    np.testing.assert_allclose(out.numpy(), io["out"], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def frame_params(vae_params):
    """The seeded decoder with conv_out scaled by 0.04, so that its output
    lies mostly inside [-1, 1] (max |out| 1.5, 0.03% clipped) and the uint8
    frames carry the decode, not the clip."""
    out = {**vae_params, "conv_out": {"conv": {
        k: v * np.float32(0.04)
        for k, v in vae_params["conv_out"]["conv"].items()}}}
    return out


def _decode_both(params, z, **kw):
    dec, _ = _jax_decoder()
    want = jv.decode_latents(dec, params, z, **kw)
    got = tv.decode_latents(_port(params), torch.from_numpy(z), **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    return want.astype(np.int32), got.numpy().astype(np.int32)


# uint8 frames of f32 decodes: a pixel whose value lies within the f32
# difference (~1e-6) of a level's edge truncates one level apart (measured:
# 0 pixels of 11,520, monolithic and each tiling); limit one level, on at
# most 0.1% of pixels
def _uint8_close(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("tile,overlap", [(None, 8), ((8, 10), 4),
                                          ((5, 7), 2)],
                         ids=["monolithic", "2x2", "3x3"])
def test_decode_latents_matches_jax(frame_params, tile, overlap):
    """JAX's clamped starts and ramp blend: the same uint8 frames, tiled or
    not (scaled latents, the tiny scaling factor)."""
    z = _z((1, 3, 12, 16, 4), seed=1)
    want, got = _decode_both(frame_params, z, tile=tile, tile_overlap=overlap)
    assert got.shape == (1, 5, 24, 32, 3)
    _uint8_close(got, want)


def test_single_tile_equals_monolithic(frame_params):
    """A tile covering the whole latent is the monolithic decode, to the
    bit (the blend weights are ones)."""
    z = torch.from_numpy(_z((1, 3, 6, 8, 4), seed=0))
    dec = _port(frame_params)
    mono = tv.decode_latents(dec, z, tile=None)
    assert torch.equal(mono, tv.decode_latents(dec, z, tile=(6, 8)))
    assert torch.equal(mono, tv.decode_latents(dec, z, tile=(9, 11)))
    assert torch.equal(mono, tv.decode_latents(dec, z))  # auto: one pass


def test_tile_rule_and_starts():
    """At the 5b operating point (13 x 60 x 90 latents, 49 frames of 480 x
    720, 128 top channels: 4.3 GB) the rule tiles at (32, 48): starts
    [0, 24, 28] x [0, 40, 42], 9 tiles; 13 x 30 x 45 (1.1 GB) decodes in
    one pass. The starts are JAX's."""
    five = tv.CogVideoXVAEConfig.cogvideox_5b()
    assert tv.auto_tile(five, (1, 13, 60, 90, 16)) == (32, 48)
    assert tv.auto_tile(five, (1, 13, 30, 45, 16)) is None
    assert tv.tile_starts(60, 32, 8) == [0, 24, 28]
    assert tv.tile_starts(90, 48, 8) == [0, 40, 42]
    assert tv.tile_starts(20, 32, 8) == [0]
    assert (five.scaling_factor, five.dtype) == (0.7, torch.bfloat16)
    # JAX's inline rule at three latent sizes (the 5b decoder itself is out
    # of a CPU test's reach)
    for shape in ((1, 13, 60, 90, 16), (1, 13, 30, 45, 16), (1, 7, 60, 90, 16)):
        t_out = (shape[1] - 1) * 4 + 1
        top = t_out * 8 * shape[2] * 8 * shape[3] * 128 * 2
        assert (tv.auto_tile(five, shape) is not None) == (top > 2 * 2 ** 30)


def test_convert_matches_jax_and_round_trips(vae_params):
    """A diffusers-layout state dict of the tiny geometry: the port's
    converter gives JAX's tree key for key, and that tree loads into the
    port's decoder and comes back out (the bridge's inverse)."""
    rs = np.random.RandomState(0)
    sd = {}
    for name, leaf in flatten(vae_params).items():
        parts = name.split("/")
        if parts[0].startswith("mid_res_"):
            prefix = f"decoder.mid_block.resnets.{parts[0][-1]}"
        elif "_res_" in parts[0]:
            _, bi, _, ri = parts[0].split("_")
            prefix = f"decoder.up_blocks.{bi}.resnets.{ri}"
        elif parts[0].endswith("_upsample"):
            prefix = f"decoder.up_blocks.{parts[0].split('_')[1]}.upsamplers.0"
        else:
            prefix = f"decoder.{parts[0]}"
        key = ".".join([prefix] + parts[1:-1])
        leaf_name = {"kernel": "weight", "scale": "weight"}.get(parts[-1],
                                                               parts[-1])
        shape = leaf.shape
        if parts[-1] == "kernel":
            shape = (shape[-1], shape[-2], *shape[:-2])
        sd[f"{key}.{leaf_name}"] = rs.randn(*shape).astype(np.float32)
    want = flatten(jv.convert_cogvideox_vae(sd))
    got = flatten(tv.convert_cogvideox_vae(sd))
    assert sorted(got) == sorted(want) == sorted(flatten(vae_params))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    half = flatten(tv.convert_cogvideox_vae(sd, dtype=np.float16))
    assert all(v.dtype == np.float16 for v in half.values())
    back = flatten(params_of(_port(tv.convert_cogvideox_vae(sd))))
    for k in want:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
