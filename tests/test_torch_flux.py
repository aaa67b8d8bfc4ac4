"""Port parity: the FLUX MMDiT (thinkdiff_torch.models.flux) against the JAX
package at tiny geometry on the CPU (the kernels' plain versions), on the
same parameters bridged key for key: the transformer in f32 and bf16, in the
weight-only int8 and w8a8 modes on the same quantized parameters, its RoPE
tables, timestep embedding, latent packing and ids, and ``convert_flux`` on
the committed diffusers-layout golden."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.models import flux as tf
from thinkdiff_torch.models.bridge import flatten, load_params
from thinkdiff_tpu.models import flux as jf
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root
from thinkdiff_tpu.ops.quant import quantize_like

GOLDENS = default_root()
S_IMG, S_TXT = 16, 5


def jax_flux(**kw):
    """A tiny JAX FluxTransformer and its initialized parameter tree."""
    cfg = jf.FluxConfig.tiny(**kw)
    model = jf.FluxTransformer(cfg)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S_IMG, cfg.in_channels)),
        jnp.zeros((1, S_TXT, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)), jnp.ones((1,)),
        jnp.zeros((S_IMG, 3)), jnp.zeros((S_TXT, 3)), jnp.ones((1,)))
    return model, jax.tree.map(np.asarray, params["params"])


def randomize(tree, rs):
    """Every leaf redrawn so that biases and norm scales matter: kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.01), the rest N(0, 0.01) (f32)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rs)
        elif k == "kernel" and v.ndim == 2:
            out[k] = (rs.randn(*v.shape) / np.sqrt(v.shape[0])).astype(
                np.float32)
        elif k == "kernel":  # conv (kh, kw, in, out)
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            out[k] = (rs.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k.endswith("scale"):
            out[k] = (1 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def flux_params():
    return randomize(jax_flux()[1], np.random.RandomState(0))


def flux_inputs(cfg, seed=1, batch=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, S_IMG, cfg.in_channels).astype(np.float32),
            rs.randn(batch, S_TXT, cfg.joint_attention_dim).astype(np.float32),
            rs.randn(batch, cfg.pooled_projection_dim).astype(np.float32),
            np.array([0.3, 0.8][:batch], np.float32), jf.make_img_ids(8, 8),
            np.zeros((S_TXT, 3), np.float32),
            np.array([3.5, 2.0][:batch], np.float32))


def run_jax(params, args, **kw):
    model, _ = jax_flux(**kw)
    return np.asarray(model.apply({"params": params},
                                  *map(jnp.asarray, args)), np.float32)


def run_port(params, args, **kw):
    model = load_params(tf.FluxTransformer(tf.FluxConfig.tiny(**kw)), params)
    with torch.no_grad():
        return model(*map(torch.from_numpy, args)).float().numpy()


def quantized(params, quant, dtype):
    """JAX's structure-guided quantization of the f32 tree for ``quant``:
    every QDense kernel, not the plain time/text embedders."""
    return quantize_like(params, jax_flux(dtype=dtype, quant_int8=quant)[1])


# f32 and weight-only int8 at f32 activations: measured max |port - JAX|
# 1.3e-5 at max |out| ~3.5; the limit leaves 4x, still far below one bf16
# ulp of the output
F32_ATOL, F32_RTOL = 5e-5, 1e-5
# w8a8 quantizes every activation row to int8 on the fly: an f32 rounding
# difference before the absmax quantization moves an element one quantum
# (1/127 of its row's max), and the modulation carries it to every token
# (measured: 51 of 512 outputs off by up to 0.0136, 0.26% of max |out|
# 5.28, mean 3.0e-4, 0.0057%). Limits, as fractions of max |out|: the
# largest difference 1.5%, the mean 0.05%
W8A8_MAX, W8A8_MEAN = 1.5e-2, 5e-4


@pytest.mark.parametrize("quant", [False, True, "w8a8"],
                         ids=["f32", "int8", "w8a8"])
def test_transformer_matches_jax_f32(flux_params, quant):
    cfg = tf.FluxConfig.tiny()
    params = quantized(flux_params, quant, jnp.float32) if quant else flux_params
    args = flux_inputs(cfg)
    kw = dict(quant_int8=quant)
    got = run_port(params, args, dtype=torch.float32, **kw)
    want = run_jax(params, args, dtype=jnp.float32, **kw)
    assert got.shape == (2, S_IMG, cfg.in_channels)
    if quant != "w8a8":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
        return
    err, top = np.abs(got - want), np.abs(want).max()
    assert err.max() <= W8A8_MAX * top, err.max() / top
    assert err.mean() <= W8A8_MEAN * top, err.mean() / top


# bf16: each package rounds its bf16 intermediates in its own order, so the
# two differ about as much as either differs from the f32 truth (measured
# max |port - JAX| 0.047 / 0.047 / 0.066 at max |out| ~3.6, bf16 / int8 /
# w8a8). The gate is relative to JAX's own drift: the port's error against
# the f32 model (on the same quantized weights) may be at most twice JAX's
# (measured 0.94x / 1.0x / 1.22x of the max error)
BF16_DRIFT_X = 2.0


@pytest.mark.parametrize("quant", [False, True, "w8a8"],
                         ids=["bf16", "int8-bf16", "w8a8-bf16"])
def test_transformer_bf16_drift_within_jax(flux_params, quant):
    cfg = tf.FluxConfig.tiny()
    args = flux_inputs(cfg)
    params = quantized(flux_params, quant, jnp.bfloat16) if quant else flux_params
    truth = run_jax(params, args, dtype=jnp.float32, quant_int8=quant)
    got = run_port(params, args, dtype=torch.bfloat16, quant_int8=quant)
    want = run_jax(params, args, dtype=jnp.bfloat16, quant_int8=quant)
    assert np.isfinite(got).all()
    j_err, p_err = np.abs(want - truth), np.abs(got - truth)
    assert j_err.max() > 0  # bf16 differs from f32 (sanity)
    assert p_err.max() <= BF16_DRIFT_X * j_err.max()
    assert p_err.mean() <= BF16_DRIFT_X * j_err.mean()


def test_convert_flux_matches_jax_and_golden():
    """Key for key the JAX converter's tree, and the golden's output."""
    sd = dict(np.load(GOLDENS / "flux_ckpt.npz"))
    io = dict(np.load(GOLDENS / "flux_io.npz"))
    want, got = flatten(jf.convert_flux(sd)), flatten(tf.convert_flux(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bf = flatten(tf.convert_flux(sd, dtype=np.float16))
    assert all(v.dtype == np.float16 for v in bf.values())
    args = tuple(io[k] for k in ("img", "txt", "pooled", "timesteps",
                                 "img_ids", "txt_ids", "guidance"))
    out = run_port(tf.convert_flux(sd), args, dtype=torch.float32)
    np.testing.assert_allclose(out, io["out"], atol=ATOL, rtol=RTOL)


def test_rope_tables_and_rotation_identical():
    """cos/sin tables at the FLUX.1-dev axes over a 1024² image's ids and
    128 text ids (to 2 f32 ulps: the two libraries' pow/cos/sin), and the
    rotation in JAX's (B, H, S, D) layout and in the port's (B, S, H, D)."""
    ids = np.concatenate([np.zeros((128, 3), np.float32),
                          jf.make_img_ids(128, 128)])
    jc, js = jf.flux_rope_cos_sin(jnp.asarray(ids), (16, 56, 56), 10000.0)
    tc, ts = tf.flux_rope_cos_sin(torch.from_numpy(ids), (16, 56, 56),
                                  10000.0)
    assert tc.dtype == torch.float32 and tc.shape == (128 + 4096, 128)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=5e-7, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=5e-7, rtol=0)
    rs = np.random.RandomState(3)
    c, s = np.asarray(jc[:40]), np.asarray(js[:40])
    x = rs.randn(2, 3, 40, 128).astype(np.float32)
    want = np.asarray(jf.apply_rope_interleaved(jnp.asarray(x), c, s))
    got = tf.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(c),
                                    torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    bshd = tf.apply_rope_interleaved(
        torch.from_numpy(x).transpose(1, 2), torch.from_numpy(c)[:, None],
        torch.from_numpy(s)[:, None])
    np.testing.assert_array_equal(bshd.transpose(1, 2).numpy(), got.numpy())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = tf.apply_rope_interleaved(xb, torch.from_numpy(c), torch.from_numpy(s))
    wb = jf.apply_rope_interleaved(jnp.asarray(x, jnp.bfloat16), c, s)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(wb, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_timestep_embedding_identical():
    """Up to the argument's rounding: the model passes t * 1000 and the
    guidance * 1000 (3500 at 3.5), where an f32 ulp is 2.4e-4, and the two
    libraries' exp may put a frequency one ulp apart (measured max 1.06e-4);
    the limit is two ulps of the largest argument."""
    t = np.array([0.0, 1.0, 35.5, 999.0, 3500.0], np.float32)
    for flip in (True, False):
        want = np.asarray(jf.timestep_embedding(jnp.asarray(t), 256,
                                                flip=flip))
        got = tf.timestep_embedding(torch.from_numpy(t), 256, flip=flip)
        assert got.dtype == torch.float32 and got.shape == (5, 256)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_pack_unpack_and_img_ids_identical():
    rs = np.random.RandomState(0)
    lat = rs.randn(2, 8, 6, 4).astype(np.float32)
    packed = tf.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jf.pack_latents(jnp.asarray(lat))))
    back = tf.unpack_latents(packed, 8, 6)
    np.testing.assert_array_equal(back.numpy(), lat)
    np.testing.assert_array_equal(tf.unpack_latents(packed, 8, 6).numpy(),
                                  np.asarray(jf.unpack_latents(
                                      jnp.asarray(packed.numpy()), 8, 6)))
    for hw in ((128, 128), (64, 32), (2, 6)):
        got, want = tf.make_img_ids(*hw), jf.make_img_ids(*hw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_config_drops_only_the_tpu_tile_fields():
    """The port's FluxConfig has the JAX fields but the Pallas tile sizes,
    and the same FLUX.1-dev and tiny geometries."""
    import dataclasses

    jfields = {f.name for f in dataclasses.fields(jf.FluxConfig)}
    tfields = {f.name for f in dataclasses.fields(tf.FluxConfig)}
    assert jfields - tfields == {"attn_block_q", "attn_block_k"}
    assert tfields <= jfields
    for make in ("flux_dev", "tiny"):
        j, t = getattr(jf.FluxConfig, make)(), getattr(tf.FluxConfig, make)()
        for name in tfields - {"dtype"}:
            assert tuple(np.atleast_1d(getattr(j, name))) == tuple(
                np.atleast_1d(getattr(t, name))), (make, name)
    assert tf.FluxConfig.flux_dev().dtype == torch.bfloat16
    assert tf.FluxConfig.flux_dev().head_dim == 128
