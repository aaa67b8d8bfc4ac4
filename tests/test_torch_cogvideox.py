"""Port parity: the CogVideoX transformer and its v-prediction DDIM sampler
(thinkdiff_torch.models.cogvideox) against the JAX package at tiny geometry
on the CPU (the kernels' plain versions), on the same parameters bridged
key for key: the transformer in f32, weight-only int8 and w8a8 at f32, the
bf16 modes against JAX's own drift, the 3D rope tables, ``cosine_betas``
and the schedule, three DDIM steps from explicit latents against JAX's
``sample``, ``convert_cogvideox`` on the committed diffusers-layout golden,
and the config's fields."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import randomize
from thinkdiff_torch.models import cogvideox as tc
from thinkdiff_torch.models.bridge import flatten, load_params
from thinkdiff_tpu.models import cogvideox as jc
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root
from thinkdiff_tpu.ops.quant import quantize_like

GOLDENS = default_root()
LAT = (2, 2, 8, 8, 4)   # (B, T, H, W, C): 2 x 4 x 4 = 32 video tokens
S_TXT = 5


def jax_cogvideox(**kw):
    """A tiny JAX CogVideoXTransformer and a zero tree of its parameters'
    structure (``jax.eval_shape`` of its init: nothing is compiled)."""
    cfg = jc.CogVideoXConfig.tiny(**kw)
    model = jc.CogVideoXTransformer(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *LAT[1:])),
                            jnp.zeros((1, S_TXT, cfg.text_dim)),
                            jnp.zeros((1,), jnp.int32))["params"]
    return model, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


@pytest.fixture(scope="module")
def cog_params():
    return randomize(jax_cogvideox()[1], np.random.RandomState(0))


def cog_inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(*LAT).astype(np.float32),
            rs.randn(LAT[0], S_TXT, 32).astype(np.float32),
            np.array([999, 320], np.int32))


def run_jax(params, args, **kw):
    model, _ = jax_cogvideox(**kw)
    return np.asarray(model.apply({"params": params},
                                  *map(jnp.asarray, args)), np.float32)


def port_model(params, **kw):
    return load_params(tc.CogVideoXTransformer(tc.CogVideoXConfig.tiny(**kw)),
                       params)


def run_port(params, args, **kw):
    with torch.no_grad():
        return port_model(params, **kw)(
            *map(torch.from_numpy, args)).float().numpy()


def quantized(params, quant, dtype):
    """JAX's structure-guided quantization of the f32 tree: every QDense
    kernel, not the plain time embedder."""
    return quantize_like(params, jax_cogvideox(dtype=dtype,
                                               quant_int8=quant)[1])


# f32 and weight-only int8 at f32: measured max |port - JAX| 7.6e-6 / 8.0e-6
# at max |out| 3.0 (summation order); the limit (6e-5 there) leaves 7x
F32_ATOL, F32_RTOL = 3e-5, 1e-5
# w8a8: an f32 rounding difference before a row's absmax quantization moves
# an element one quantum (1/127 of the row's max), and the modulation carries
# it to every token (FLUX's limits; measured here: 135 of 1024 outputs off
# by more than 1e-4, the largest 0.33% of max |out| 3.0, the mean 0.010%).
# Limits as fractions of max |out|: max 1.5%, mean 0.05%
W8A8_MAX, W8A8_MEAN = 1.5e-2, 5e-4


@pytest.mark.parametrize("quant", [False, True, "w8a8"],
                         ids=["f32", "int8", "w8a8"])
def test_transformer_matches_jax_f32(cog_params, quant):
    params = quantized(cog_params, quant, jnp.float32) if quant else cog_params
    args = cog_inputs()
    got = run_port(params, args, dtype=torch.float32, quant_int8=quant)
    want = run_jax(params, args, dtype=jnp.float32, quant_int8=quant)
    assert got.shape == LAT
    if quant != "w8a8":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
        return
    err, top = np.abs(got - want), np.abs(want).max()
    assert err.max() <= W8A8_MAX * top, err.max() / top
    assert err.mean() <= W8A8_MEAN * top, err.mean() / top


# bf16: each package rounds its bf16 intermediates in its own order; the
# port's error against the f32 model (same quantized weights) may be at most
# twice JAX's own, max and mean, as for FLUX (test_torch_flux.py; measured
# 1.00x / 1.10x / 0.99x of the max, 1.03x / 1.06x / 1.27x of the mean,
# bf16 / int8 / w8a8)
BF16_DRIFT_X = 2.0


@pytest.mark.parametrize("quant", [False, True, "w8a8"],
                         ids=["bf16", "int8-bf16", "w8a8-bf16"])
def test_transformer_bf16_drift_within_jax(cog_params, quant):
    args = cog_inputs()
    params = quantized(cog_params, quant, jnp.bfloat16) if quant else cog_params
    truth = run_jax(params, args, dtype=jnp.float32, quant_int8=quant)
    got = run_port(params, args, dtype=torch.bfloat16, quant_int8=quant)
    want = run_jax(params, args, dtype=jnp.bfloat16, quant_int8=quant)
    assert np.isfinite(got).all()
    j_err, p_err = np.abs(want - truth), np.abs(got - truth)
    assert j_err.max() > 0
    assert p_err.max() <= BF16_DRIFT_X * j_err.max()
    assert p_err.mean() <= BF16_DRIFT_X * j_err.mean()


def test_transformer_sees_text_and_timestep(cog_params):
    """The conditioning and the timestep move the output (as the JAX
    package's structural test asks of its model)."""
    lat, txt, ts = cog_inputs()
    base = run_port(cog_params, (lat, txt, ts))
    assert np.abs(base - run_port(cog_params, (lat, txt + 1.0, ts))).max() > 1e-4
    assert np.abs(base - run_port(cog_params, (lat, txt, ts[::-1].copy()))
                  ).max() > 1e-4


@pytest.mark.parametrize("thw,hd", [((13, 30, 45), 64), ((2, 4, 4), 16),
                                    ((3, 4, 5), 88)])
def test_rope_tables_identical(thw, hd):
    """The 5b's tables at 13 x 30 x 45 patches (D64) and two small grids:
    the same float64 computation rounded once, so equal to the bit."""
    want = jc.video_rope_cos_sin(*thw, hd, 10000.0)
    got = tc.video_rope_cos_sin(*thw, hd, 10000.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (int(np.prod(thw)), hd)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cosine_betas_and_schedule_identical():
    """``cosine_betas`` to the bit; the schedule's timesteps, f32 alphas and
    the dynamic guidance are JAX's loop's (its ``float`` values rounded to
    f32 as ``jnp.float32`` rounds them)."""
    for n, s in ((1000, 0.008), (50, 0.008), (1000, 0.02)):
        np.testing.assert_array_equal(tc.cosine_betas(n, s),
                                      jc.cosine_betas(n, s))
    sampler = tc.CogVideoXSampler(tc.CogVideoXConfig.tiny(), None,
                                  device="cpu")
    abar = jc.CogVideoXSampler(jc.CogVideoXConfig.tiny(), {}).alphas_bar
    np.testing.assert_array_equal(sampler.alphas_bar, abar)
    for steps, dyn in ((50, True), (3, True), (4, False)):
        sched = sampler.schedule(steps, 6.0, dyn)
        idx = np.linspace(999, 0, steps).astype(int)
        assert [s[0] for s in sched] == list(idx)
        for i, (t, a_t, a_prev, g) in enumerate(sched):
            assert a_t == np.float32(float(abar[t]))
            assert a_prev == (np.float32(float(abar[idx[i + 1]]))
                              if i + 1 < steps else np.float32(1.0))
            want = 1 + 5.0 * (1 - np.cos(np.pi * (steps - i) / steps)) / 2 \
                if dyn else 6.0
            assert g == np.float32(want)
            assert all(isinstance(x, np.float32) for x in (a_t, a_prev, g))
    assert sampler.schedule(50, 6.0)[0][3] == np.float32(6.0)


# f32 through 3 DDIM steps (6 forwards of the 2-block transformer): measured
# max |port - JAX| 1.5e-5 at max |x| 3.8 (summation order, grown by the
# steps and the guidance's 6x of the cond - uncond difference); the limit
# leaves 3x
DDIM_ATOL = 5e-5


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "fixed"])
def test_three_ddim_steps_match_jax(cog_params, dynamic):
    """The port's denoise from JAX's noise draw for seed 3 against JAX's
    ``sample`` (which draws it), 3 steps at guidance 6."""
    _, txt, _ = cog_inputs()
    b, t, h, w, c = LAT
    jsampler = jc.CogVideoXSampler(jc.CogVideoXConfig.tiny(), cog_params)
    want = np.asarray(jsampler.sample(txt, frames=t, height=h, width=w,
                                      num_steps=3, guidance=6.0,
                                      use_dynamic_cfg=dynamic, seed=3))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(3), LAT,
                                       jnp.float32))
    sampler = tc.CogVideoXSampler(tc.CogVideoXConfig.tiny(),
                                  port_model(cog_params), device="cpu")
    got = sampler.denoise(lat, txt, 3, 6.0, dynamic)
    assert got.dtype == torch.float32 and tuple(got.shape) == LAT
    np.testing.assert_allclose(got.numpy(), want, atol=DDIM_ATOL, rtol=0)


def test_sampler_noise_and_bf16_trajectory(cog_params):
    """``noise`` is a seeded draw on the sampler's device, the same for the
    same seed; a bf16 model keeps the trajectory in f32; ``sample`` is
    ``denoise`` of ``noise``."""
    cfg = tc.CogVideoXConfig.tiny(dtype=torch.bfloat16)
    sampler = tc.CogVideoXSampler(cfg, port_model(cog_params,
                                                  dtype=torch.bfloat16),
                                  device="cpu")
    n = sampler.noise(2, 2, 8, 8, 5)
    assert n.dtype == torch.float32 and tuple(n.shape) == LAT
    assert torch.equal(n, sampler.noise(2, 2, 8, 8, 5))
    assert not torch.equal(n, sampler.noise(2, 2, 8, 8, 6))
    txt = torch.from_numpy(cog_inputs()[1])
    out = sampler.sample(txt, frames=2, height=8, width=8, num_steps=2,
                         seed=5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(out, sampler.denoise(n, txt, 2))


def test_default_device_is_the_card(cog_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tc.CogVideoXSampler(tc.CogVideoXConfig.tiny(), port_model(cog_params))


def test_convert_cogvideox_matches_jax_and_golden():
    """Key for key the JAX converter's tree (the Conv2d patch embed, the
    permuted proj_out), and the golden's output through the port."""
    sd = dict(np.load(GOLDENS / "cogvideox_ckpt.npz"))
    io = dict(np.load(GOLDENS / "cogvideox_io.npz"))
    want, got = flatten(jc.convert_cogvideox(sd)), flatten(tc.convert_cogvideox(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    half = flatten(tc.convert_cogvideox(sd, dtype=np.float16))
    assert all(v.dtype == np.float16 for v in half.values())
    model = load_params(tc.CogVideoXTransformer(tc.CogVideoXConfig.tiny()),
                        tc.convert_cogvideox(sd))
    with torch.no_grad():
        out = model(torch.from_numpy(io["latent"]),
                    torch.from_numpy(io["text"]),
                    torch.from_numpy(io["timesteps"]))
    np.testing.assert_allclose(out.numpy(), io["out"], atol=ATOL, rtol=RTOL)


def test_config_drops_only_the_tpu_tile_fields():
    """The port's config has the JAX fields but the Pallas tile sizes, and
    the same 5b and tiny geometries; all three quantization modes stay."""
    jfields = {f.name for f in dataclasses.fields(jc.CogVideoXConfig)}
    tfields = {f.name for f in dataclasses.fields(tc.CogVideoXConfig)}
    assert jfields - tfields == {"attn_block_q", "attn_block_k"}
    assert tfields <= jfields
    for make in ("cogvideox_5b", "tiny"):
        j = getattr(jc.CogVideoXConfig, make)()
        t = getattr(tc.CogVideoXConfig, make)()
        for name in tfields - {"dtype"}:
            assert getattr(j, name) == getattr(t, name), (make, name)
    five = tc.CogVideoXConfig.cogvideox_5b()
    assert five.dtype == torch.bfloat16 and five.head_dim == 64
    for quant in (False, True, "int8", "w8a8"):
        assert tc.CogVideoXConfig.cogvideox_5b(
            quant_int8=quant).quant_int8 == quant
