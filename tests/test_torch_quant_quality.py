"""The port's w8a8 / int8 quality gates (counterpart of
tests/test_quant_quality.py): whole denoise loops of the port's FLUX and
CogVideoX on the committed golden checkpoints (torch-layout weights, tiny
geometry, the CPU's plain versions), bf16, weight-only int8 and w8a8
trajectories against the f32 truth, in latent space and in pixel space
(through the golden f32 VAE); the Qwen2-VL vision tower's quantized modes
at the engine's hidden-state tap; and the SmoothQuant equalizer on the
golden FLUX weights, with the port's equalized tree held against JAX's.

The gates are JAX's: a quantized loop may drift at most GATE_X = 4 times
the drift that bf16 itself brings against f32 (bf16 is the serving
default, so its drift is the accepted floor), with JAX's catastrophic
guards (FLUX pixels: mean |delta| <= 0.3; 1e-4 as the pixel floor). The
initial noise is a numpy draw (seed 0), the same for every leg."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.engines.flux_sampler import FluxSampler, flux_sigmas
from thinkdiff_torch.models import cogvideox as tc
from thinkdiff_torch.models import cogvideox_vae as tcv
from thinkdiff_torch.models import flux as tf
from thinkdiff_torch.models import flux_vae as tfv
from thinkdiff_torch.models.bridge import flatten, load_params, tree_of
from thinkdiff_torch.ops import quant as tq
from thinkdiff_tpu.models import flux as jf
from thinkdiff_tpu.models.golden_pack import unflatten_params
from thinkdiff_tpu.ops import quant as jq

GOLD = pathlib.Path(__file__).parent / "goldens"
GATE_X = 4.0
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LEGS = {"f32": ("f32", False), "bf16": ("bf16", False),
        "int8": ("bf16", True), "w8a8": ("bf16", "w8a8")}


def _load_sd(name):
    data = np.load(GOLD / f"{name}.npz")
    return {k: data[k] for k in data.files}


def _rel(a, b, truth):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    den = np.abs(np.asarray(truth, np.float32)).mean() + 1e-8
    return float(d.mean() / den), float(d.max() / den)


def _quantized(module, fp_params, quant):
    """``module`` loaded with the f32 tree, quantized where the module
    declares QDense triplets (``quantize_like``)."""
    return load_params(module, tq.quantize_like(fp_params, module)
                       if quant else fp_params)


# --------------------------------------------------------------------------
# FLUX
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flux_fp():
    return tf.convert_flux(_load_sd("flux_ckpt"))


def _flux_model(fp_params, dtype, quant):
    cfg = tf.FluxConfig.tiny(dtype=DTYPES[dtype], quant_int8=quant)
    return cfg, _quantized(tf.FluxTransformer(cfg), fp_params, quant)


def _flux_latents(fp_params, dtype, quant, steps=6, size=32):
    cfg, model = _flux_model(fp_params, dtype, quant)
    sampler = FluxSampler(cfg, model, device="cpu")
    rs = np.random.RandomState(0)
    txt = rs.randn(1, 4, cfg.joint_attention_dim).astype(np.float32)
    pooled = rs.randn(1, cfg.pooled_projection_dim).astype(np.float32)
    lat_h = size // 8
    seq = (lat_h // 2) ** 2
    noise = rs.randn(1, seq, cfg.in_channels).astype(np.float32)
    lat = sampler.denoise(
        torch.from_numpy(noise), torch.from_numpy(txt),
        torch.from_numpy(pooled), torch.from_numpy(tf.make_img_ids(lat_h, lat_h)),
        torch.zeros((4, 3)), flux_sigmas(steps, seq), 3.5)
    return lat.numpy()


def _flux_pixels(latents):
    """The packed latents through the golden f32 VAE decoder: one yardstick
    for every leg."""
    vae = load_params(tfv.VAEDecoder(tfv.VAEConfig.tiny()),
                      tfv.convert_vae_decoder(_load_sd("flux_vae_ckpt")))
    with torch.no_grad():
        img = vae(tf.unpack_latents(torch.from_numpy(latents).float(), 4, 4))
    return img.numpy()


@pytest.fixture(scope="module")
def flux_legs(flux_fp):
    return {leg: _flux_latents(flux_fp, *LEGS[leg]) for leg in LEGS}


def test_flux_denoise_quant_latent_drift_gated(flux_legs):
    truth = flux_legs["f32"]
    floor_mean, floor_max = _rel(flux_legs["bf16"], truth, truth)
    assert floor_mean > 0, "bf16 must differ from f32"
    report = {"bf16": (floor_mean, floor_max)}
    for leg in ("int8", "w8a8"):
        m, mx = _rel(flux_legs[leg], truth, truth)
        report[leg] = (m, mx)
        assert np.isfinite(flux_legs[leg]).all(), leg
        assert m <= GATE_X * floor_mean, (leg, report)
    print("flux latent drift (mean_rel, max_rel):", report)


def test_flux_denoise_quant_pixel_drift_gated(flux_legs):
    truth = _flux_pixels(flux_legs["f32"])
    assert np.isfinite(truth).all()
    floor = np.abs(_flux_pixels(flux_legs["bf16"]) - truth).mean()
    report = {"bf16": float(floor)}
    for leg in ("int8", "w8a8"):
        d = np.abs(_flux_pixels(flux_legs[leg]) - truth)
        report[leg] = float(d.mean())
        assert d.mean() <= max(GATE_X * floor, 1e-4), (leg, report)
        assert d.mean() <= 0.3, (leg, report)  # catastrophic-failure guard
    print("flux pixel |delta| mean:", report)


def _flux_io():
    io = _load_sd("flux_io")
    return tuple(io[k] for k in ("img", "txt", "pooled", "timesteps",
                                 "img_ids", "txt_ids", "guidance"))


def test_flux_smoothquant_equalizer_on_golden_weights(flux_fp):
    """Stats from a w8a8 forward on the golden weights, equalized: the
    w8a8 forward stays at least about as close to f32 (within 1.25x of the
    plain w8a8 drift) and ``input_scale`` changed."""
    args = [torch.from_numpy(a) for a in _flux_io()]
    with torch.no_grad():
        want = _flux_model(flux_fp, "f32", False)[1](*args).numpy()
        _, model_q = _flux_model(flux_fp, "f32", "w8a8")
        got_q = model_q(*args).numpy()
        stats = tq.collect_act_stats(model_q, *args)
        eq = tq.equalize_quantized_tree(tree_of(model_q, lambda _, t: t),
                                        stats, alpha=0.5)
        got_eq = load_params(model_q, eq)(*args).numpy()
    base_mean, _ = _rel(got_q, want, want)
    eq_mean, _ = _rel(got_eq, want, want)
    print(f"flux w8a8 forward drift vs f32: plain={base_mean:.5f} "
          f"equalized={eq_mean:.5f}")
    assert eq_mean <= 1.25 * base_mean, (eq_mean, base_mean)
    scales = [v for k, v in flatten(eq).items() if k.endswith("input_scale")]
    assert scales and any(not torch.allclose(s, torch.ones_like(s))
                          for s in scales)


def test_flux_equalized_tree_matches_jax_on_the_same_stats(flux_fp):
    """JAX's stats from its own w8a8 forward on the same golden tree, both
    equalizers on them: the same keys, scales within 1e-6 relative, int8
    weights equal but at rounding ties (each by one step, at most 0.1% of
    them; the reasons in tests/test_torch_calibrate.py); and the port's
    stats against JAX's within 1e-4 relative: the modulation layers' inputs
    carry the f32 sinusoidal time embedding, whose sin and cos differ by
    ulps between the two libraries (measured 3.8e-5 at most, on the
    modulation and the final norm's inputs)."""
    cfg = jf.FluxConfig.tiny(dtype=jnp.float32, quant_int8="w8a8")
    model = jf.FluxTransformer(cfg)
    args = tuple(jnp.asarray(a) for a in _flux_io())
    struct = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    params_q = jax.tree.map(np.asarray, jq.quantize_like(flux_fp, struct))
    stats = jax.tree.map(np.asarray, jq.collect_act_stats(
        model, {"params": params_q}, *args))
    want = flatten(jq.equalize_quantized_tree(params_q, stats, 0.5))
    got = flatten(tq.equalize_quantized_tree(params_q, stats, 0.5))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if k.endswith("kernel_q"):
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
    _, model_q = _flux_model(flux_fp, "f32", "w8a8")
    port_stats = flatten(tq.collect_act_stats(
        model_q, *[torch.from_numpy(a) for a in _flux_io()]))
    flat_stats = flatten(stats)
    assert sorted(port_stats) == sorted(flat_stats)
    for k, w in flat_stats.items():
        np.testing.assert_allclose(port_stats[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# CogVideoX
# --------------------------------------------------------------------------


def _cog_latents(dtype, quant, steps=4):
    cfg = tc.CogVideoXConfig.tiny(dtype=DTYPES[dtype], quant_int8=quant)
    model = _quantized(tc.CogVideoXTransformer(cfg),
                       tc.convert_cogvideox(_load_sd("cogvideox_ckpt")), quant)
    rs = np.random.RandomState(0)
    txt = rs.randn(1, 4, cfg.text_dim).astype(np.float32)
    noise = rs.randn(1, 2, 8, 8, cfg.in_channels).astype(np.float32)
    lat = tc.CogVideoXSampler(cfg, model, device="cpu").denoise(
        torch.from_numpy(noise), torch.from_numpy(txt), num_steps=steps,
        guidance=6.0)
    return lat.numpy()


def _cog_pixels(latents):
    # this golden is a flattened parameter tree, not a torch state dict
    vae = load_params(tcv.CogVideoXVAEDecoder(tcv.CogVideoXVAEConfig.tiny()),
                      unflatten_params(_load_sd("cogvideox_vae_ckpt")))
    with torch.no_grad():
        return vae(torch.from_numpy(latents).float()).numpy()


@pytest.fixture(scope="module")
def cog_legs():
    return {leg: _cog_latents(*LEGS[leg]) for leg in LEGS}


def test_cogvideox_denoise_quant_latent_drift_gated(cog_legs):
    truth = cog_legs["f32"]
    floor_mean, _ = _rel(cog_legs["bf16"], truth, truth)
    assert floor_mean > 0
    report = {"bf16": floor_mean}
    for leg in ("int8", "w8a8"):
        m, _ = _rel(cog_legs[leg], truth, truth)
        report[leg] = m
        assert np.isfinite(cog_legs[leg]).all(), leg
        assert m <= GATE_X * floor_mean, (leg, report)
    print("cogvideox latent drift (mean_rel):", report)


def test_cogvideox_denoise_quant_pixel_drift_gated(cog_legs):
    truth = _cog_pixels(cog_legs["f32"])
    floor = np.abs(_cog_pixels(cog_legs["bf16"]) - truth).mean()
    report = {"bf16": float(floor)}
    for leg in ("int8", "w8a8"):
        d = np.abs(_cog_pixels(cog_legs[leg]) - truth)
        report[leg] = float(d.mean())
        assert d.mean() <= max(GATE_X * floor, 1e-4), (leg, report)
    print("cogvideox pixel |delta| mean:", report)


# --------------------------------------------------------------------------
# Qwen2-VL vision tower
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [True, "w8a8"])
def test_vision_tower_quant_hidden_tap_drift_gated(mode):
    """The quantized vision tower feeding the f32 decoder, judged at the
    model.norm hidden tap the engine exports: drift <= GATE_X x the bf16
    floor (floored at 1e-5) against the f32 truth."""
    import dataclasses

    from thinkdiff_torch.models import qwen2_vl as tqv

    sd = _load_sd("qwen2_vl_ckpt")
    io = np.load(GOLD / "qwen2_vl_io.npz")
    cfg = tqv.Qwen2VLConfig.tiny()
    params = tqv.convert_qwen2_vl(sd)
    ids, grid_thw = io["input_ids"], io["grid_thw"]
    pos_hw = tqv.vision_rot_pos_emb(grid_thw, cfg.vision.spatial_merge_size)
    cos, sin = tqv.vision_cos_sin(pos_hw, cfg.vision.head_dim)
    pos, _ = tqv.get_mrope_position_ids(
        ids, grid_thw, cfg.image_token_id, cfg.vision.spatial_merge_size)
    img_mask = (ids == cfg.image_token_id).astype(np.int32)[None]
    lm = load_params(tqv.Qwen2VLModel(cfg), params["lm"])

    def tap(vision_quant, dtype):
        vc = dataclasses.replace(cfg.vision, quant_int8=vision_quant,
                                 dtype=DTYPES[dtype])
        vp = (tq.quantize_tree(params["vision"], min_size=0,
                               w8a8=vision_quant == "w8a8")
              if vision_quant else params["vision"])
        tower = load_params(tqv.Qwen2VisionTower(vc), vp)
        with torch.no_grad():
            emb = tower(torch.from_numpy(io["pixel_values"]),
                        torch.from_numpy(cos), torch.from_numpy(sin))
            full = torch.zeros((1, len(ids), cfg.hidden_size))
            full[0, torch.from_numpy(img_mask[0] > 0)] = emb.float()
            _, hidden, _ = lm(
                input_ids=torch.from_numpy(ids)[None].long(),
                position_ids=torch.from_numpy(pos)[:, None, :],
                image_embeds=full, image_mask=torch.from_numpy(img_mask))
        return hidden[0].float().numpy()

    truth = tap(False, "f32")
    floor_mean = max(_rel(tap(False, "bf16"), truth, truth)[0], 1e-5)
    drift_mean, _ = _rel(tap(mode, "bf16"), truth, truth)
    assert drift_mean <= GATE_X * floor_mean, (
        f"vision {mode}: hidden-tap drift {drift_mean:.5f} vs bf16 floor "
        f"{floor_mean:.5f} (gate {GATE_X}x)")
