"""Port parity: stage 3 of ThinkDiff-LVLM, aligned tokens -> a FLUX image,
against the JAX package at tiny geometry on the CPU. The flow-match
schedule, three Euler steps from explicit latents against JAX's jitted
denoise, the pipeline end to end (CLIP-L pooled embedding, denoise, VAE
decode, PNG bytes), the pooled fallback, ``from_pretrained`` without files,
the default device, the launch counts of ``flux_launches``, and both LVLM
inference CLIs against the JAX scripts on the same tiny models."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_embed_engine import ENGINE_KW, TINY_SPECIALS
from tests.test_torch_precompute import TINY_T5, qwen_params  # noqa: F401
from tests.test_torch_flux import (
    S_TXT, flux_inputs, jax_flux, randomize)
from thinkdiff_torch.engines import flux_sampler as ts
from thinkdiff_torch.engines import pipeline as tp
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_torch.models import clip_text as tc
from thinkdiff_torch.models import flux as tf
from thinkdiff_torch.models import flux_vae as tv
from thinkdiff_torch.models.aligner_lvlm import flux_launches
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_tpu.engines import flux_sampler as js
from thinkdiff_tpu.engines import pipeline as jp
from thinkdiff_tpu.models import clip_text as jc
from thinkdiff_tpu.models import flux_vae as jv

# 64 x 64 pixels: an 8 x 8 latent of 4 channels, 16 packed tokens of 16;
# the tiny VAE (two blocks) upsamples once, to 16 x 16
HW, STEPS = 64, 3
# the tiny CLIP at the tiny FLUX's pooled width and the pipeline's 77
# padded positions
CLIP_KW = dict(max_positions=77, hidden_size=24)


class ClipTok:
    """A CLIP stand-in tokenizer for the tiny encoder: BOS 98, one id a
    word, EOS 99, padded with 99 to ``max_length``."""

    def __call__(self, texts, padding=None, max_length=77, truncation=True,
                 return_tensors="np"):
        rows = []
        for t in texts:
            ids = [98] + [1 + sum(map(ord, w)) % 90 for w in t.split()] + [99]
            rows.append((ids[:max_length] + [99] * max_length)[:max_length])
        return {"input_ids": np.asarray(rows, np.int64)}


@pytest.fixture(scope="module")
def trees():
    """Seeded f32 trees of the tiny FLUX, VAE and CLIP (``CLIP_KW``), in
    the JAX layout."""
    rs = np.random.RandomState(0)
    flux = randomize(jax_flux()[1], rs)
    vae = randomize(jax.tree.map(np.asarray, jv.VAEDecoder(
        jv.VAEConfig.tiny()).init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 4, 4, 4)))["params"]), rs)
    clip_cfg = jc.CLIPTextConfig.tiny(**CLIP_KW)
    clip = randomize(jax.tree.map(np.asarray, jc.CLIPTextEncoder(
        clip_cfg).init(jax.random.PRNGKey(2), jnp.zeros(
            (1, 77), jnp.int32))["params"]), rs)
    clip["token_embedding"]["embedding"] *= 0.5
    return flux, vae, clip


def jax_pipe(trees, clip=True):
    flux, vae, clip_tree = trees
    sampler = js.FluxSampler(jax_flux()[0].cfg, flux, jv.VAEConfig.tiny(), vae)
    if not clip:
        return jp.ThinkDiffPipeline(sampler)
    return jp.ThinkDiffPipeline(
        sampler, jc.CLIPTextEncoder(jc.CLIPTextConfig.tiny(**CLIP_KW)),
        clip_tree, ClipTok())


def port_flux(tree, cfg=None):
    cfg = cfg or tf.FluxConfig.tiny()
    return load_params(tf.FluxTransformer(cfg, device="cpu"), tree)


def port_pipe(trees, clip=True):
    flux, vae, clip_tree = trees
    vae_cfg = tv.VAEConfig.tiny()
    sampler = ts.FluxSampler(
        tf.FluxConfig.tiny(), port_flux(flux), vae_cfg,
        load_params(tv.VAEDecoder(vae_cfg, device="cpu"), vae), device="cpu")
    if not clip:
        return tp.ThinkDiffPipeline(sampler)
    enc = load_params(tc.CLIPTextEncoder(tc.CLIPTextConfig.tiny(**CLIP_KW)),
                      clip_tree)
    return tp.ThinkDiffPipeline(sampler, enc, ClipTok())


def _latents(seed=3, batch=1, s=(HW // 16) ** 2, c=16):
    return np.random.RandomState(seed).randn(batch, s, c).astype(np.float32)


def test_sigmas_and_shift_identical():
    for seq in (16, 256, 1024, 4096, 4 * 4096):
        assert ts.calculate_shift(seq) == js.calculate_shift(seq)
    for args in ((28, 4096), (STEPS, 16), (2, 1024), (50, 1024, False),
                 (4, 256, False, 1.5)):
        got, want = ts.flux_sigmas(*args), js.flux_sigmas(*args)
        assert got.dtype == np.float32 and got.shape == (args[0] + 1,)
        np.testing.assert_array_equal(got, want)


# f32 through three steps of a 4-block transformer: measured max
# |port - JAX| of the final latents 1.9e-5 at max |x| 4.2 (the f32
# summation order, grown by the steps); limit 1e-4
EULER_ATOL = 1e-4


def test_three_euler_steps_match_jax(trees):
    flux = trees[0]
    cfg = tf.FluxConfig.tiny()
    _, txt, pooled, _, img_ids, txt_ids, _ = flux_inputs(cfg, batch=2)
    lat = _latents(batch=2)
    sig = js.flux_sigmas(STEPS, lat.shape[1])
    jsampler = js.FluxSampler(jax_flux()[0].cfg, flux)
    want = np.asarray(jsampler._get_denoise_fn(STEPS, 3.5)(
        flux, jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(pooled),
        jnp.asarray(img_ids), jnp.asarray(txt_ids), jnp.asarray(sig)))
    got = ts.FluxSampler(cfg, port_flux(flux), device="cpu").denoise(
        lat, txt, pooled, img_ids, txt_ids, sig, 3.5)
    assert got.dtype == torch.float32 and got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), want, atol=EULER_ATOL, rtol=0)
    # a bf16 model keeps the trajectory in f32
    bf_cfg = tf.FluxConfig.tiny(dtype=torch.bfloat16)
    bf = ts.FluxSampler(bf_cfg, port_flux(flux, bf_cfg),
                        device="cpu").denoise(lat, txt, pooled, img_ids,
                                              txt_ids, sig, 3.5)
    assert bf.dtype == torch.float32 and torch.isfinite(bf).all()


def test_pipeline_end_to_end_on_explicit_latents(trees, tmp_path,
                                                 monkeypatch):
    """generate() with the CLIP pooled embedding of a prompt, three steps
    and the VAE decode, from the same latents as JAX's denoise and decode
    (the sampler's noise draw returns them): images within 2e-5 (f32;
    measured 2.1e-6); then the same image array through both packages'
    save_images gives the same PNG bytes."""
    cfg = tf.FluxConfig.tiny()
    txt = flux_inputs(cfg, batch=1)[1]
    lat = _latents()
    jpipe, pipe = jax_pipe(trees), port_pipe(trees)
    embeds, pooled = jpipe.encode_prompt("a red cube", txt)
    sig = js.flux_sigmas(STEPS, lat.shape[1])
    den = jpipe.sampler._get_denoise_fn(STEPS, 3.5)(
        trees[0], jnp.asarray(lat), embeds, jnp.asarray(pooled),
        jnp.asarray(js.make_img_ids(HW // 8, HW // 8)),
        jnp.zeros((S_TXT, 3), jnp.float32), jnp.asarray(sig))
    want = np.asarray(jpipe.sampler._get_decode_fn()(
        trees[1], js.unpack_latents(den, HW // 8, HW // 8)))
    drawn = pipe.sampler.noise(1, lat.shape[1], 5)
    assert drawn.dtype == torch.float32 and drawn.shape == lat.shape
    assert torch.equal(drawn, pipe.sampler.noise(1, lat.shape[1], 5))
    monkeypatch.setattr(pipe.sampler, "noise",
                        lambda b, n, seed: torch.from_numpy(lat))
    got = pipe.generate(txt, prompt="a red cube", height=HW, width=HW,
                        num_steps=STEPS, guidance=3.5)
    assert got.shape == (1, HW // 4, HW // 4, 3) and got.dtype == torch.float32
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(pipe.pooled_from_prompt("a red cube").numpy(),
                               np.asarray(pooled), atol=2e-6, rtol=0)
    # PNG bytes: f32 images, and bf16 ones (img * 255 rounded to bf16 first)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        img = torch.from_numpy(want.copy()).to(dtype)
        ts.save_images(img, [str(tmp_path / "port.png")])
        js.save_images(jnp.asarray(want, jdtype), [str(tmp_path / "jax.png")])
        assert ((tmp_path / "port.png").read_bytes()
                == (tmp_path / "jax.png").read_bytes())


def test_pooled_is_zeros_without_clip_and_cached(trees):
    cfg = tf.FluxConfig.tiny()
    pipe = port_pipe(trees, clip=False)
    z = pipe.pooled_from_prompt("", batch=3)
    assert z.shape == (3, cfg.pooled_projection_dim) and z.dtype == torch.float32
    assert not z.any()
    np.testing.assert_array_equal(
        z.numpy(), jax_pipe(trees, clip=False).pooled_from_prompt("", batch=3))
    pipe.clip_tokenizer = None
    assert not port_pipe(trees, clip=False).pooled_from_prompt("x").any()
    pipe = port_pipe(trees)
    first = pipe.pooled_from_prompt("", batch=2)
    assert first.shape == (2, cfg.pooled_projection_dim) and first.any()
    assert pipe.pooled_from_prompt("", batch=2) is first
    emb, pooled = pipe.encode_prompt("", flux_inputs(cfg, batch=1)[1][0])
    assert emb.shape == (1, S_TXT, cfg.joint_attention_dim)
    assert pooled.shape == (1, cfg.pooled_projection_dim)
    with pytest.raises(ValueError):
        pipe.encode_prompt("", None)
    cond = pipe.compose_clip_condition(
        [np.ones((1, 3, 4)), np.zeros((1, 2, 4))], np.full((1, 4, 4), 2.0),
        max_len=8)
    want = jp.ThinkDiffPipeline(None).compose_clip_condition(
        [np.ones((1, 3, 4)), np.zeros((1, 2, 4))], np.full((1, 4, 4), 2.0),
        max_len=8)
    np.testing.assert_array_equal(cond.numpy(), np.asarray(want))


def test_from_pretrained_raises_without_files(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    for load in (ts.FluxSampler.from_pretrained, tp.ThinkDiffPipeline
                 .from_pretrained):
        with pytest.raises(FileNotFoundError, match="FLUX weights"):
            load(str(tmp_path / "missing"), device="cpu")
        with pytest.raises(FileNotFoundError):
            load("black-forest-labs/FLUX.1-dev", device="cpu")


def test_default_device_is_the_card(trees, monkeypatch):
    """The sampler and the pipeline default to CUDA and raise without a
    card, before looking for weights."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flux = port_flux(trees[0])
    for build in (lambda: ts.FluxSampler(tf.FluxConfig.tiny(), flux),
                  lambda: ts.FluxSampler.from_pretrained("/nowhere"),
                  lambda: tp.ThinkDiffPipeline.from_pretrained("/nowhere")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
    assert ts.FluxSampler(tf.FluxConfig.tiny(), flux,
                          device="cpu").device == torch.device("cpu")


def test_flux_launches_match_counted_calls(trees, monkeypatch):
    """Every call of the flash forward and RMSNorm wrappers on the path,
    counted at their call sites in the FLUX and CLIP modules, equals
    flux_launches: CLIP-L's layers once for a prompt, then the blocks of
    each step; a second image of the same prompt reuses the pooled
    embedding."""
    from thinkdiff_torch.models import clip_text as clip_mod
    from thinkdiff_torch.models import flux as flux_mod

    calls = {"flash_attention_fwd": 0, "rmsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for mod in (flux_mod, clip_mod):
        monkeypatch.setattr(mod, "flash_attention", counted(
            "flash_attention_fwd", mod.flash_attention))
    monkeypatch.setattr(flux_mod, "rmsnorm", counted("rmsnorm",
                                                     flux_mod.rmsnorm))
    pipe = port_pipe(trees)
    cfg = pipe.sampler.cfg
    txt = flux_inputs(cfg, batch=1)[1]
    kw = dict(height=HW, width=HW, num_steps=STEPS)
    pipe.generate(txt, **kw)
    clip_layers = pipe.clip_encoder.cfg.num_layers
    assert calls == flux_launches(cfg, STEPS, clip_layers)
    assert calls == {"flash_attention_fwd": STEPS * 4 + clip_layers,
                     "rmsnorm": STEPS * (4 * 2 + 2 * 2)}
    pipe.generate(txt, **kw)
    want = flux_launches(cfg, 2 * STEPS, clip_layers)
    assert calls == want
    dev = tf.FluxConfig.flux_dev()
    assert flux_launches(dev, 28, 12) == {
        "flash_attention_fwd": 1596 + 12, "rmsnorm": 4256}


# ---------------------------------------------------------------------------
# The LVLM inference CLIs against the JAX scripts
# ---------------------------------------------------------------------------

def _engines(monkeypatch, qwen_params):
    """Both packages' EmbedEngine.from_config give a tiny greedy engine on
    the same Qwen2-VL weights."""
    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.models import qwen2_vl as tm
    from thinkdiff_tpu.engines import embed_engine as je
    from thinkdiff_tpu.models import qwen2_vl as jm

    tok = lambda: StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201)
    monkeypatch.setattr(je.EmbedEngine, "from_config", classmethod(
        lambda cls, cfg: je.EmbedEngine(jm.Qwen2VLConfig.tiny(), qwen_params,
                                        tok(), **ENGINE_KW)))
    monkeypatch.setattr(te.EmbedEngine, "from_config", classmethod(
        lambda cls, cfg, device="cuda": te.EmbedEngine(
            tm.Qwen2VLConfig.tiny(), qwen_params, tok(), device="cpu",
            **ENGINE_KW)))


def _same_models(monkeypatch):
    """The JAX script's model is kept; the port's task loads its frozen T5
    and projector into the model it builds."""
    import thinkdiff_tpu.tasks.base_task as jtask
    from thinkdiff_torch.tasks import base_task as ttask

    built = {}
    jbuild, tbuild = jtask.BaseTask.build_model, ttask.BaseTask.build_model

    def jax_build(self, cfg):
        built["jax"] = jbuild(self, cfg)
        return built["jax"]

    def port_build(self, cfg):
        model, jmodel = tbuild(self, cfg), built["jax"]
        load_params(model.frozen["t5"],
                    jax.tree.map(np.asarray, jmodel.frozen["t5"]))
        model.load_trainable(jax.tree.map(np.asarray,
                                          jmodel.trainable_params()))
        return model

    monkeypatch.setattr(jtask.BaseTask, "build_model", jax_build)
    monkeypatch.setattr(ttask.BaseTask, "build_model", port_build)


def _run_both(module, cfg, tmp_path, monkeypatch):
    """The JAX script (scripts/test/<module>.py) and the port's
    (thinkdiff_torch/scripts/<module>.py, --device cpu) on one config, each
    writing under its own output_dir: (JAX's dir, the port's dir)."""
    import importlib

    out = {}
    for side in ("jax", "port"):
        run = {**cfg["run"], "output_dir": str(tmp_path / side)}
        path = tmp_path / f"{side}.yaml"
        path.write_text(yaml.safe_dump({**cfg, "run": run}))
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [module, "--cfg-path", str(path)])
            importlib.import_module(f"scripts.test.{module}").main()
        else:
            importlib.import_module(f"thinkdiff_torch.scripts.{module}").main(
                ["--cfg-path", str(path), "--device", "cpu"])
        out[side] = tmp_path / side
    return out["jax"], out["port"]


def _model_cfg(**kw):
    return {"arch": "mllama-vllm-t5-embed-decoder-5", "dtype": "float32",
            "load_pretrained": False, "vlm_hidden_size": 64,
            "t5_config": TINY_T5,
            "vllm_config": {"embedding_layer_name": "model.norm"}, **kw}


@pytest.mark.parametrize("mode,raw", [("get_text", False), ("get_text", True),
                                      ("generate", False), ("generate", True)])
def test_text_cli_matches_jax_script(tmp_path, monkeypatch, qwen_params, mode,
                                     raw):
    """scripts/test/test_mllama_t5_decoder_text.py and the port's CLI on
    the same tiny overrides (tests/test_inference_scripts.py's
    test_text_only_script) and weights: identical records (VLM texts, T5
    ids and texts)."""
    _engines(monkeypatch, qwen_params)
    _same_models(monkeypatch)
    cfg = {"model": _model_cfg(), "datasets": {},
           "run": {"task": "image_text_pretrain", "seed": 0,
                   "prompts": ["tell me a story", "another one"],
                   "max_new_tokens": 5, "t5_max_new_tokens": 3,
                   "mode": mode, "raw_prompts": raw}}
    jdir, pdir = _run_both("test_mllama_t5_decoder_text", cfg, tmp_path,
                           monkeypatch)
    name = f"{mode}_results.json"
    got = json.loads((pdir / name).read_text())
    want = json.loads((jdir / name).read_text())
    assert len(got) == 2 and got == want
    if mode == "generate":
        assert all(1 <= len(r["t5_token_ids"]) <= 3 for r in got)


def test_flux_cli_matches_jax_script(tmp_path, monkeypatch, qwen_params, trees):
    """scripts/test/test_mllama_t5_decoder_flux.py and the port's CLI with
    tiny models patched in (the engine, the aligner's weights, a tiny FLUX
    + VAE + CLIP pipeline on both sides) write ``{image}_seed{seed}.png``.
    The port's initial noise is made JAX's draw for the seed, so the two
    PNGs hold the same image: every pixel within one level of 255 (f32
    through both; measured 0 levels)."""
    from PIL import Image

    _engines(monkeypatch, qwen_params)
    _same_models(monkeypatch)
    jpipe, pipe = jax_pipe(trees), port_pipe(trees)
    monkeypatch.setattr(jp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: jpipe))
    monkeypatch.setattr(tp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: pipe))

    def jax_noise(self, batch, seq_len, seed):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), (batch, seq_len, self.cfg.in_channels),
            jnp.float32)))

    monkeypatch.setattr(ts.FluxSampler, "noise", jax_noise)
    img_path = tmp_path / "cat.jpg"
    Image.fromarray((np.random.RandomState(0).rand(24, 16, 3) * 255)
                    .astype("uint8")).save(img_path)
    cfg = {"model": _model_cfg(t5_config={
               **TINY_T5, "d_model": tf.FluxConfig.tiny().joint_attention_dim}),
           "datasets": {},
           "run": {"task": "image_text_pretrain", "seed": 7,
                   "image_path": str(img_path), "text_input": "describe it",
                   "embedding_type": "output_embed", "max_new_tokens": 5,
                   "image_height": HW, "image_width": HW,
                   "num_inference_steps": 2, "guidance_scale": 3.5}}
    jdir, pdir = _run_both("test_mllama_t5_decoder_flux", cfg, tmp_path,
                           monkeypatch)
    got = np.asarray(Image.open(pdir / "cat_seed7.png"), np.int32)
    want = np.asarray(Image.open(jdir / "cat_seed7.png"), np.int32)
    assert got.shape == (HW // 4, HW // 4, 3)
    assert np.abs(got - want).max() <= 1
