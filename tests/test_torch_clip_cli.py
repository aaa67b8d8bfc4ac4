"""Port parity: ThinkDiff-CLIP from its entry points against the JAX
package's, on tiny models on the CPU. The single-image FLUX CLI and the
two-image ``_flux_text`` CLI against the JAX scripts (the same weights, a
tiny FLUX + VAE + CLIP pipeline on both sides, JAX's noise draw patched
into the port's sampler), ``T5TextEmbedder`` against JAX's, and the
training CLI over a tiny CLIP config on ``cc_sbu`` shards against JAX's
``train.py`` (the same weights and tokenizer, Python's ``random`` seeded
by both bootstraps), then in a subprocess with ``--device cpu``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.test_torch_clip_data import write_cc_sbu_shards
from tests.test_torch_data import T5Tok
from tests.test_torch_flux_pipeline import (  # noqa: F401
    HW, _run_both, jax_pipe, port_pipe, trees)
from thinkdiff_torch.engines import flux_sampler as ts
from thinkdiff_torch.engines import pipeline as tp
from thinkdiff_torch.models import aligner_clip as tc
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.models.flux import FluxConfig
from thinkdiff_tpu.engines import pipeline as jp
from thinkdiff_tpu.models import aligner_clip as jc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the projector's output is FLUX's conditioning: the tiny T5's width is the
# tiny FLUX's joint_attention_dim; T5Tok's ids lie in [3, 300)
TINY_T5 = dict(vocab_size=300, d_model=FluxConfig.tiny().joint_attention_dim,
               d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
               num_heads=4)
# the inference CLIs' processor is fixed at 224: a 16 x 16 grid, 257 tokens
# pooled x2 to 65, as BLIP-2's ViT-g at its own width
TINY_VIT = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, image_size=224, patch_size=14)


def _model_cfg(**kw):
    return {"arch": "blip-vision-t5-decoder",
            "model_type": "pretrain_blip_vision_t5_decoder",
            "dtype": "float32", "load_pretrained": False,
            "mm_projector_type": "mlp2x_gelu_t5_norm",
            "vision_downsample_factor": 2,
            "layer_norm_reinit_weight_with_language_encoder": True,
            "t5_config": dict(TINY_T5), "vision_config": dict(TINY_VIT), **kw}


def _same_models(monkeypatch, built):
    """The JAX entry point's model is kept in ``built``; the port's task
    loads its frozen towers and projector into the model it builds."""
    import thinkdiff_tpu.tasks.base_task as jtask
    from thinkdiff_torch.tasks import base_task as ttask

    jbuild, tbuild = jtask.BaseTask.build_model, ttask.BaseTask.build_model

    def jax_build(self, cfg):
        built["jax"] = jbuild(self, cfg)
        # as built: JAX's runner writes the trained tree back to its model
        built["trainable"] = jax.tree.map(np.array,
                                          built["jax"].trainable_params())
        return built["jax"]

    def port_build(self, cfg):
        model, jmodel = tbuild(self, cfg), built["jax"]
        for name in ("vision", "t5"):
            load_params(model.frozen[name],
                        jax.tree.map(np.asarray, jmodel.frozen[name]))
        model.load_trainable(built["trainable"])
        built["port"] = model
        return model

    monkeypatch.setattr(jtask.BaseTask, "build_model", jax_build)
    monkeypatch.setattr(ttask.BaseTask, "build_model", port_build)


def _patch_pipelines(monkeypatch, trees, built, with_t5=False):
    """Both packages' ThinkDiffPipeline.from_pretrained give the tiny
    pipelines, with T5 text embedders on the built models' T5 when
    ``with_t5``; the port's noise is JAX's draw for the seed."""
    jpipe, pipe = jax_pipe(trees), port_pipe(trees)

    def jax_from(cls, *a, **k):
        if with_t5:
            m = built["jax"]
            jpipe.t5_embedder = jp.T5TextEmbedder(
                m.t5, {"params": m.frozen["t5"]}, T5Tok())
        return jpipe

    def port_from(cls, *a, **k):
        if with_t5:
            pipe.t5_embedder = tp.T5TextEmbedder(built["port"].frozen["t5"],
                                                 T5Tok())
        return pipe

    monkeypatch.setattr(jp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(jax_from))
    monkeypatch.setattr(tp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(port_from))

    def jax_noise(self, batch, seq_len, seed):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), (batch, seq_len, self.cfg.in_channels),
            jnp.float32)))

    monkeypatch.setattr(ts.FluxSampler, "noise", jax_noise)
    return jpipe, pipe


def _jpeg(path, seed, h=40, w=56):
    Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255)
                    .astype("uint8")).save(path)
    return str(path)


def _png(path):
    return np.asarray(Image.open(path), np.int32)


def test_flux_cli_matches_jax_script(tmp_path, monkeypatch, trees):
    """scripts/test/test_blip_vision_t5_decoder_flux.py and the port's CLI
    on one image (as configs/test_thinkdiff_clip_image_text.yaml runs it:
    no text, 65 tokens cut to max_sequence_length) write
    ``{image}_seed{seed}.png`` holding the same image: every pixel within
    one level of 255 (f32 through both; measured 0 levels). Run again, the
    port's CLI keeps the file and samples nothing."""
    built = {}
    _same_models(monkeypatch, built)
    _, pipe = _patch_pipelines(monkeypatch, trees, built)
    cfg = {"model": _model_cfg(), "datasets": {},
           "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                   "seed": 7, "image_path": _jpeg(tmp_path / "dog.jpg", 0),
                   "image_height": HW, "image_width": HW,
                   "num_inference_steps": 2, "guidance_scale": 3.5,
                   "max_sequence_length": 128}}
    jdir, pdir = _run_both("test_blip_vision_t5_decoder_flux", cfg, tmp_path,
                           monkeypatch)
    got, want = _png(pdir / "dog_seed7.png"), _png(jdir / "dog_seed7.png")
    assert got.shape == (HW // 4, HW // 4, 3)
    assert np.abs(got - want).max() <= 1
    # the conditioning the port's CLI built: the image's 65 pooled tokens
    proj = built["port"].forward_encoder(np.zeros((1, 224, 224, 3),
                                                  np.float32))
    assert proj.shape == (1, 65, TINY_T5["d_model"])
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux as cli

    monkeypatch.setattr(pipe, "generate", None)  # a second run samples nothing
    path = tmp_path / "again.yaml"
    path.write_text(yaml.safe_dump({**cfg, "run": {
        **cfg["run"], "output_dir": str(pdir)}}))
    assert cli.main(["--cfg-path", str(path), "--device", "cpu"]) == str(
        pdir / "dog_seed7.png")


def test_flux_text_cli_matches_jax_script(tmp_path, monkeypatch, trees):
    """scripts/test/test_blip_vision_t5_decoder_flux_text.py and the port's
    CLI on one two-image case ([img_1; img_2], 130 tokens) and two prompts
    ("" and one through the T5 text embedder: [img_1; img_2; text]), with
    the default output names: the same files, each pixel within one level
    (measured 0). A second run of the port's CLI skips both outputs."""
    built = {}
    _same_models(monkeypatch, built)
    _patch_pipelines(monkeypatch, trees, built, with_t5=True)
    a, b = _jpeg(tmp_path / "cat.jpg", 1), _jpeg(tmp_path / "hat.jpg", 2, 64, 32)
    cfg = {"model": _model_cfg(), "datasets": {},
           "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                   "seed": 42, "img_urls": [[a, b]],
                   "questions": ["", "wearing a red hat"],
                   "questions_names": ["null", "hat"],
                   "flux_height": HW, "flux_width": HW,
                   "flux_num_inference_steps": 2, "guidance_scale": 3.5,
                   "flux_max_sequence_length": 4}}
    jdir, pdir = _run_both("test_blip_vision_t5_decoder_flux_text", cfg,
                           tmp_path, monkeypatch)
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == [
        "cat_hat_clip_t5_flux_hat_seed_42.png",
        "cat_hat_clip_t5_flux_null_seed_42.png"]
    for n in names:
        assert np.abs(_png(pdir / n) - _png(jdir / n)).max() <= 1, n
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux_text as cli

    path = tmp_path / "again.yaml"
    path.write_text(yaml.safe_dump({**cfg, "run": {
        **cfg["run"], "output_dir": str(pdir)}}))
    assert cli.main(["--cfg-path", str(path), "--device", "cpu"]) == []


def test_flux_text_cli_inputs_and_names(tmp_path):
    """The image list (folder, JSON, urls, cut to img_urls_len), the image
    names of single and multi-image cases, and the three naming modes, as
    the JAX script makes them."""
    from scripts.test import test_blip_vision_t5_decoder_flux_text as js
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux_text as ps

    folder = tmp_path / "imgs"
    folder.mkdir()
    for n in ("b.png", "a.jpg", "c.txt"):
        (folder / n).write_bytes(b"")
    listing = tmp_path / "list.json"
    listing.write_text(json.dumps([["x/1.jpg", "y/2.png"], "z/3.jpg"]))
    runs = [{"img_folder": str(folder)}, {"img_json": str(listing)},
            {"img_urls": ["p/q.jpg", ["r.jpg", "s.jpg"]], "img_urls_len": 1},
            {"img_urls": ["p/q.jpg"], "image_names": ["named"]}]
    for run in runs:
        urls = ps._image_list(run)
        assert urls == js._image_list(run)
        assert ps._image_names(run, urls) == js._image_names(run, urls)
    for run in ({}, {"use_image_name_as_output_name": True},
                {"use_image_name_and_prompt_as_output_name": True}):
        for prompt, q in (("A red, hat!", "hat"), ("", None)):
            assert ps._output_path(run, "o", "img", prompt, q, 3) == \
                js._output_path(run, "o", "img", prompt, q, 3)


def test_t5_text_embedder_matches_jax():
    """The encoder states of texts (ids cut to max_len, right-padded with
    their mask) against JAX's embedder on the same T5: f32, within 2e-5
    (summation order)."""
    jm = jc.BlipVisionT5Decoder(_model_cfg(), seed=3)
    tm = tc.BlipVisionT5Decoder(_model_cfg(), device="cpu")
    load_params(tm.frozen["t5"], jax.tree.map(np.asarray, jm.frozen["t5"]))
    jemb = jp.T5TextEmbedder(jm.t5, {"params": jm.frozen["t5"]}, T5Tok())
    temb = tp.T5TextEmbedder(tm.frozen["t5"], T5Tok())
    for text, max_len in (("a red hat on a cat", None),
                          (["one", "two words here and more"], 3)):
        want = jemb(text, max_len=max_len)
        got = temb(text, max_len=max_len)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_t5_text_embedder_needs_its_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="T5 weights"):
        tp.T5TextEmbedder.from_pretrained(str(tmp_path / "none"),
                                          device="cpu")


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------

def _train_cfg(tmp_path, storage, **run):
    return {
        "model": _model_cfg(max_txt_len=10, vision_config=dict(
            TINY_VIT, image_size=56)),
        "datasets": {"cc_sbu": {
            "batch_size": 8, "max_txt_len": 10, "use_native_decode": False,
            "vis_processor": {"train": {"name": "blip2_image_train",
                                        "image_size": 56}},
            "text_processor": {"train": {"name": "blip_caption"}},
            "build_info": {"storage": storage}}},
        "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                "lr_sched": "linear_warmup_cosine_lr", "init_lr": 1e-2,
                "min_lr": 1e-3, "warmup_lr": 1e-6, "warmup_steps": 2,
                "weight_decay": 0.05, "max_epoch": 1, "iters_per_epoch": 4,
                "seed": 3, "log_freq": 1, "output_dir": str(tmp_path / "out"),
                "train_splits": ["train"],
                "mesh": {"data": -1, "fsdp": 1, "model": 1}, **run},
    }


def test_train_cli_matches_jax_train(tmp_path, monkeypatch):
    """train.py and ``thinkdiff_torch.train`` on one tiny CLIP config and
    the same cc_sbu shards: the same weights, tokenizer and caption splits
    (module-level random, seeded by both bootstraps) give the same four
    steps: lr equal, losses within 1e-5 relative (f32; measured 0-1.5e-7)."""
    import thinkdiff_tpu.engines.trainer as jtr
    from thinkdiff_torch import train as ttrain
    from thinkdiff_torch.engines import trainer as ttr

    storage = write_cc_sbu_shards(tmp_path / "shards", n=20, size=40)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_train_cfg(tmp_path, storage)))
    built = {}
    _same_models(monkeypatch, built)
    for cls in (jc.BlipVisionT5Decoder, tc.BlipVisionT5Decoder):
        monkeypatch.setattr(cls, "get_t5_tokenizer", lambda self: T5Tok())
    record = {"jax": [], "port": []}
    for side, mod in (("jax", jtr), ("port", ttr)):
        step = mod.Trainer.train_step

        def recorded(self, state, batch, rng=None, step=step, side=side):
            state, m = step(self, state, batch, rng)
            record[side].append((float(m["loss"]), float(m["lr"])))
            return state, m

        monkeypatch.setattr(mod.Trainer, "train_step", recorded)
    sys.path.insert(0, REPO)
    import train as jtrain

    monkeypatch.setattr(sys, "argv", ["train.py", "--cfg-path", str(path),
                                      "--job-id", "jax"])
    jtrain.main()
    ttrain.main(["--cfg-path", str(path), "--job-id", "port",
                 "--device", "cpu"])
    assert len(record["jax"]) == len(record["port"]) == 4
    for (lj, rj), (lp, rp) in zip(record["jax"], record["port"]):
        assert rp == pytest.approx(rj, rel=1e-6)
        assert lp == pytest.approx(lj, rel=1e-5)
    assert record["port"][-1][0] != record["port"][0][0]


SHIM = """import sys
from thinkdiff_torch.models.aligner_clip import BlipVisionT5Decoder
from tests.test_torch_data import T5Tok
BlipVisionT5Decoder.get_t5_tokenizer = lambda self: T5Tok()
from thinkdiff_torch import train
train.main(sys.argv[1:])
"""


def test_train_cli_trains_in_a_subprocess(tmp_path):
    """``python -m thinkdiff_torch.train --device cpu`` (a shim patches the
    T5 tokenizer) over the tiny CLIP config: log.txt with the epoch's
    loss, and the epoch's checkpoint holding the projector's leaves."""
    storage = write_cc_sbu_shards(tmp_path / "shards", n=20, size=40)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_train_cfg(tmp_path, storage)))
    shim = tmp_path / "shim.py"
    shim.write_text(SHIM)
    proc = subprocess.run(
        [sys.executable, str(shim), "--cfg-path", str(path), "--job-id", "s",
         "--device", "cpu"], env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "out" / "s"
    lines = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    train = [e for e in lines if "train_loss" in e]
    assert [e["epoch"] for e in train] == [0] and float(train[0]["train_loss"]) > 0
    ckpt = torch.load(out / "checkpoint_0.pth", weights_only=True)
    assert sorted(ckpt["model"]) == [
        "projector/layer_0/bias", "projector/layer_0/kernel",
        "projector/layer_1/bias", "projector/layer_1/kernel",
        "projector/t5_norm/weight"]


def test_clip_entry_points_default_to_the_card(tmp_path, monkeypatch):
    from thinkdiff_torch import train
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux as one
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux_text as two

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, cfg in ((train.main, "train_thinkdiff_clip.yaml"),
                      (one.main, "test_thinkdiff_clip_image_text.yaml"),
                      (two.main, "test_thinkdiff_clip_two_images.yaml")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(["--cfg-path", os.path.join(REPO, "configs", cfg)])


def test_flux_cli_launches_match_counted_calls(tmp_path, monkeypatch, trees):
    """The flash forward and RMSNorm calls of the single-image CLI's path,
    counted at their call sites (ViT, projector, CLIP-L, FLUX), equal
    clip_flux_launches: the ViT's blocks and the projector's t5_norm an
    image, CLIP-L's layers for the prompt, the FLUX blocks a step."""
    from thinkdiff_torch.models import clip_text as clip_mod
    from thinkdiff_torch.models import flux as flux_mod
    from thinkdiff_torch.models import projector as proj_mod
    from thinkdiff_torch.models import vit as vit_mod
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux as cli

    calls = {"flash_attention_fwd": 0, "rmsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for mod in (vit_mod, flux_mod, clip_mod):
        monkeypatch.setattr(mod, "flash_attention", counted(
            "flash_attention_fwd", mod.flash_attention))
    for mod in (flux_mod, proj_mod):
        monkeypatch.setattr(mod, "rmsnorm", counted("rmsnorm", mod.rmsnorm))
    model = tc.BlipVisionT5Decoder(_model_cfg(), device="cpu")
    pipe = port_pipe(trees)
    from thinkdiff_torch.tasks import base_task as ttask

    monkeypatch.setattr(ttask.BaseTask, "build_model",
                        lambda self, cfg: model)
    monkeypatch.setattr(tp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: pipe))
    cfg = {"model": _model_cfg(), "datasets": {},
           "run": {"task": "image_text_pretrain", "seed": 1,
                   "image_paths": [_jpeg(tmp_path / "a.jpg", 3),
                                   _jpeg(tmp_path / "b.jpg", 4)],
                   "image_height": HW, "image_width": HW,
                   "num_inference_steps": 2, "max_sequence_length": 128,
                   "output_dir": str(tmp_path / "out")}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = cli.main(["--cfg-path", str(path), "--device", "cpu"])
    assert out.endswith("a_b_seed1.png") and os.path.exists(out)
    want = tc.clip_flux_launches(model, pipe.sampler.cfg, 2,
                                 pipe.clip_encoder.cfg.num_layers, images=2)
    assert calls == want
    assert want == {"flash_attention_fwd": 2 * 2 + 2 * 4
                    + pipe.clip_encoder.cfg.num_layers,
                    "rmsnorm": 2 + 2 * (4 * 2 + 2 * 2)}
