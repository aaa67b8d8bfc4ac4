"""Port parity: ThinkDiff-CLIP into a CogVideoX video from its CLI, against
the JAX script on tiny models on the CPU: the same CLIP weights, a tiny
CogVideoX and 3D VAE on both sides, JAX's noise draw patched into the
port's sampler; the saved latents and the frames of the written video are
compared. Then the script's readings of the run section (pinned, quirks
included), the missing-weights error, and ``cogvideo_launches`` against
counted wrapper calls."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_clip_cli import _jpeg, _model_cfg, _same_models
from tests.test_torch_cogvideox import jax_cogvideox
from tests.test_torch_cogvideox_vae import _jax_decoder
from tests.test_torch_data import T5Tok
from tests.test_torch_flux import randomize
from thinkdiff_torch.data.video_io import VideoReader
from thinkdiff_torch.engines import pipeline as tp
from thinkdiff_torch.models import cogvideox as tc
from thinkdiff_torch.models import cogvideox_vae as tv
from thinkdiff_torch.models.aligner_clip import cogvideo_launches
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_cogvideo as port
from thinkdiff_tpu.engines import pipeline as jp
from thinkdiff_tpu.models import cogvideox as jc
from thinkdiff_tpu.models import cogvideox_vae as jv

MODULE = "test_blip_vision_t5_decoder_cogvideo"
# 3 latent frames of 8 x 8 (5 frames of 16 x 16 out of the tiny VAE)
LATENT = dict(num_frames=3, latent_height=8, latent_width=8)


@pytest.fixture(scope="module")
def video_trees():
    """Seeded f32 trees of the tiny CogVideoX and 3D VAE decoder, the
    decoder's conv_out scaled so that its frames are not clipped flat."""
    cog = randomize(jax_cogvideox()[1], np.random.RandomState(1))
    vae = randomize(_jax_decoder()[1], np.random.RandomState(2))
    vae["conv_out"]["conv"] = {k: v * np.float32(0.04)
                               for k, v in vae["conv_out"]["conv"].items()}
    return cog, vae


def _patch_video(monkeypatch, video_trees, built):
    """Both scripts get the tiny CogVideoX and VAE on the same trees, and
    T5 text embedders on the built models' T5 (T5Tok); the port's noise is
    JAX's draw for the seed."""
    import thinkdiff_tpu.models.base as jbase

    cog, vae = video_trees
    monkeypatch.setattr(jbase, "maybe_load_hf_weights",
                        lambda path: {"weights": np.zeros(1)})
    monkeypatch.setattr(jc.CogVideoXConfig, "cogvideox_5b",
                        classmethod(lambda cls, **kw: jc.CogVideoXConfig.tiny()))
    monkeypatch.setattr(jc, "convert_cogvideox", lambda sd, dtype=None: cog)
    monkeypatch.setattr(jv.CogVideoXVAEConfig, "cogvideox_5b", classmethod(
        lambda cls, **kw: jv.CogVideoXVAEConfig.tiny()))
    monkeypatch.setattr(jv, "convert_cogvideox_vae", lambda sd, dtype=None: vae)

    def port_load(path, device):
        cfg = tc.CogVideoXConfig.tiny()
        sampler = tc.CogVideoXSampler(cfg, load_params(
            tc.CogVideoXTransformer(cfg), cog), device=device)
        return sampler, load_params(tv.CogVideoXVAEDecoder(
            tv.CogVideoXVAEConfig.tiny()), vae)

    monkeypatch.setattr(port, "load_cogvideo", port_load)

    def jax_embedder(cls, *a, **k):
        m = built["jax"]
        return jp.T5TextEmbedder(m.t5, {"params": m.frozen["t5"]}, T5Tok())

    monkeypatch.setattr(jp.T5TextEmbedder, "from_pretrained",
                        classmethod(jax_embedder))
    monkeypatch.setattr(tp.T5TextEmbedder, "from_pretrained", classmethod(
        lambda cls, *a, **k: tp.T5TextEmbedder(built["port"].frozen["t5"],
                                               T5Tok())))

    def jax_noise(self, batch, frames, height, width, seed):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed),
            (batch, frames, height, width, self.cfg.in_channels),
            jnp.float32)))

    monkeypatch.setattr(tc.CogVideoXSampler, "noise", jax_noise)


def _run_both(cfg, tmp_path, monkeypatch):
    """The JAX script and the port's (--device cpu) on one config, each
    under its own output_dir: {side: (returned or found video path, dir)}."""
    import importlib

    out = {}
    for side in ("jax", "port"):
        run = {**cfg["run"], "output_dir": str(tmp_path / side)}
        path = tmp_path / f"{side}.yaml"
        path.write_text(yaml.safe_dump({**cfg, "run": run}))
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [MODULE, "--cfg-path", str(path)])
            importlib.import_module(f"scripts.test.{MODULE}").main()
        else:
            port.main(["--cfg-path", str(path), "--device", "cpu"])
        out[side] = tmp_path / side
    return out["jax"], out["port"]


# the latents, f32 through 3 DDIM steps of the same 2-block transformer on
# the same condition (65 ViT tokens + the T5 text embeds): measured max
# |port - JAX| 1.7e-5 at max |x| 4.8; limit 5e-5, the sampler test's
LATENT_ATOL = 5e-5


@pytest.mark.parametrize("fmt", ["avi", "mp4"])
def test_video_cli_matches_jax_script(tmp_path, monkeypatch, video_trees, fmt):
    """scripts/test/test_blip_vision_t5_decoder_cogvideo.py and the port's
    CLI on one image and a question save the same latents
    (``save_latents``) and write ``{image}_seed{seed}.{fmt}`` (mp4 through
    cv2's encoder where it has one, else the AVI beside it) holding the same
    frames: read back by the port's VideoReader, every pixel within one
    level (measured 0 levels: the same uint8 frames through the same
    encoder give the same file)."""
    built = {}
    _same_models(monkeypatch, built)
    _patch_video(monkeypatch, video_trees, built)
    cfg = {"model": _model_cfg(), "datasets": {},
           "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                   "seed": 7, "image_path": _jpeg(tmp_path / "cat.jpg", 3),
                   "text_input": "the cat turns its head and walks away",
                   "num_inference_steps": 3, "guidance_scale": 6.0,
                   "save_latents": True, "video_format": fmt, **LATENT}}
    jdir, pdir = _run_both(cfg, tmp_path, monkeypatch)
    want = np.load(jdir / "video_latents_seed7.npy")
    got = np.load(pdir / "video_latents_seed7.npy")
    assert got.dtype == np.float32 and got.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=LATENT_ATOL, rtol=0)
    jvid = sorted(p for p in jdir.iterdir() if p.stem == "cat_seed7")
    pvid = sorted(p for p in pdir.iterdir() if p.stem == "cat_seed7")
    assert [p.name for p in pvid] == [p.name for p in jvid] and len(pvid) == 1
    a = VideoReader(str(pvid[0]))
    b = VideoReader(str(jvid[0]))
    assert len(a) == len(b) == 5
    fa = a.get_batch(range(5)).astype(np.int32)
    fb = b.get_batch(range(5)).astype(np.int32)
    assert fa.shape == (5, 16, 16, 3) and fa.std() > 0
    assert np.abs(fa - fb).max() <= 1


class _Stop(Exception):
    pass


def _readings(tmp_path, monkeypatch, run):
    """The port's CLI over ``run`` (no model work: a recording sampler
    stops it at ``sample``): the keyword arguments it passed, and the
    condition."""
    seen = {}

    class Model:
        def forward_encoder(self, pixels):
            seen["pixels"] = pixels.shape
            return torch.zeros((1, 65, 4))

    class Embedder:
        def __call__(self, text, max_len=None):
            seen["text"], seen["max_len"] = text, max_len
            return torch.ones((1, min(len(text.split()), max_len), 4))

    class Sampler:
        def sample(self, cond, **kw):
            seen.update(kw, cond=cond.shape)
            raise _Stop

    from thinkdiff_torch.tasks import base_task

    monkeypatch.setattr(base_task.BaseTask, "build_model",
                        lambda self, cfg: Model())
    monkeypatch.setattr(tp.T5TextEmbedder, "from_pretrained", classmethod(
        lambda cls, path, device=None: seen.setdefault("t5", path)
        and Embedder()))
    monkeypatch.setattr(port, "load_cogvideo", lambda path, device: (
        seen.setdefault("cogvideo", path) and Sampler(), None))
    path = tmp_path / "video.yaml"
    doc = yaml.safe_load(open("configs/test_thinkdiff_clip_video_text.yaml"))
    doc["run"] = {k: v for k, v in {**doc["run"], **run}.items()
                  if v is not None}  # None: the key left out
    path.write_text(yaml.safe_dump(doc))
    with pytest.raises(_Stop):
        port.main(["--cfg-path", str(path), "--device", "cpu"])
    return seen


def test_video_cli_reads_the_run_section_as_jax_does(tmp_path, monkeypatch):
    """The JAX script's readings, pinned: ``num_frames`` is taken as LATENT
    frames (the YAML's 49, the pixel count, asks for 49 latent frames;
    without it, 13); ``latent_height`` / ``latent_width`` (60 / 90 when
    absent; the YAML's video_height / video_width are not read);
    ``image_path`` and ``text_input`` (absent from the YAML, whose img_urls
    and questions are not read); 65 vision tokens + at most 161 text
    tokens; the YAML's steps, guidance and seed; ``image_size`` 224."""
    img = _jpeg(tmp_path / "dog.jpg", 1)
    seen = _readings(tmp_path, monkeypatch, {"image_path": img,
                                             "text_input": "a dog runs"})
    assert (seen["frames"], seen["height"], seen["width"]) == (49, 60, 90)
    assert (seen["num_steps"], seen["guidance"], seen["seed"]) == (50, 6.0, 42)
    assert seen["pixels"] == (1, 224, 224, 3)
    assert (seen["text"], seen["max_len"]) == ("a dog runs", 161)
    assert seen["cond"] == (1, 65 + 3, 4)
    assert seen["cogvideo"] == "THUDM/CogVideoX-5b"
    assert seen["t5"] == "google/flan-t5-xxl"
    seen = _readings(tmp_path, monkeypatch, {
        "image_path": img, "num_frames": None, "image_size": 112,
        "latent_height": 30, "latent_width": 45})
    assert (seen["frames"], seen["height"], seen["width"]) == (13, 30, 45)
    assert seen["pixels"] == (1, 112, 112, 3) and seen["text"] == ""
    seen = _readings(tmp_path, monkeypatch, {"image_path": img,
                                             "text_input": "w " * 400})
    assert seen["cond"] == (1, 65 + 161, 4)


def test_video_cli_raises_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="CogVideoX weights"):
        port.load_cogvideo(str(tmp_path / "missing"), "cpu")
    with pytest.raises(FileNotFoundError):
        port.load_cogvideo("THUDM/CogVideoX-5b", "cpu")


def test_cogvideo_launches_match_counted_calls(tmp_path, monkeypatch,
                                               video_trees):
    """Every call of the flash forward and RMSNorm wrappers on the video
    CLI's path, counted at their call sites (ViT, T5, projector,
    CogVideoX), equals cogvideo_launches: the ViT's blocks, the projector's
    t5_norm, the text embedder's encoder (a flash forward and two RMSNorms
    a block and the final norm), then 2 x blocks a step; and the 5b's
    counts at 50 steps."""
    from thinkdiff_torch.models import aligner_clip as clip_mod
    from thinkdiff_torch.models import cogvideox as cog_mod
    from thinkdiff_torch.models import projector as proj_mod
    from thinkdiff_torch.models import t5 as t5_mod
    from thinkdiff_torch.models import vit as vit_mod
    from thinkdiff_torch.tasks import base_task as ttask

    calls = {"flash_attention_fwd": 0, "rmsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for mod in (vit_mod, t5_mod, cog_mod):
        monkeypatch.setattr(mod, "flash_attention", counted(
            "flash_attention_fwd", mod.flash_attention))
    for mod in (t5_mod, proj_mod):
        monkeypatch.setattr(mod, "rmsnorm", counted("rmsnorm", mod.rmsnorm))
    model = clip_mod.BlipVisionT5Decoder(_model_cfg(), device="cpu")
    built = {"port": model}
    _patch_video(monkeypatch, video_trees, built)
    monkeypatch.setattr(ttask.BaseTask, "build_model",
                        lambda self, cfg: model)
    run = {"task": "image_text_pretrain", "seed": 7,
           "image_path": _jpeg(tmp_path / "cat.jpg", 3),
           "text_input": "a cat", "num_inference_steps": 2,
           "video_format": "avi", "output_dir": str(tmp_path / "out"),
           **LATENT}
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump({"model": _model_cfg(), "datasets": {},
                                    "run": run}))
    out = port.main(["--cfg-path", str(path), "--device", "cpu"])
    assert out.endswith("cat_seed7.avi") and len(VideoReader(out)) == 5
    want = cogvideo_launches(model, model.t5_cfg, tc.CogVideoXConfig.tiny(), 2)
    assert calls == want
    assert want == {"flash_attention_fwd": 2 + 2 + 2 * 2 * 2,
                    "rmsnorm": 1 + 2 * 2 + 1}
    five = cogvideo_launches(model, type(model.t5_cfg)(num_layers=24),
                             tc.CogVideoXConfig.cogvideox_5b(), 50)
    assert five == {"flash_attention_fwd": 2 + 24 + 4200, "rmsnorm": 50}
