"""Port parity: the six remaining ThinkDiff-LVLM FLUX CLIs against their JAX
scripts on tiny models on the CPU (the same engine, aligner and FLUX
pipeline weights on both sides, JAX's noise draw patched into the port's
sampler): the multi-image CLI, the replay of an exported embedding with
extra T5 text, the text-only embed probe (padded and cut), and the three
exporters (single image, CoBSAT multi-image, CoBSAT batch), whose exports
are compared and then replayed."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_clip_cli import _model_cfg as _clip_model_cfg
from tests.test_torch_data import T5Tok
from tests.test_torch_flux_pipeline import (  # noqa: F401
    HW, _engines, _model_cfg, _run_both, _same_models, jax_pipe, port_pipe,
    trees)
from tests.test_torch_precompute import qwen_params  # noqa: F401
from thinkdiff_torch.engines import flux_sampler as ts
from thinkdiff_torch.engines import pipeline as tp
from thinkdiff_torch.models import aligner_clip as tclip
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_tpu.engines import pipeline as jp
from thinkdiff_tpu.models import aligner_clip as jclip

PREFIX = "test_mllama_t5_decoder_flux"
RUN = {"task": "image_text_pretrain", "seed": 7, "max_new_tokens": 5,
       "image_height": HW, "image_width": HW, "num_inference_steps": 2,
       "guidance_scale": 3.5}


@functools.lru_cache(maxsize=1)
def _t5_models():
    """One tiny T5 encoder in both packages (a tiny CLIP model's), built
    when a CLI first asks for the text embedder."""
    jm = jclip.BlipVisionT5Decoder(_clip_model_cfg(), seed=3)
    tm = tclip.BlipVisionT5Decoder(_clip_model_cfg(), device="cpu")
    load_params(tm.frozen["t5"], jax.tree.map(np.asarray, jm.frozen["t5"]))
    return jm, tm


@pytest.fixture
def both(monkeypatch, qwen_params, trees):
    """The tiny engines and aligners of both packages, both pipelines
    patched into from_pretrained, T5 text embedders on one tiny T5 encoder
    on both sides, and the port's noise made JAX's draw."""
    _engines(monkeypatch, qwen_params)
    _same_models(monkeypatch)
    jpipe, pipe = jax_pipe(trees), port_pipe(trees)
    monkeypatch.setattr(jp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: jpipe))
    monkeypatch.setattr(tp.ThinkDiffPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: pipe))
    monkeypatch.setattr(jp.T5TextEmbedder, "from_pretrained", classmethod(
        lambda cls, *a, **k: jp.T5TextEmbedder(
            _t5_models()[0].t5, {"params": _t5_models()[0].frozen["t5"]},
            T5Tok())))
    monkeypatch.setattr(tp.T5TextEmbedder, "from_pretrained", classmethod(
        lambda cls, *a, **k: tp.T5TextEmbedder(_t5_models()[1].frozen["t5"],
                                               T5Tok())))

    def jax_noise(self, batch, seq_len, seed):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), (batch, seq_len, self.cfg.in_channels),
            jnp.float32)))

    monkeypatch.setattr(ts.FluxSampler, "noise", jax_noise)


def _images(tmp_path, n, seed=0):
    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"img{i}.jpg"))
        Image.fromarray((rs.rand(24, 16 + 8 * i, 3) * 255).astype("uint8")
                        ).save(paths[-1])
    return paths


def _cfg(run, **model):
    return {"model": _model_cfg(**model), "datasets": {},
            "run": {**RUN, **run}}


def _same_png(jdir, pdir, name):
    """The two scripts' PNGs hold the same image: every pixel within one
    level of 255 (f32 through both; measured 0 levels, 1 in three of the
    ten images: a value at a level's edge truncated apart)."""
    got = np.asarray(Image.open(pdir / name), np.int32)
    want = np.asarray(Image.open(jdir / name), np.int32)
    assert got.shape == (HW // 4, HW // 4, 3) and got.std() > 0
    assert np.abs(got - want).max() <= 1


# the exported aligned tokens (f32 through the same tiny VLM, tap and
# projector): measured max |port - JAX| 3.6e-7 to 3.1e-6 at max |x| 2.4-2.9;
# limit 1e-5
EMBED_ATOL = 1e-5


def test_multi_image_cli_matches_jax(tmp_path, monkeypatch, both):
    """Two images and their words, the analyse-then-prompt instruction:
    ``cobsat_seed{seed}.png``, the same image."""
    run = {"image_paths": _images(tmp_path, 2),
           "text_inputs": ["red", "blue"]}
    jdir, pdir = _run_both(f"{PREFIX}_multi_image", _cfg(run), tmp_path,
                           monkeypatch)
    _same_png(jdir, pdir, "cobsat_seed7.png")


@pytest.mark.parametrize("ext,extra", [(".npy", "and a green hat"),
                                       (".pth", "")], ids=["npy-text", "pth"])
def test_replay_cli_matches_jax(tmp_path, monkeypatch, both, ext, extra):
    """An exported (S, D) array, .npy or torch .pth, then the T5 text
    embeds of ``extra_text_input`` after it: ``{name}_seed{seed}.png``,
    the same image."""
    arr = np.random.RandomState(1).randn(6, 32).astype(np.float32)
    path = str(tmp_path / f"case0{ext}")
    if ext == ".npy":
        np.save(path, arr)
    else:
        torch.save(torch.from_numpy(arr), path)
    run = {"embed_path": path, "extra_text_input": extra}
    jdir, pdir = _run_both(f"{PREFIX}_multi_image_input", _cfg(run), tmp_path,
                           monkeypatch)
    _same_png(jdir, pdir, "case0_seed7.png")


@pytest.mark.parametrize("max_tokens", [None, 3, 12], ids=["as-is", "cut",
                                                           "padded"])
def test_text_only_embed_cli_matches_jax(tmp_path, monkeypatch, both, max_tokens):
    """A text-only prompt (no image in the chat) through the aligner, the
    model section's embedding_type, padded or cut to ``max_tokens``:
    ``{name}_edit_4_flux_{type}_0.png``, the same image; a second run skips
    it."""
    run = {"prompts": ["two blue birds"], "image_names": ["birds"],
           "max_tokens": max_tokens}
    cfg = _cfg(run, embedding_type="both")
    jdir, pdir = _run_both(f"{PREFIX}_multi_image_input_embed", cfg, tmp_path,
                           monkeypatch)
    _same_png(jdir, pdir, "birds_edit_4_flux_both_0.png")
    from thinkdiff_torch.scripts import (
        test_mllama_t5_decoder_flux_multi_image_input_embed as cli)

    path = tmp_path / "again.yaml"
    import yaml

    path.write_text(yaml.safe_dump({**cfg, "run": {
        **cfg["run"], "output_dir": str(pdir)}}))
    assert cli.main(["--cfg-path", str(path), "--device", "cpu"]) == []


def test_embed_exporter_matches_jax_and_replays(tmp_path, monkeypatch, both):
    """The single-image exporter: ``{image}.npy`` (np.save, f32) within
    EMBED_ATOL of JAX's and the same ``.json`` (generated text, ids,
    prompt); then the export replayed through the port's replay CLI gives
    the image JAX's replay gives of JAX's export."""
    img = _images(tmp_path, 1)[0]
    run = {"image_path": img, "text_input": "describe it"}
    jdir, pdir = _run_both(f"{PREFIX}_embed", _cfg(run), tmp_path,
                           monkeypatch)
    got, want = np.load(pdir / "img0.npy"), np.load(jdir / "img0.npy")
    assert got.dtype == np.float32 and got.ndim == 2 and got.shape[1] == 32
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)
    assert (json.loads((pdir / "img0.json").read_text())
            == json.loads((jdir / "img0.json").read_text()))
    replay = {}
    for side, d in (("jax", jdir), ("port", pdir)):
        replay[side] = tmp_path / f"replay_{side}"
        replay[side].mkdir()
        (replay[side] / "img0.npy").write_bytes((d / "img0.npy").read_bytes())
    import importlib
    import sys

    import yaml

    for side in ("jax", "port"):
        cfg = _cfg({"embed_path": str(replay[side] / "img0.npy"),
                    "output_dir": str(replay[side])})
        path = tmp_path / f"replay_{side}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        module = f"{PREFIX}_multi_image_input"
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [module, "--cfg-path", str(path)])
            importlib.import_module(f"scripts.test.{module}").main()
        else:
            importlib.import_module(f"thinkdiff_torch.scripts.{module}").main(
                ["--cfg-path", str(path), "--device", "cpu"])
    _same_png(replay["jax"], replay["port"], "img0_seed7.png")


def _cases(tmp_path, n):
    """``n`` CoBSAT case JSONs of two images each, in their own folder."""
    folder = tmp_path / "cases"
    folder.mkdir()
    imgs = _images(tmp_path, 2 * n, seed=4)
    for i in range(n):
        (folder / f"case{i}.json").write_text(json.dumps({
            "text_inputs": [f"red{i}ab", f"blue{i}cd"],
            "image_inputs": [imgs[2 * i], imgs[2 * i + 1]]}))
    return folder


def test_cobsat_multi_image_exporter_matches_jax(tmp_path, monkeypatch, both):
    """Each case JSON -> ``{case}.pth`` (torch-loadable f32 tokens) within
    EMBED_ATOL of JAX's, and the same ``{case}.json`` (the case, generated
    text, the instruction)."""
    folder = _cases(tmp_path, 2)
    run = {"image_folder": str(folder), "prompt": "Look at these. "}
    jdir, pdir = _run_both(f"{PREFIX}_embed_multi_image", _cfg(run), tmp_path,
                           monkeypatch)
    for i in range(2):
        got = torch.load(pdir / f"case{i}.pth", weights_only=True)
        want = torch.load(jdir / f"case{i}.pth", weights_only=True)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=EMBED_ATOL, rtol=0)
        assert (json.loads((pdir / f"case{i}.json").read_text())
                == json.loads((jdir / f"case{i}.json").read_text()))


def test_cobsat_batch_exporter_matches_jax(tmp_path, monkeypatch, both):
    """Three cases in batches of two -> ``{case}.npy`` within EMBED_ATOL of
    JAX's and the same ``{case}.json``."""
    folder = _cases(tmp_path, 3)
    run = {"cobsat_json_dir": str(folder), "batch_size_eval": 2}
    jdir, pdir = _run_both(f"{PREFIX}_embed_multi_image_batch", _cfg(run),
                           tmp_path, monkeypatch)
    for i in range(3):
        got, want = np.load(pdir / f"case{i}.npy"), np.load(jdir / f"case{i}.npy")
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=EMBED_ATOL, rtol=0)
        assert (json.loads((pdir / f"case{i}.json").read_text())
                == json.loads((jdir / f"case{i}.json").read_text()))
