"""Port parity: the CoBSAT CLIP scorer (``thinkdiff_torch/models/
clip_scorer.py``) and its CLI (``thinkdiff_torch/scripts/score_cobsat.py``)
against the JAX package's scorer and ``scripts/score_cobsat.py`` on the CPU:
tiny seeded CLIP-style towers (pre-norm, quick_gelu) on the same bridged
weights, the preprocessing, the embeddings (f32: within 2e-5 of JAX's
unit vectors, summation order only), the similarities and the scoring
protocol with a fake tokenizer, and both CLIs' JSON."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import scripts.score_cobsat as jscript
from thinkdiff_torch.models import clip_scorer as tcs
from thinkdiff_torch.models.clip_text import CLIPTextConfig as TTextCfg
from thinkdiff_torch.models.vit import ViTConfig as TViTCfg
from thinkdiff_torch.scripts import score_cobsat as tscript
from thinkdiff_tpu.models import clip_scorer as jcs
from thinkdiff_tpu.models.clip_text import CLIPTextConfig as JTextCfg
from thinkdiff_tpu.models.clip_text import CLIPTextEncoder
from thinkdiff_tpu.models.vit import ViTConfig as JViTCfg
from thinkdiff_tpu.models.vit import VisionTransformer
from tests.test_torch_flux import randomize

EMB_ATOL = 2e-5
CLIP_KW = dict(use_pre_norm=True, hidden_act="quick_gelu", layer_norm_eps=1e-5)


class FakeClipTokenizer:
    """BOS, a word id per word (stable across processes), EOS."""

    def encode(self, text):
        return [1] + [2 + sum(map(ord, w)) % 90 for w in text.split()] + [99]


@pytest.fixture(scope="module")
def scorers():
    vit_j, text_j = JViTCfg.tiny(**CLIP_KW), JTextCfg.tiny()
    rng = jax.random.PRNGKey(0)
    rs = np.random.RandomState(0)
    params = {
        "vision": randomize(jax.tree.map(np.asarray, VisionTransformer(
            vit_j).init(rng, jnp.zeros((1, 28, 28, 3)))["params"]), rs),
        "text": randomize(jax.tree.map(np.asarray, CLIPTextEncoder(
            text_j).init(rng, jnp.zeros((1, 4), jnp.int32))["params"]), rs),
        "visual_projection": rs.randn(32, 8).astype(np.float32),
        "text_projection": rs.randn(32, 8).astype(np.float32),
    }
    port = tcs.CLIPScorer(TViTCfg.tiny(**CLIP_KW), TTextCfg.tiny(), params,
                          tokenizer=FakeClipTokenizer(), device="cpu")
    ref = jcs.CLIPScorer(vit_j, text_j, params, tokenizer=FakeClipTokenizer())
    return port, ref


def _img(seed, size=40):
    rs = np.random.RandomState(seed)
    return Image.fromarray((rs.rand(size, size + 9, 3) * 255).astype("uint8"))


def test_preprocess_identical_to_jax():
    for seed, size in ((0, 50), (1, 28), (2, 17)):
        got = tcs.preprocess_clip_image(_img(seed, size), image_size=28)
        want = jcs.preprocess_clip_image(_img(seed, size), image_size=28)
        assert got.shape == (28, 28, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcs.CLIP_MEAN, jcs.CLIP_MEAN)
    np.testing.assert_array_equal(tcs.CLIP_STD, jcs.CLIP_STD)


def test_embeddings_and_similarities_match_jax(scorers):
    port, ref = scorers
    images = [_img(1), _img(2), tcs.preprocess_clip_image(_img(3), 28)]
    got, want = port.encode_images(images), ref.encode_images(images)
    assert got.shape == (3, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    # unequal lengths padded with EOS; a text over max_positions is cut
    texts = ["a photo of a car", "bird", " ".join(["word"] * 30)]
    np.testing.assert_allclose(port.encode_texts(texts),
                               ref.encode_texts(texts), rtol=0, atol=EMB_ATOL)
    assert port.token_batch(texts).shape == (3, 16)
    sims = port.classify(images[:2], texts)
    np.testing.assert_allclose(sims, ref.classify(images[:2], texts),
                               rtol=0, atol=2 * EMB_ATOL)
    assert (np.argmax(sims, 1) == np.argmax(ref.classify(images[:2], texts),
                                             1)).all()


def test_encode_texts_needs_a_tokenizer(scorers):
    port, _ = scorers
    bare = tcs.CLIPScorer(TViTCfg.tiny(**CLIP_KW), TTextCfg.tiny(),
                          device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        bare.encode_texts(["x"])
    # CLIP-L's joint width by default, the loaded tree's otherwise
    assert bare.visual_projection.shape == (32, 768)
    assert port.visual_projection.shape == (32, 8)


def test_from_pretrained_reads_local_files_only(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="CLIP weights"):
        tcs.CLIPScorer.from_pretrained("openai/clip-vit-large-patch14",
                                       device="cpu")


class RiggedScorer:
    """classify() peaks at a chosen candidate per call."""

    def __init__(self, answers):
        self.answers, self.calls = answers, 0

    def classify(self, images, texts):
        lat, exp = self.answers[self.calls]
        self.calls += 1
        return np.array([[1.0 if t in (f"a photo of {lat}",
                                       f"a photo of {exp}") else 0.0
                          for t in texts]])


LABELS = {
    "case0": {"latent": "car", "explicit": "red", "task": "color-I",
              "latent_candidates": ["car", "dog"],
              "explicit_candidates": ["red", "blue"]},
    "case1": {"latent": "dog", "explicit": "blue", "task": "color-I",
              "latent_candidates": ["car", "dog"],
              "explicit_candidates": ["red", "blue"]},
    "case2": {"latent": "hat", "explicit": "wool", "task": "texture-I",
              "latent_candidates": ["hat", "cup"],
              "explicit_candidates": ["wool", "metal"]},
    "case_missing": {"latent": "x", "explicit": "y", "task": "t",
                     "latent_candidates": ["x"],
                     "explicit_candidates": ["y"]},
}


def test_score_cases_protocol_as_jax(tmp_path):
    _img(3).save(tmp_path / "case0.png")
    _img(4).save(tmp_path / "case1_seed42.png")
    _img(5).save(tmp_path / "case2_extra.png")
    answers = [("car", "red"), ("car", "blue"), ("hat", "metal")]
    got = tscript.score_cases(RiggedScorer(answers), str(tmp_path), LABELS)
    want = jscript.score_cases(RiggedScorer(answers), str(tmp_path), LABELS)
    assert got == want
    assert got["n"] == 3 and got["missing"] == ["case_missing"]
    assert got["overall"] == pytest.approx(1 / 3)
    assert got["per_task"] == {"color-I": 0.5, "texture-I": 0.0}
    for case in ("case0", "case1", "case2", "none"):
        assert tscript.find_case_image(str(tmp_path), case) == \
            jscript.find_case_image(str(tmp_path), case)
    assert tscript.score_cases(RiggedScorer([]), str(tmp_path), {}) == \
        jscript.score_cases(RiggedScorer([]), str(tmp_path), {})


def test_cli_json_identical_to_jax_script(scorers, tmp_path, monkeypatch):
    """Both CLIs over the same PNGs and labels, each with its tiny scorer
    patched in where the weights would be read: the same JSON."""
    port, ref = scorers
    for i, case in enumerate(("case0", "case1", "case2")):
        _img(10 + i).save(tmp_path / f"{case}.png")
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps(LABELS))
    monkeypatch.setattr(tcs.CLIPScorer, "from_pretrained",
                        classmethod(lambda cls, path, device: port))
    monkeypatch.setattr(jcs.CLIPScorer, "from_pretrained",
                        classmethod(lambda cls, path: ref))
    args = ["--images-dir", str(tmp_path), "--labels-json", str(labels)]
    tscript.main(args + ["--out-json", str(tmp_path / "port.json"),
                         "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["score_cobsat"] + args + [
        "--out-json", str(tmp_path / "jax.json")])
    jscript.main()
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text())
    assert got["n"] == 3 and got["missing"] == ["case_missing"]
