"""Port parity: thinkdiff_torch.engines.embed_engine against the JAX engine
on a tiny random Qwen2-VL (f32), with the same parameters, images, prompts
and stand-in tokenizer on both sides."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from thinkdiff_torch.engines import embed_engine as te
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_torch.models import qwen2_vl as tm
from thinkdiff_tpu.engines import embed_engine as je
from thinkdiff_tpu.models import qwen2_vl as jm
from thinkdiff_tpu.ops import quant as jq

# the special ids of Qwen2VLConfig.tiny() and the JAX engine tests
TINY_SPECIALS = {"<|im_start|>": 240, "<|im_end|>": 241,
                 "<|endoftext|>": 242, "<|vision_start|>": 249,
                 "<|vision_end|>": 248, "<|image_pad|>": 250}
ENGINE_KW = dict(max_tokens=6, min_tokens=1, temperature=0.0, top_p=1.0,
                 eos_ids=[242, 241], min_pixels=8 * 8, max_pixels=64 * 64)


def _tokenizer():
    return StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201)


@pytest.fixture(scope="module")
def params():
    cfg = jm.Qwen2VLConfig.tiny()
    rng = jax.random.PRNGKey(0)
    vp = jm.Qwen2VisionTower(cfg.vision).init(
        rng, jnp.zeros((4, cfg.vision.patch_dim)),
        jnp.zeros((4, cfg.vision.head_dim // 2)),
        jnp.zeros((4, cfg.vision.head_dim // 2)), None)["params"]
    lp = jm.Qwen2VLModel(cfg).init(
        rng, input_ids=jnp.zeros((1, 4), jnp.int32),
        position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
    return jax.tree.map(np.array, {"vision": vp, "lm": lp})


def _engines(params, quant):
    """(JAX engine, port engine) on the same tree: fp, or w8a8 LM with
    fused projections (the slice's LM setting)."""
    over = {"quant_int8": "w8a8", "fused_proj": True} if quant else {}
    tree = dict(params)
    if quant:
        tree["lm"] = jax.tree.map(np.array, jm.fuse_qwen2_params(
            jq.quantize_tree(params["lm"], min_size=0, w8a8=True)))
    jeng = je.EmbedEngine(jm.Qwen2VLConfig.tiny(**over), tree, _tokenizer(),
                          **ENGINE_KW)
    teng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(**over), tree, _tokenizer(),
                          **ENGINE_KW)
    return jeng, teng


def _batch():
    from PIL import Image

    rs = np.random.RandomState(0)
    imgs = [Image.fromarray((rs.rand(*hw, 3) * 255).astype("uint8"))
            for hw in [(16, 16), (24, 16), (16, 16)]]
    return {"images": imgs,
            "answers": ["describe it", "caption the picture", "what is here"]}


def _bf16_close(got: torch.Tensor, want: np.ndarray):
    """Both engines round an f32 hidden state to bf16: values within 1e-4
    before rounding land within 1e-4 plus one bf16 ulp after it."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-4 + np.ldexp(1.0, e - 8)).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "w8a8"])
def test_greedy_generate_matches_jax(params, quant):
    """Greedy token streams identical to the JAX engine: unquantized f32, and
    w8a8 at this seed (a w8a8 step whose top-2 logit margin fell to the
    ~1e-4 level at which the two engines differ could pick another token;
    none does here)."""
    jeng, teng = _engines(params, quant)
    want = jeng.generate(_batch(), seed=0)
    got = teng.generate(_batch(), seed=0)
    assert got.output_token_ids == want.output_token_ids
    assert got.prompt_token_ids == want.prompt_token_ids
    assert got.texts == want.texts
    assert got.input_prompts == want.input_prompts
    for i in range(3):
        _bf16_close(got.hidden_states[i], want.hidden_states[i])
        _bf16_close(got.prompt_hidden_states[i], want.prompt_hidden_states[i])
        assert got.hidden_states[i].dtype == torch.bfloat16


def test_generate_model_forward_matches_jax(params):
    jeng, teng = _engines(params, False)
    cfg = {"vllm_config": {"max_num_seqs": 4}}
    want = je.MllamaVllmGenerateModel(cfg, engine=jeng).forward(_batch())
    got = te.MllamaVllmGenerateModel(cfg, engine=teng).forward(_batch())
    assert list(got) == list(want)
    for key in ("generated_texts", "input_prompts", "prompt_token_ids",
                "output_token_ids", "embedding_layer_name"):
        assert got[key] == want[key], key
    for a, b in zip(got["hidden_states"], want["hidden_states"]):
        _bf16_close(a, b)


def test_eos_trim_and_min_tokens(params):
    _, teng = _engines(params, False)
    teng.ignore_eos, teng.min_tokens = True, 6
    res = teng.generate(_batch(), seed=0)
    assert all(len(t) == 6 for t in res.output_token_ids)
    assert all(h.shape == (6, 64) for h in res.hidden_states)


def test_patchify_normalize_matches_jax():
    rs = np.random.RandomState(1)
    pixels = rs.randint(0, 256, (2, 56, 84, 3)).astype(np.uint8)
    want = np.asarray(je.patchify_normalize(jnp.asarray(pixels), 14, 2, 2))
    got = te.patchify_normalize(torch.from_numpy(pixels), 14, 2, 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(300, 400), (10, 2000), (448, 448), (56, 56)])
def test_host_helpers_identical(hw):
    assert te.smart_resize(*hw) == je.smart_resize(*hw)
    for fmt in ("qwen2_vl", "internvl", "generic"):
        assert (te.render_chat_prompt("sys", "hi", 2, fmt)
                == je.render_chat_prompt("sys", "hi", 2, fmt))
    for mid in ("Qwen/Qwen2-VL-2B-Instruct", "OpenGVLab/InternVL2-8B", "x"):
        assert te.prompt_format_for_model(mid) == je.prompt_format_for_model(mid)


def test_top_p_masks_tail():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    g = torch.Generator().manual_seed(0)
    seen = {int(te.sample_logits(g, logits, 1.0, 0.6)[0]) for _ in range(200)}
    assert seen == {0, 1}                       # keep set of top_p 0.6
    assert int(te.sample_logits(None, logits, 0.0, 0.9)[0]) == 0  # greedy


def test_sampling_distribution_matches_nucleus_law():
    """temperature 0.6 / top_p 0.9 (the precompute config): seeded draws
    stay in the vLLM/HF keep set and their total-variation distance to the
    exact renormalized law is inside the sampling-noise envelope."""
    temperature, top_p, v, n, rows = 0.6, 0.9, 4096, 100_000, 500
    rs = np.random.RandomState(7)
    base = -2.0 * np.log(np.arange(1, v + 1, dtype=np.float64))
    logits = (base + rs.normal(0, 1.0, v)).astype(np.float32)
    lp = logits.astype(np.float64) / temperature
    p = np.exp(lp - lp.max())
    p /= p.sum()
    order = np.argsort(-p)
    keep = order[(np.cumsum(p[order]) - p[order]) < top_p]
    p_keep = np.zeros(v)
    p_keep[keep] = p[keep]
    p_keep /= p_keep.sum()
    g = torch.Generator().manual_seed(11)
    batch = torch.from_numpy(np.repeat(logits[None], rows, 0))
    draws = torch.cat([te.sample_logits(g, batch, temperature, top_p)
                       for _ in range(n // rows)]).numpy()
    assert set(draws.tolist()) <= set(keep.tolist())
    tv = 0.5 * np.abs(np.bincount(draws, minlength=v) / n - p_keep).sum()
    assert tv < 4.0 * np.sqrt(max(len(keep), 2) / (2 * np.pi * n)), tv


UNSUPPORTED = {
    "max_num_seqs_64": {"max_num_seqs": 64},
    "prefill_chunk": {"prefill_chunk": 128},
    "preadmit_wave": {"preadmit_wave": 64},
    "eos_lag": {"eos_lag": 2},
    "gumbel_sampler": {"sampler": "gumbel"},
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_settings_raise(params, name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.EmbedEngine(tm.Qwen2VLConfig.tiny(), params, _tokenizer(),
                       **UNSUPPORTED[name])


@pytest.mark.parametrize("kw", [{"paged": True}, {"slots": 64},
                                {"slots": 2}], ids=["paged", "64_slots",
                                                    "dense_refill"])
def test_generate_many_outside_the_slice_raises(params, kw):
    _, teng = _engines(params, False)
    teng.max_tokens = 64  # > chunk, so a refill scheduler would be needed
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.generate_many({"prompts": ["a", "b", "c"]}, **kw)


def test_shipped_config_needs_the_slice_overrides(params):
    with open(Path(__file__).resolve().parents[1] / "configs"
              / "qwen2_vl_embed_ccsbu.yaml") as f:
        model_cfg = yaml.safe_load(f)["model"]
    with pytest.raises(NotImplementedError):
        te.EmbedEngine(tm.Qwen2VLConfig.tiny(), params, _tokenizer(),
                       **te.engine_kwargs(model_cfg))
    model_cfg["vllm_config"].update(
        max_num_seqs=8, enable_chunked_prefill=False, prefill_chunk=0,
        preadmit_wave=0, eos_lag=0)
    kw = te.engine_kwargs(model_cfg)
    assert (kw["temperature"], kw["top_p"], kw["max_tokens"]) == (0.6, 0.9, 256)
    eng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(), params, _tokenizer(), **kw)
    assert eng.max_num_seqs == 8 and eng.top_k_prefilter == 64
