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


def _engines(params, quant, **kw):
    """(JAX engine, port engine) on the same tree: fp, or w8a8 LM with
    fused projections (the slice's LM setting); ``kw`` overrides
    ENGINE_KW on both."""
    over = {"quant_int8": "w8a8", "fused_proj": True} if quant else {}
    tree = dict(params)
    if quant:
        tree["lm"] = jax.tree.map(np.array, jm.fuse_qwen2_params(
            jq.quantize_tree(params["lm"], min_size=0, w8a8=True)))
    jeng = je.EmbedEngine(jm.Qwen2VLConfig.tiny(**over), tree, _tokenizer(),
                          **{**ENGINE_KW, **kw})
    teng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(**over), tree, _tokenizer(),
                          device="cpu", **{**ENGINE_KW, **kw})
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




# ---------------------------------------------------------------------------
# Schedulers: the dense refill branch and the paged branch of generate_many
# ---------------------------------------------------------------------------

SCHED_KW = dict(max_tokens=10, min_tokens=2)


@pytest.fixture(scope="module")
def sched_engines(params):
    """One (JAX, port) engine pair per LM mode, shared by the scheduler
    cases (each case sets its knobs on both and restores them), so the JAX
    side compiles each shape once."""
    return {q: _engines(params, q, **SCHED_KW) for q in (False, True)}


def _requests(n, images=False):
    """n prompts of varied length; with ``images`` every third request
    carries a small image (so image rows land inside prefill chunks)."""
    from PIL import Image

    prompts = [f"describe thing number {i} " + "pad " * (5 * (i % 4))
               for i in range(n)]
    if not images:
        return {"prompts": prompts}
    rs = np.random.RandomState(1)
    imgs = [[Image.fromarray((rs.rand(16, 24, 3) * 255).astype("uint8"))]
            if i % 3 == 0 else None for i in range(n)]
    return {"answers": prompts, "images": imgs}


def _stop_lengths(n, seed=0):
    """Seeded per-request lengths for the count-only stop hook."""
    return np.random.RandomState(seed).randint(2, SCHED_KW["max_tokens"] + 1,
                                               size=n).tolist()


# name -> (generate_many kwargs, engine attributes, request count, images)
SCHED_CASES = {
    "dense_refill": (dict(slots=2, chunk=4, paged=False), {}, 7, False),
    "paged": (dict(slots=3, chunk=4, paged=True), {}, 9, False),
    "paged_chunked_prefill": (dict(slots=3, chunk=4, paged=True),
                              dict(prefill_chunk=64), 9, True),
    "paged_preadmit_1": (dict(slots=2, chunk=4, paged=True),
                         dict(preadmit_wave=1), 9, False),
    "paged_preadmit_4": (dict(slots=3, chunk=4, paged=True),
                         dict(preadmit_wave=4, prefill_chunk=64), 11, True),
    "paged_eos_lag_1": (dict(slots=3, chunk=4, paged=True),
                        dict(eos_lag=1), 10, False),
    "paged_eos_lag_2": (dict(slots=3, chunk=4, paged=True),
                        dict(eos_lag=2, preadmit_wave=4, prefill_chunk=64),
                        10, True),
    "paged_refill_batch": (dict(slots=4, chunk=4, paged=True,
                                refill_batch=2), {}, 9, False),
    "paged_lazy_tokens": (dict(slots=3, chunk=4, paged=True),
                          dict(ignore_eos=True, lazy_tokens=True), 8, False),
    "paged_sync_tokens": (dict(slots=3, chunk=4, paged=True),
                          dict(ignore_eos=True, lazy_tokens=False), 8, False),
}


def _check_same(got, want):
    assert got.output_token_ids == want.output_token_ids
    assert got.prompt_token_ids == want.prompt_token_ids
    assert got.texts == want.texts
    assert got.input_prompts == want.input_prompts
    for i in range(len(want.output_token_ids)):
        _bf16_close(got.hidden_states[i], want.hidden_states[i])
        _bf16_close(got.prompt_hidden_states[i], want.prompt_hidden_states[i])


def _run_both(jeng, teng, samples, attrs, lengths, **kw):
    saved = [{k: getattr(e, k, None) for k in (*attrs, "stop_len_fn")}
             for e in (jeng, teng)]
    try:
        for e in (jeng, teng):
            for k, v in attrs.items():
                setattr(e, k, v)
            e.stop_len_fn = lambda req, m: m >= lengths[req]
        want = jeng.generate_many(samples, seed=3, **kw)
        got = teng.generate_many(samples, seed=3, **kw)
    finally:
        for e, old in zip((jeng, teng), saved):
            for k, v in old.items():
                setattr(e, k, v)
    return got, want


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "w8a8"])
@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_matches_jax(sched_engines, case, quant):
    """Greedy token streams, texts and prompts identical to the JAX engine's
    generate_many, hidden states within _bf16_close, for each scheduler and
    serving knob; seeded stop lengths make requests finish early so slots
    refill (and, with eos_lag, finish while chunks are in flight)."""
    kw, attrs, n, images = SCHED_CASES[case]
    jeng, teng = sched_engines[quant]
    attrs = dict(attrs)
    if kw.get("paged"):
        attrs["kv_page_size"] = 8
    got, want = _run_both(jeng, teng, _requests(n, images), attrs,
                          _stop_lengths(n), **kw)
    _check_same(got, want)
    assert set(teng.last_phase_stats) == set(jeng.last_phase_stats)
    assert teng.last_phase_stats["chunks"] == jeng.last_phase_stats["chunks"]
    assert any(len(t) < SCHED_KW["max_tokens"] for t in got.output_token_ids)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "w8a8"])
def test_preprepared_matches_jax(sched_engines, quant):
    """Streaming admission: prepare_requests, then generate_many(...,
    preprepared=...), on both engines."""
    jeng, teng = sched_engines[quant]
    samples = _requests(7, images=True)
    lengths = _stop_lengths(7, seed=1)
    for e in (jeng, teng):
        e.kv_page_size = 8
        e.stop_len_fn = lambda req, m: m >= lengths[req]
    try:
        want = jeng.generate_many(samples, seed=5, slots=3, chunk=4,
                                  paged=True,
                                  preprepared=jeng.prepare_requests(samples))
        got = teng.generate_many(samples, seed=5, slots=3, chunk=4,
                                 paged=True,
                                 preprepared=teng.prepare_requests(samples))
    finally:
        for e in (jeng, teng):
            e.stop_len_fn = None
    _check_same(got, want)
    assert teng.last_phase_stats["prepare_total"] < 0.05


def test_preprepared_must_match_the_samples(sched_engines):
    _, teng = sched_engines[False]
    prep = teng.prepare_requests(_requests(3))
    with pytest.raises(ValueError, match="preprepared"):
        teng.generate_many(_requests(4), slots=2, chunk=4, paged=True,
                           preprepared=prep)


def test_gumbel_sampler_at_temperature_0_matches_jax(params, monkeypatch):
    """sampler 'gumbel' at temperature 0 (the fused kernel's noise-free
    argmax) through the paged scheduler with chunked prefill, so both the
    first token and the decode steps go through the fused sampler; the JAX
    side runs its Pallas kernel in interpret mode."""
    from thinkdiff_tpu.ops import fused_sample as jfs

    monkeypatch.setattr(jfs, "available", lambda: True)
    monkeypatch.setattr(jfs, "INTERPRET", True)
    jeng, teng = _engines(params, True, sampler="gumbel", prefill_chunk=64,
                          **SCHED_KW)
    assert teng._fused_sampler_pack() is not None
    lengths = _stop_lengths(6, seed=2)
    got, want = _run_both(jeng, teng, _requests(6), {"kv_page_size": 8},
                          lengths, slots=3, chunk=4, paged=True)
    _check_same(got, want)


def test_gumbel_sampler_needs_a_w8a8_lm(params):
    _, teng = _engines(params, False, sampler="gumbel")
    assert teng._fused_sampler_pack() is None


def test_fused_pack_follows_the_eos_set(params):
    """The pack bakes the EOS columns in; it is rebuilt when eos_ids or
    ignore_eos change (the JAX engine keeps the first one)."""
    _, teng = _engines(params, True, sampler="gumbel")
    first = teng._fused_sampler_pack()
    assert teng._fused_sampler_pack() is first
    assert float(first["eos_bias"][242]) < -1e29
    teng.ignore_eos = True
    assert float(teng._fused_sampler_pack()["eos_bias"].min()) == 0.0


def _shipped_model_cfg():
    with open(Path(__file__).resolve().parents[1] / "configs"
              / "qwen2_vl_embed_ccsbu.yaml") as f:
        return yaml.safe_load(f)["model"]


def test_shipped_config_builds_as_written(params):
    """configs/qwen2_vl_embed_ccsbu.yaml's serving settings, unmodified,
    build the port's engine."""
    kw = te.engine_kwargs(_shipped_model_cfg())
    assert (kw["max_num_seqs"], kw["prefill_chunk"], kw["preadmit_wave"],
            kw["eos_lag"], kw["kv_page_size"]) == (256, 128, 64, 2, 64)
    assert (kw["temperature"], kw["top_p"], kw["max_tokens"]) == (0.6, 0.9, 256)
    eng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(), params, _tokenizer(),
                         device="cpu", **kw)
    assert eng.max_num_seqs == 256 and eng.prefill_chunk == 128
    assert eng.sampler == "exact" and eng.top_k_prefilter == 64


def test_forward_with_the_shipped_vllm_config_matches_jax(params):
    """MllamaVllmGenerateModel.forward with the shipped vllm_config as
    written except max_num_seqs 4 and prefill_chunk 64, greedy: eight
    requests over four slots go through generate_many's dense refill
    branch (slots <= 32; max_tokens 40 > the 32-step chunk) with chunked
    prefill on both engines."""
    cfg = _shipped_model_cfg()
    cfg["vllm_config"].update(max_num_seqs=4, prefill_chunk=64)
    kw = te.engine_kwargs(cfg)
    kw.update(temperature=0.0, max_tokens=40, min_pixels=8 * 8,
              max_pixels=64 * 64, eos_ids=[242, 241])
    kw.pop("prompt_format")
    jeng = je.EmbedEngine(jm.Qwen2VLConfig.tiny(), params, _tokenizer(), **kw)
    teng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(), params, _tokenizer(),
                          device="cpu", **kw)
    lengths = _stop_lengths(8, seed=3)
    for e in (jeng, teng):
        e.stop_len_fn = lambda req, m: m >= lengths[req]
    batch = _requests(8, images=True)
    batch = {"answers": batch["answers"], "images": batch["images"]}
    want = je.MllamaVllmGenerateModel(cfg, engine=jeng).forward(batch)
    got = te.MllamaVllmGenerateModel(cfg, engine=teng).forward(batch)
    for key in ("generated_texts", "input_prompts", "prompt_token_ids",
                "output_token_ids", "embedding_layer_name"):
        assert got[key] == want[key], key
    for a, b in zip(got["hidden_states"], want["hidden_states"]):
        _bf16_close(a, b)
    for a, b in zip(got["prompt_hidden_states"], want["prompt_hidden_states"]):
        _bf16_close(a, b)
