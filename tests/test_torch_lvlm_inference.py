"""Port parity: ThinkDiff-LVLM text inference (MllamaT5EmbedDecoder.generate
and MllamaT5EmbedDecoderWithEngine) against the JAX package at tiny size on
the CPU: a 2-layer T5 (f32, and weight-only int8) with the JAX weights
bridged in, and a tiny random Qwen2-VL engine on each side with the same
parameters, images, prompts and stand-in tokenizer (temperature 0)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.core import trace
from thinkdiff_torch.engines import embed_engine as te
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_torch.models import aligner_lvlm as ta
from thinkdiff_torch.models import qwen2_vl as tm
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.ops import int8_matmul as ti
from thinkdiff_tpu.core.config import ConfigNode
from thinkdiff_tpu.engines import embed_engine as je
from thinkdiff_tpu.models import aligner_lvlm as ja
from thinkdiff_tpu.models import qwen2_vl as jm

# the special ids of Qwen2VLConfig.tiny() (tests/test_torch_embed_engine.py)
TINY_SPECIALS = {"<|im_start|>": 240, "<|im_end|>": 241,
                 "<|endoftext|>": 242, "<|vision_start|>": 249,
                 "<|vision_end|>": 248, "<|image_pad|>": 250}
ENGINE_KW = dict(max_tokens=6, min_tokens=1, temperature=0.0, top_p=1.0,
                 eos_ids=[242, 241], min_pixels=8 * 8, max_pixels=64 * 64)
T5_STEPS = 3


def _cfg(quant, **over):
    return {"dtype": "float32", "load_pretrained": False,
            "quantize_frozen": quant, "vlm_hidden_size": 64,
            "mm_projector_type": "mlp2x_gelu_t5_norm",
            "t5_config": dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                              num_layers=1, num_decoder_layers=2,
                              num_heads=4), **over}


def _models(quant, engines=(None, None), **over):
    """(JAX model, port model) on the same weights; ``engines`` attached
    (JAX engine, port engine)."""
    jmod = ja.MllamaT5EmbedDecoderWithEngine(ConfigNode(_cfg(quant, **over)),
                                             seed=0)
    jmod._engine = engines[0]
    tmod = ta.MllamaT5EmbedDecoderWithEngine(_cfg(quant, **over), seed=1,
                                             device="cpu", engine=engines[1])
    load_params(tmod.frozen["t5"], jax.tree.map(np.asarray, jmod.frozen["t5"]))
    tmod.load_trainable(jax.tree.map(np.asarray, jmod.trainable_params()))
    return jmod, tmod


def _tokenizer():
    return StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201)


@pytest.fixture(scope="module")
def engines():
    cfg = jm.Qwen2VLConfig.tiny()
    rng = jax.random.PRNGKey(0)
    vp = jm.Qwen2VisionTower(cfg.vision).init(
        rng, jnp.zeros((4, cfg.vision.patch_dim)),
        jnp.zeros((4, cfg.vision.head_dim // 2)),
        jnp.zeros((4, cfg.vision.head_dim // 2)), None)["params"]
    lp = jm.Qwen2VLModel(cfg).init(
        rng, input_ids=jnp.zeros((1, 4), jnp.int32),
        position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
    tree = jax.tree.map(np.array, {"vision": vp, "lm": lp})
    return (je.EmbedEngine(cfg, tree, _tokenizer(), **ENGINE_KW),
            te.EmbedEngine(tm.Qwen2VLConfig.tiny(), tree, _tokenizer(),
                           device="cpu", **ENGINE_KW))


def _samples():
    from PIL import Image

    rs = np.random.RandomState(0)
    imgs = [Image.fromarray((rs.rand(*hw, 3) * 255).astype("uint8"))
            for hw in [(16, 16), (24, 16)]]
    return {"images": imgs, "answers": ["describe it", "caption the picture"]}


def _vllm_inputs():
    """Pre-formatted vLLM-style inputs: one with an image, two text-only
    (a dict without an image, a bare string)."""
    from PIL import Image

    img = Image.fromarray((np.random.RandomState(1).rand(16, 16, 3) * 255)
                          .astype("uint8"))
    return [{"prompt": "<|im_start|>user\n<|vision_start|><|image_pad|>"
                       "<|vision_end|>what is here<|im_end|>\n",
             "multi_modal_data": {"image": img}},
            {"prompt": "<|im_start|>user\nsay something<|im_end|>\n"},
            "<|im_start|>user\ntell a story<|im_end|>\n"]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_t5_greedy_generate_matches_jax(quant):
    """MllamaT5EmbedDecoder.generate: greedy token ids identical to the JAX
    package's, with an embed mask, unquantized and weight-only int8 (every
    decode step's QDense at <= 32 rows: the GEMV's plain version here)."""
    jmod, tmod = _models(quant)
    rs = np.random.RandomState(2)
    embeds = rs.randn(2, 7, 64).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    want = np.asarray(ja.MllamaT5EmbedDecoder.generate(
        jmod, embeds, jnp.asarray(mask), max_new_tokens=4))
    got = ta.MllamaT5EmbedDecoder.generate(tmod, embeds, torch.from_numpy(mask),
                                           max_new_tokens=4)
    assert got.shape == (2, 4) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("embedding_type,quant", [
    ("both", "int8"), ("input_embed", None), ("output_embed", None)])
def test_with_engine_generate_matches_jax(engines, embedding_type, quant):
    """VLM streams and texts identical, T5 ids identical (EOS-trimmed, the
    full per-sample list), each side with its own engine."""
    jmod, tmod = _models(quant, engines)
    want = jmod.generate(_samples(), embedding_type=embedding_type,
                         max_new_tokens=6, t5_max_new_tokens=T5_STEPS)
    trace.clear()
    trace.enable()
    try:
        got = tmod.generate(_samples(), embedding_type=embedding_type,
                            max_new_tokens=6, t5_max_new_tokens=T5_STEPS)
    finally:
        trace.disable()
    spans = trace.spans()
    trace.clear()
    assert got[2] == want[2]                     # VLM texts
    assert got[0] == want[0] and len(got[0]) == 2
    assert got[1] == want[1] == ["", ""]         # no local T5 tokenizer
    # the phases as spans: the VLM once, the projector and T5 a sample
    assert [s.name for s in spans] == ["lvlm.vlm"] + [
        "lvlm.projector", "lvlm.t5_decode"] * 2
    assert sum(s.attrs.get("steps", 0) for s in spans) == 2 * T5_STEPS
    assert spans[0].end_ns > spans[0].start_ns


def test_with_engine_generate_trims_at_eos(engines):
    """T5 ids are cut after the first ``t5_eos_token_id``: pick an id the
    untrimmed decode produces at step 3 and check both packages cut there."""
    _, tmod = _models(None, engines)
    ids, _, _ = tmod.generate(_samples(), max_new_tokens=6,
                              t5_max_new_tokens=T5_STEPS)
    eos = ids[0][2]
    jmod, tmod = _models(None, engines, t5_eos_token_id=eos)
    want = jmod.generate(_samples(), max_new_tokens=6,
                         t5_max_new_tokens=T5_STEPS)[0]
    got = tmod.generate(_samples(), max_new_tokens=6,
                        t5_max_new_tokens=T5_STEPS)[0]
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3
    assert all(i.count(eos) <= 1 for i in got)


@pytest.mark.parametrize("need_process", [True, False])
def test_get_text_matches_jax(engines, need_process):
    jmod, tmod = _models(None, engines)
    inputs = _samples() if need_process else _vllm_inputs()
    assert tmod.get_text(inputs, need_process=need_process,
                         max_new_tokens=6) == jmod.get_text(
        inputs, need_process=need_process, max_new_tokens=6)
    if not need_process:
        samples = tmod._vllm_inputs_to_samples(inputs)
        assert samples["images"][1:] == [None, None]
        assert samples == ja.MllamaT5EmbedDecoderWithEngine \
            ._vllm_inputs_to_samples(inputs)


@pytest.mark.parametrize("embedding_type", ["both", "input_embed",
                                            "input_no_system", "output_embed"])
def test_get_embed_matches_jax(engines, embedding_type):
    """The projected conditioning of every sample within 1e-5 (f32) of the
    JAX package's, both models reading one VLM result (the JAX engine's;
    the port's engine gives the same streams, and hidden states within a
    bf16 rounding, test_with_engine_generate_matches_jax)."""
    jmod, tmod = _models(None, (engines[0], engines[0]))
    want, wres = jmod.get_embed(_samples(), embedding_type=embedding_type,
                                max_new_tokens=6)
    got, gres = tmod.get_embed(_samples(), embedding_type=embedding_type,
                               max_new_tokens=6)
    assert gres.output_token_ids == wres.output_token_ids
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if embedding_type == "input_no_system":
        n = engines[1].num_system_tokens
        assert n == engines[0].num_system_tokens and n > 0
        assert got[0].shape[0] == gres.prompt_hidden_states[0].shape[0] - n


def test_own_engine_streams_match_jax(engines):
    """The port's engine under the model gives the JAX engine's token
    streams: get_embed's VLM result, port engine vs JAX engine."""
    _, tmod = _models(None, (None, engines[1]))
    _, gres = tmod.get_embed(_samples(), max_new_tokens=6)
    wres = engines[0].generate(_samples(), max_new_tokens=6)
    assert gres.output_token_ids == wres.output_token_ids
    assert gres.texts == wres.texts


def test_reference_checkpoint_round_trip():
    """convert/export of the reference's projector state dict identical to
    the JAX package's, from numpy or torch leaves."""
    rs = np.random.RandomState(3)
    sd = {"mm_projector.0.weight": rs.randn(32, 64).astype(np.float32),
          "mm_projector.0.bias": rs.randn(32).astype(np.float32),
          "mm_projector.2.weight": rs.randn(32, 32).astype(np.float32),
          "mm_projector.2.bias": rs.randn(32).astype(np.float32),
          "mm_projector.3.weight": rs.randn(32).astype(np.float32),
          "t5.shared.weight": rs.randn(4, 4).astype(np.float32)}
    jmod, tmod = _models(None)
    want = jmod.convert_reference_checkpoint(sd)
    for src in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = tmod.convert_reference_checkpoint(src)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    tmod.load_trainable(got)
    exported = tmod.export_reference_checkpoint(tmod.trainable)
    want_sd = jmod.export_reference_checkpoint(want)
    assert sorted(exported) == sorted(want_sd) == sorted(
        k for k in sd if k.startswith("mm_projector"))
    for k in exported:
        np.testing.assert_array_equal(exported[k], want_sd[k])
        np.testing.assert_array_equal(exported[k], sd[k])


def test_weight_only_tower_loads_kernel_q_and_scale():
    """The weight-only frozen tower holds kernel_q + kernel_scale per layer,
    no input_scale, and round-trips the JAX tree through the bridge."""
    from thinkdiff_torch.models.bridge import params_of

    jmod, tmod = _models("int8")
    names = dict(tmod.frozen["t5"].named_buffers())
    assert "decoder.block_0.self_attn.q.kernel_q" in names
    assert not any(n.endswith("input_scale") for n in names)
    flat = jax.tree_util.tree_leaves_with_path(params_of(tmod.frozen["t5"]))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jmod.frozen["t5"])))
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path])


@pytest.mark.parametrize("fused,embed_len", [(False, 40), (True, 12)])
def test_lvlm_text_launches_match_the_wrapper_calls(fused, embed_len):
    """``lvlm_text_launches`` against the int8_matmul calls a weight-only
    greedy decode makes: every layer at every step, plus the cross k/v
    projections when the conditioning has <= 32 rows."""
    over = {"t5_config": {**_cfg("int8")["t5_config"], "fused_proj": fused}}
    tmod = ta.MllamaT5EmbedDecoder(_cfg("int8", **over), device="cpu")
    calls = []
    real = ti.int8_matmul

    def count(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    embeds = np.random.RandomState(4).randn(1, embed_len, 64).astype(
        np.float32)
    with mock.patch("thinkdiff_torch.models.qdense.int8_matmul", count):
        tmod.generate(embeds, max_new_tokens=5)
    assert len(calls) == ta.lvlm_text_launches(tmod.t5_cfg, [embed_len], 5)
    assert max(s[-2] for s in calls) <= 32


@pytest.mark.parametrize("chunk,samples", [(None, "one"), (64, "one"),
                                           (64, "two")])
def test_get_embed_launches_match_the_wrapper_calls(chunk, samples):
    """``get_embed_launches`` against the flash forward, RMSNorm and w8a8
    GEMM calls that get_embed makes on a tiny engine laid out as the LVLM
    YAML's (w8a8 LM with fused projections, bf16 vision, exact sampler),
    counted at their call sites: the vision blocks, the prefill (one flash
    pass, or chunks of 64 over a 64x64 image's 64 tokens + the text), the
    decode steps, the lm_head and the projector's t5_norm; "two" holds two
    images of two grids (two vision passes)."""
    from PIL import Image

    from thinkdiff_torch.models.qwen2_vl import (
        fuse_qwen2_params, init_params)
    from thinkdiff_torch.ops.quant import quantize_tree

    cfg = tm.Qwen2VLConfig.tiny(quant_int8="w8a8", fused_proj=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["lm"] = fuse_qwen2_params(quantize_tree(params["lm"], min_size=0,
                                                   w8a8=True))
    engine = te.EmbedEngine(cfg, params, _tokenizer(), device="cpu",
                            prefill_chunk=chunk, **ENGINE_KW)
    tmod = ta.MllamaT5EmbedDecoderWithEngine(_cfg(None), seed=1, device="cpu",
                                             engine=engine)
    if samples == "one":
        img = Image.fromarray((np.random.RandomState(2).rand(64, 64, 3) * 255)
                              .astype("uint8"))
        batch, vision_calls = {"images": [img], "answers": ["describe it"]}, 1
    else:
        batch, vision_calls = _samples(), 2
    calls = {"flash_attention_fwd": 0, "rmsnorm": 0, "s8_matmul": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    from thinkdiff_torch.models import projector, qdense

    with mock.patch.object(tm, "flash_attention", counted(
            "flash_attention_fwd", tm.flash_attention)), \
            mock.patch.object(tm, "rmsnorm", counted("rmsnorm", tm.rmsnorm)), \
            mock.patch.object(projector, "rmsnorm", counted(
                "rmsnorm", projector.rmsnorm)), \
            mock.patch.object(qdense, "int8_dynamic_matmul", counted(
                "s8_matmul", qdense.int8_dynamic_matmul)):
        conds, res = tmod.get_embed(batch, max_new_tokens=5)
    lens = [len(p) for p in res.prompt_token_ids]
    assert len(conds) == len(lens) and all(len(o) == 5
                                           for o in res.output_token_ids)
    if chunk:
        assert -(-max(lens) // chunk) == (2 if samples == "one" else 1)
    assert calls == ta.get_embed_launches(tmod, lens, 5, vision_calls)


def test_with_engine_builds_on_the_card_by_default(monkeypatch):
    import thinkdiff_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ta.MllamaT5EmbedDecoderWithEngine(_cfg(None))
    assert (thinkdiff_torch.registry.get_model_class(
        "mllama-vllm-t5-embed-decoder-5") is ta.MllamaT5EmbedDecoderWithEngine)


def test_qwen2_vl_7b_has_the_7b_vocabulary():
    """Qwen2-VL-7B-Instruct's config.json has vocab 152064 (the untied
    lm_head's N); the 2B has 151936. The JAX factory gives the 7B the 2B's
    vocabulary, so a real 7B checkpoint would not load into it."""
    assert tm.Qwen2VLConfig.qwen2_vl_7b().vocab_size == 152064
    assert tm.Qwen2VLConfig.qwen2_vl_2b().vocab_size == 151936
    assert jm.Qwen2VLConfig.qwen2_vl_7b().vocab_size == 151936


def test_t5_tokenizer_is_none_without_local_files(tmp_path, monkeypatch):
    """No local flan-t5 files: None, without importing transformers."""
    import sys
    import types

    touched = []

    class Spy(types.ModuleType):
        def __getattr__(self, name):
            touched.append(name)
            raise AttributeError(name)

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setitem(sys.modules, "transformers", Spy("transformers"))
    tmod = ta.MllamaT5EmbedDecoder(
        _cfg(None, text_pretrained_model_name_or_path="google/flan-t5-xxl"),
        device="cpu")
    assert tmod.get_t5_tokenizer() is None
    assert touched == []
