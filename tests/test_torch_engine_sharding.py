"""The port's serving engines on a mesh (``mesh=`` of EmbedEngine,
FluxSampler and CogVideoXSampler) against the unsharded port and JAX's
engines on the same mesh shape (tests/test_engine_sharding.py's tiny
configs; JAX on the 8-device virtual CPU platform of tests/conftest.py).
The port's ranks are gloo subprocesses of tests/_torch_dist_child.py,
started before the references are computed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_distributed import start
from tests.test_torch_embed_engine import TINY_SPECIALS
from thinkdiff_torch.engines import embed_engine as te
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_torch.models import qwen2_vl as tq
from thinkdiff_tpu.engines import embed_engine as je
from thinkdiff_tpu.models import qwen2_vl as jq
from thinkdiff_tpu.ops import quant as jquant
from thinkdiff_tpu.parallel import mesh as jmesh

QWEN = dict(hidden_size=128, intermediate_size=256, num_heads=4,
            num_kv_heads=2, mrope_section=(4, 6, 6), vocab_size=512)
VISION = dict(depth=2, embed_dim=32, hidden_size=128, num_heads=4,
              patch_size=4, spatial_merge_size=2, temporal_patch_size=2)
GREEDY = dict(max_tokens=6, min_tokens=2, temperature=0.0, top_p=1.0,
              eos_ids=[242, 241], min_pixels=8 * 8, max_pixels=64 * 64)
SAMPLED = dict(GREEDY, temperature=0.6, top_p=0.9)
MANY = dict(slots=2, chunk=4, paged=True)
N_REQ = 8
# f32 hidden states: the row-parallel products' partials are summed in
# another order (relative 1e-7 a term), then both engines round to bf16,
# which can move a value by one bf16 ulp
HIDDEN_REL = 1e-5
# w8a8 requests with images: the float vision tower's row-parallel
# partials are summed in another order, and an LM activation that lands on
# a rounding edge of its row's int8 quantization then takes the
# neighbouring level: one step is 1/127 of the row's absmax. Two layers of
# two quantized row groups each can take a step: four steps of the
# largest value bound the drift (measured: 0.6 and 2.1 steps)
W8A8_IMAGE_REL = 4 / 127


def _tokenizer():
    return StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201)


def _jax_mesh(shape):
    return jmesh.make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


@pytest.fixture(scope="module")
def trees():
    """The tiny config's JAX-initialized trees, untied and tied, float and
    w8a8 (quantized, then fused)."""
    out = {}
    for tied in (False, True):
        cfg = jq.Qwen2VLConfig.tiny(
            **QWEN, tie_word_embeddings=tied,
            vision=jq.Qwen2VLVisionConfig(**VISION))
        rng = jax.random.PRNGKey(0)
        vp = jq.Qwen2VisionTower(cfg.vision).init(
            rng, jnp.zeros((4, cfg.vision.patch_dim)),
            jnp.zeros((4, cfg.vision.head_dim // 2)),
            jnp.zeros((4, cfg.vision.head_dim // 2)), None)["params"]
        lp = jq.Qwen2VLModel(cfg).init(
            rng, input_ids=jnp.zeros((1, 4), jnp.int32),
            position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
        f32 = jax.tree.map(np.array, {"vision": vp, "lm": lp})
        w8 = {"vision": f32["vision"], "lm": jax.tree.map(
            np.array, jq.fuse_qwen2_params(jquant.quantize_tree(
                f32["lm"], min_size=0, w8a8=True)))}
        tag = "_tied" if tied else ""
        out["f32" + tag], out["w8a8" + tag] = f32, w8
    return out


def _requests():
    rs = np.random.RandomState(1)
    sizes = [(16, 16), (24, 16), (16, 24), (16, 16)] * 2
    images = [(rs.rand(h, w, 3) * 255).astype(np.uint8) for h, w in sizes]
    prompts = [f"describe picture {i}" + " in detail" * (i % 3)
               for i in range(N_REQ)]
    return images, prompts


def _cfg_kw(variant):
    quant = "w8a8" in variant
    return dict(QWEN, tie_word_embeddings="tied" in variant,
                quant_int8="w8a8" if quant else False, fused_proj=quant,
                vision=dict(VISION))


def _cases(trees):
    """name -> (variant, engine keywords, call, call keywords, images?)."""
    cases = {}
    for variant in trees:
        cases[f"{variant}/generate"] = (variant, GREEDY, "generate", {}, True)
        cases[f"{variant}/chunked"] = (
            variant, dict(GREEDY, prefill_chunk=64), "generate", {}, True)
        cases[f"{variant}/paged"] = (
            variant, dict(GREEDY, prefill_chunk=64, eos_lag=1,
                          preadmit_wave=2), "generate_many", MANY, True)
    cases["f32/exact"] = ("f32", SAMPLED, "generate_many", MANY, True)
    for variant in ("w8a8", "w8a8_tied"):
        cases[f"{variant}/exact"] = (variant, SAMPLED, "generate_many", MANY,
                                     True)
        cases[f"{variant}/gumbel"] = (
            variant, dict(SAMPLED, sampler="gumbel"), "generate_many", MANY,
            True)
        cases[f"{variant}/text"] = (variant, GREEDY, "generate_many", MANY,
                                    False)
    return cases


def _port_unsharded(trees, case, images, prompts, seed=0):
    from PIL import Image

    variant, kw, call, call_kw, with_images = case
    cfg_kw = _cfg_kw(variant)
    cfg = tq.Qwen2VLConfig.tiny(**{
        **cfg_kw, "vision": tq.Qwen2VLVisionConfig(**cfg_kw["vision"])})
    eng = te.EmbedEngine(cfg, trees[variant], _tokenizer(), device="cpu",
                         **kw)
    samples = {"answers": prompts}
    if with_images:
        samples["images"] = [Image.fromarray(a) for a in images]
    return getattr(eng, call)(samples, seed=seed, **call_kw)


def _bf16_ulp(x):
    _, e = np.frexp(np.maximum(np.abs(x), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _hidden_close(got, want, exact, rel=HIDDEN_REL):
    for g, w in zip(got, want):
        w = w.float().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape
        if exact:
            assert np.array_equal(g, w)
        else:
            lim = rel * np.abs(w).max() + _bf16_ulp(w)
            assert (np.abs(g - w) <= lim).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 1, 2)], ids=str)
def test_embed_engine_on_mesh(tmp_path, trees, shape):
    """EmbedEngine(mesh=...) on JAX's tiny config (float and w8a8, tied and
    untied): greedy ids of ``generate`` (one-shot and chunked prefill) and
    of paged ``generate_many`` (refill, ``eos_lag``, ``preadmit_wave``) are
    the unsharded port engine's, and those of JAX's EmbedEngine on the
    same mesh (float); f32 hidden states within HIDDEN_REL of max|ref| plus
    one bf16 ulp; w8a8 text-only hidden states bit for bit (the row-
    parallel sums are exact int32 and the vocabulary-split embedding adds
    zeros), with images within W8A8_IMAGE_REL. The exact and Gumbel samplers at temperature 0.6: each data
    coordinate's streams are the unsharded port engine's on its block with
    the same seed (JAX's Gumbel sampler needs a TPU). Every rank returns
    the same result; a rank holds its share of the weights and of the KV
    heads."""
    images, prompts = _requests()
    cases = _cases(trees)
    inp = {"mesh": shape, "specials": TINY_SPECIALS, "cases": {
        name: {"cfg": _cfg_kw(v), "params": trees[v], "engine": kw,
               "call": call, "call_kw": ck, "prompts": prompts,
               "images": images if with_images else None}
        for name, (v, kw, call, ck, with_images) in cases.items()}}
    world = int(np.prod(shape))
    wait = start("engine", tmp_path, inp, world=world)

    # JAX's engine on the same mesh (greedy, float, untied)
    from PIL import Image

    jeng = je.EmbedEngine(
        jq.Qwen2VLConfig.tiny(**QWEN, vision=jq.Qwen2VLVisionConfig(**VISION)),
        trees["f32"], _tokenizer(), mesh=_jax_mesh(shape), **GREEDY)
    jsamples = {"images": [Image.fromarray(a) for a in images],
                "answers": prompts}
    jax_ids = {"generate": jeng.generate(jsamples, seed=0).output_token_ids}
    jeng.prefill_chunk = 64
    jax_ids["chunked"] = jeng.generate(jsamples, seed=0).output_token_ids

    d = shape[0]
    want = {}
    for name, case in cases.items():
        sampled = case[1]["temperature"] > 0
        if sampled and d > 1:
            parts = [_port_unsharded(trees, case, images[lo:hi],
                                     prompts[lo:hi])
                     for lo, hi in ((i * N_REQ // d, (i + 1) * N_REQ // d)
                                    for i in range(d))]
            want[name] = (sum((p.output_token_ids for p in parts), []),
                          sum((p.hidden_states for p in parts), []))
        else:
            r = _port_unsharded(trees, case, images, prompts)
            want[name] = (r.output_token_ids, r.hidden_states)

    outs = wait()
    first = outs[0]["result"]
    for out in outs[1:]:
        for name in cases:
            got = out["result"][name]
            assert got["tokens"] == first[name]["tokens"], name
            for a, b in zip(got["hidden"] + got["prompt_hidden"],
                            first[name]["hidden"]
                            + first[name]["prompt_hidden"]):
                assert np.array_equal(a, b), name
    for name, case in cases.items():
        got = first[name]
        assert got["tokens"] == want[name][0], name
        exact = "w8a8" in case[0] and not case[4]
        rel = W8A8_IMAGE_REL if "w8a8" in case[0] else HIDDEN_REL
        _hidden_close(got["hidden"], want[name][1], exact, rel)
    for name in ("generate", "chunked"):
        assert first[f"f32/{name}"]["tokens"] == jax_ids[name], name
    # the rank's KV heads: Hkv / model
    assert first["f32/generate"]["kv"][1] == QWEN["num_kv_heads"] // shape[2]


# -- the diffusion samplers ---------------------------------------------------

FLUX = dict(hidden_size=128, num_heads=4, axes_dims_rope=(8, 12, 12))
COG = dict(hidden_size=128, num_heads=4)
SAMPLER_TOL = 2e-4  # JAX's own test_cogvideox_sampler_on_mesh limit


@pytest.fixture(scope="module")
def flux_tree():
    from thinkdiff_tpu.models.flux import FluxConfig, FluxTransformer

    cfg = FluxConfig.tiny(**FLUX)
    params = FluxTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, cfg.in_channels)),
        jnp.zeros((1, 2, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)), jnp.ones((1,)),
        jnp.zeros((4, 3)), jnp.zeros((2, 3)), jnp.ones((1,)))["params"]
    return cfg, jax.tree.map(np.array, params)


@pytest.fixture(scope="module")
def cog_tree():
    from thinkdiff_tpu.models.cogvideox import (
        CogVideoXConfig, CogVideoXTransformer)

    cfg = CogVideoXConfig.tiny(**COG)
    params = CogVideoXTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, cfg.in_channels)),
        jnp.zeros((1, cfg.max_text_len, cfg.text_dim)),
        jnp.zeros((1,), jnp.int32))["params"]
    return cfg, jax.tree.map(np.array, params)


def _sampler_ranks(tmp_path, kind, shape, cfg_kw, params, args, **extra):
    inp = {"mesh": shape, "kind": kind, "cfg": cfg_kw, "params": params,
           "args": args, **extra}
    return start("sampler", tmp_path, inp, world=int(np.prod(shape)))


def _check_sampler(outs, want, whole_shapes, split=True):
    """Every rank's latents within SAMPLER_TOL of JAX's, identical across
    ranks, and with ``split`` some leaf split (the model is not silently
    replicated), else every leaf whole."""
    first = outs[0]["result"]
    for out in outs:
        got = out["result"]["latents"]
        np.testing.assert_allclose(got, want, rtol=SAMPLER_TOL,
                                   atol=SAMPLER_TOL)
        assert np.array_equal(got, first["latents"])
    cut = [k for k, v in whole_shapes.items() if first["blocks"][k] != v]
    assert bool(cut) == split, cut


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2)], ids=str)
def test_flux_sampler_on_mesh(tmp_path, flux_tree, shape):
    """FluxSampler(mesh=...) two Euler steps at 32x32 (batch 2) from JAX's
    noise draw for seed 0, against JAX's FluxSampler on the same mesh."""
    from thinkdiff_torch.models.flux import FluxConfig, FluxTransformer
    from thinkdiff_tpu.engines.flux_sampler import (
        FluxSampler, flux_sigmas, make_img_ids)

    cfg, params = flux_tree
    rs = np.random.RandomState(0)
    txt = rs.randn(2, 2, cfg.joint_attention_dim).astype(np.float32)
    pooled = rs.randn(2, cfg.pooled_projection_dim).astype(np.float32)
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                       (2, 4, cfg.in_channels), jnp.float32))
    args = {"latents": lat, "txt": txt, "pooled": pooled,
            "img_ids": make_img_ids(4, 4).astype(np.float32),
            "txt_ids": np.zeros((2, 3), np.float32)}
    wait = _sampler_ranks(tmp_path, "flux", shape, FLUX, params, args,
                          sigmas=flux_sigmas(2, 4), guidance=3.5)
    want = np.asarray(FluxSampler(cfg, params, mesh=_jax_mesh(shape)).sample(
        txt, pooled, height=32, width=32, num_steps=2, seed=0,
        output_latents=True), np.float32)
    whole = {k: tuple(t.shape) for k, t in FluxTransformer(
        FluxConfig.tiny(**FLUX), device="meta").named_parameters()}
    _check_sampler(wait(), want, whole)


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 1)], ids=str)
def test_cogvideox_sampler_on_mesh(tmp_path, cog_tree, shape):
    """CogVideoXSampler(mesh=...) two DDIM steps (batch 2, 2 x 16 x 16
    latents) from JAX's noise draw for seed 0, against JAX's sampler on
    the same mesh; at ``model`` 2 the blocks run on local heads."""
    from thinkdiff_torch.models.cogvideox import (
        CogVideoXConfig, CogVideoXTransformer)
    from thinkdiff_tpu.models.cogvideox import CogVideoXSampler

    cfg, params = cog_tree
    rs = np.random.RandomState(0)
    text = rs.randn(2, cfg.max_text_len, cfg.text_dim).astype(np.float32)
    lat = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (2, 2, 16, 16, cfg.in_channels), jnp.float32))
    wait = _sampler_ranks(tmp_path, "cog", shape, COG, params,
                          {"latents": lat, "text": text}, steps=2)
    want = np.asarray(CogVideoXSampler(
        cfg, params, mesh=_jax_mesh(shape)).sample(
            text, frames=2, height=16, width=16, num_steps=2, seed=0),
        np.float32)
    whole = {k: tuple(t.shape) for k, t in CogVideoXTransformer(
        CogVideoXConfig.tiny(**COG), device="meta").named_parameters()}
    # data alone splits the batch, not the weights
    _check_sampler(wait(), want, whole, split=shape[2] > 1)


# -- the seeded and tree builds of Qwen2-VL --------------------------------

def _seeded_cfg(quant):
    return dict(QWEN, quant_int8=quant, fused_proj=bool(quant),
                vision=dict(VISION, quant_int8=quant))


def _init_tree(cfg_kw, seed):
    """``init_params`` from ``seed``, quantized and fused as the config
    says (the chip script's 7B weights)."""
    from thinkdiff_torch.models.bridge import to_numpy
    from thinkdiff_torch.ops.quant import quantize_tree

    cfg = tq.Qwen2VLConfig.tiny(**{
        **cfg_kw, "vision": tq.Qwen2VLVisionConfig(**cfg_kw["vision"])})
    tree = tq.init_params(cfg, torch.Generator().manual_seed(seed))
    quant = cfg.quant_int8
    if quant:
        w8 = quant == "w8a8"
        tree["lm"] = tq.fuse_qwen2_params(quantize_tree(tree["lm"], 0, w8))
        tree["vision"] = quantize_tree(tree["vision"], 0, w8)
    return jax.tree.map(lambda t: to_numpy(t) if isinstance(t, torch.Tensor)
                        else t, tree)


@pytest.mark.parametrize("quant", [False, True, "w8a8"],
                         ids=["f32", "int8", "w8a8"])
def test_init_draw_is_init_params(quant):
    """``init_draw`` filling the towers one submodule at a time gives, bit
    for bit, ``init_params`` quantized (weight-only or w8a8) and fused."""
    from thinkdiff_torch.models.bridge import fill_, flatten, params_of

    cfg_kw = _seeded_cfg(quant)
    want = flatten(_init_tree(cfg_kw, 5))
    cfg = tq.Qwen2VLConfig.tiny(**{
        **cfg_kw, "vision": tq.Qwen2VLVisionConfig(**cfg_kw["vision"])})
    draw = tq.init_draw(cfg, torch.Generator().manual_seed(5))
    got = {"vision": params_of(fill_(tq.Qwen2VisionTower(cfg.vision), draw)),
           "lm": params_of(fill_(tq.Qwen2VLModel(cfg), draw))}
    got = flatten(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]).view(np.uint8),
                              np.asarray(want[k]).view(np.uint8)), k


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)], ids=str)
def test_sharded_qwen2_vl_builds_gather_back(tmp_path, shape):
    """EmbedEngine(mesh=...) built from the seeded draw and from a JAX-
    layout tree, block by block (w8a8 LM, fused, int8 vision): every
    rank's towers gathered back (``tree_of``) are the whole trees bit for
    bit, and a rank holds the rules' share of their bytes."""
    from thinkdiff_torch.models.bridge import flatten
    from thinkdiff_torch.parallel import mesh as tmesh
    from thinkdiff_torch.parallel import sharding as tsh

    cfg_kw = _seeded_cfg("w8a8")
    tree = _init_tree(cfg_kw, 5)
    outs = start("qwen_seeded", tmp_path, {
        "mesh": shape, "cfg": cfg_kw, "seed": 5, "tree": tree},
        world=int(np.prod(shape)))()
    want = flatten(tree)
    cfg = tq.Qwen2VLConfig.tiny(**{
        **cfg_kw, "vision": tq.Qwen2VLVisionConfig(**cfg_kw["vision"])})
    mesh = tmesh.Mesh(*shape)
    share = 0
    for module in (tq.Qwen2VisionTower(cfg.vision, device="meta"),
                   tq.Qwen2VLModel(cfg, device="meta")):
        leaves = dict([*module.named_parameters(), *module.named_buffers()])
        share += tsh.rank_bytes(tsh.placements(module, mesh), mesh,
                                {k: t.dtype for k, t in leaves.items()})
    for out in outs:
        for build in ("seeded", "tree"):
            got = out["result"][build]
            assert got["held"] == share
            flat = flatten({"vision": got["vision"], "lm": got["lm"]})
            assert sorted(flat) == sorted(want)
            for k in want:
                assert np.array_equal(np.asarray(flat[k]).view(np.uint8),
                                      np.asarray(want[k]).view(np.uint8)), k
