"""Port parity: the vision transformer (thinkdiff_torch.models.vit) and the
HF converter of its checkpoints against the JAX package, at tiny geometry
on the CPU (the flash forward's plain version): BLIP-2 and CLIP-L
layouts, EVA's per-block and shared relative bias, the CLS-preserving
downsample, and HF's tiny BLIP-2 tower through the golden pack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import randomize
from thinkdiff_torch.models import convert as tconv
from thinkdiff_torch.models import vit as tv
from thinkdiff_torch.models.bridge import load_params, params_of
from thinkdiff_tpu.models import convert as jconv
from thinkdiff_tpu.models import vit as jv
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root

GOLDENS = default_root()

# the four layouts the module covers, at the tiny geometry (28x28 images,
# patches of 14: 4 patches + CLS, 4 heads of 8)
CONFIGS = {
    "blip2": {},
    "clip_l": dict(hidden_act="quick_gelu", layer_norm_eps=1e-5,
                   use_pre_norm=True),
    "per_block_rel_bias": dict(use_rel_pos_bias=True),
    "shared_rel_bias": dict(use_shared_rel_pos_bias=True),
    "no_patch_bias": dict(patch_bias=False),
}

# f32 on both sides; measured max |port - JAX| 1.6e-6-2.6e-6 at |x| ~
# 2.6-2.9 (the summation order of the matmuls and of the flash plain
# version's softmax)
VIT_ATOL = 2e-5


def _pixels(seed=0, b=2, hw=28):
    return np.random.RandomState(seed).randn(b, hw, hw, 3).astype(np.float32)


def _jax_vit(kw, seed=0):
    cfg = jv.ViTConfig.tiny(**kw)
    model = jv.VisionTransformer(cfg)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 3)))["params"])
    return model, randomize(params, np.random.RandomState(seed + 1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vision_transformer_matches_jax(name):
    jm, params = _jax_vit(CONFIGS[name])
    tm = load_params(tv.VisionTransformer(tv.ViTConfig.tiny(**CONFIGS[name])),
                     params)
    x = _pixels()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5, 32)
    np.testing.assert_allclose(got, want, atol=VIT_ATOL, rtol=0)
    # the bridge's round trip is exact, and the JAX names are the port's
    back = params_of(tm)
    flat = lambda t, p="": {f"{p}{k}": v for k, v in t.items()
                            if not isinstance(v, dict)} | {
        kk: vv for k, v in t.items() if isinstance(v, dict)
        for kk, vv in flat(v, f"{p}{k}/").items()}
    assert set(flat(back)) == set(flat(params))
    for k, v in flat(params).items():
        assert np.array_equal(flat(back)[k], v), k


def test_vision_transformer_bf16_close_to_jax():
    """bf16 weights and activations on both sides (the aligner's dtype).
    The two round at other places (LayerNorm statistics, the flash plain
    version's f32 softmax), so each is held against the f32 forward too.
    Measured over seeds 3-8: |port - JAX| 0.023-0.039 at max |x| 2.7-3.4
    (1.5-2.5 bf16 ulps of the largest output), limit 4 ulps; the port's
    distance to the f32 forward 0.66-1.11 times JAX's own, limit 1.5."""
    _, params = _jax_vit({}, seed=3)
    jm = jv.VisionTransformer(jv.ViTConfig.tiny(dtype=jnp.bfloat16))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tm = load_params(tv.VisionTransformer(tv.ViTConfig.tiny(
        dtype=torch.bfloat16)), params)
    x = _pixels(4)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)),
                      np.float32)
    f32 = np.asarray(jv.VisionTransformer(jv.ViTConfig.tiny()).apply(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp
    assert np.abs(got - f32).max() <= 1.5 * np.abs(want - f32).max()


def test_rel_pos_index_identical():
    for g in ((2, 2), (4, 4), (3, 5)):
        got, n = tv.rel_pos_index(*g)
        want, wn = jv.rel_pos_index(*g)
        assert n == wn and np.array_equal(got, want)


@pytest.mark.parametrize("grid,factor", [(16, 2), (16, 4), (6, 2), (4, 4)])
def test_vision_downsample_matches_jax(grid, factor):
    """The antialiased bilinear shrink of jax.image.resize: 16 x 16 -> 8 x 8
    is ThinkDiff-CLIP's 257 -> 65 tokens (measured max |diff| 1.2e-7)."""
    rs = np.random.RandomState(grid * 10 + factor)
    tok = rs.randn(2, 1 + grid * grid, 8).astype(np.float32)
    want = np.asarray(jv.vision_downsample(jnp.asarray(tok), factor))
    got = tv.vision_downsample(torch.from_numpy(tok), factor).numpy()
    assert got.shape == want.shape == (2, 1 + (grid // factor) ** 2, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.array_equal(got[:, 0], tok[:, 0])
    with pytest.raises(ValueError, match="non-square"):
        tv.vision_downsample(torch.zeros(1, 6, 8), 2)


def test_golden_blip2_vit():
    """HF's tiny Blip2VisionModel through the port's convert_clip_vit and
    VisionTransformer reproduces HF's last_hidden_state (the golden pack's
    limits, as the JAX check holds it), and the converted tree is the JAX
    converter's, leaf for leaf."""
    sd = dict(np.load(GOLDENS / "blip2_vit_ckpt.npz"))
    io = np.load(GOLDENS / "blip2_vit_io.npz")
    tree = tconv.convert_clip_vit(sd, prefix="")
    jtree = jconv.convert_clip_vit(sd, prefix="")
    assert jax.tree.structure(jtree) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = tv.ViTConfig.tiny(patch_bias="embeddings.patch_embedding.bias" in sd)
    tm = load_params(tv.VisionTransformer(cfg), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(io["pixels"].transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(got, io["last_hidden"], atol=ATOL, rtol=RTOL)


def _clip_layout(sd):
    """The BLIP-2 fixture rewritten in CLIPVisionModel's layout (separate
    q/k/v, a position nn.Embedding, pre_layrnorm) under vision_model."""
    out = {}
    for k, v in sd.items():
        if k.endswith("self_attn.qkv.weight") or k.endswith("self_attn.qkv.bias"):
            base, leaf = k.rsplit(".qkv.", 1)
            d = v.shape[0] // 3
            for j, p in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"vision_model.{base}.{p}.{leaf}"] = v[j * d:(j + 1) * d]
        elif ".self_attn.projection." in k:
            out["vision_model." + k.replace("projection", "out_proj")] = v
        elif k == "embeddings.position_embedding":
            out["vision_model.embeddings.position_embedding.weight"] = v[0]
        elif k == "embeddings.class_embedding":
            out["vision_model." + k] = v.reshape(-1)
        else:
            out["vision_model." + k] = v
    out["vision_model.pre_layrnorm.weight"] = sd["post_layernorm.weight"] * 0.5
    out["vision_model.pre_layrnorm.bias"] = sd["post_layernorm.bias"]
    return out


def test_convert_clip_vit_clip_layout_and_dtype_identical_to_jax():
    import ml_dtypes

    sd = _clip_layout(dict(np.load(GOLDENS / "blip2_vit_ckpt.npz")))
    for dtype in (None, np.dtype(ml_dtypes.bfloat16)):
        tree = tconv.convert_clip_vit(sd, dtype=dtype)
        jtree = jconv.convert_clip_vit(sd, dtype=dtype)
        assert jax.tree.structure(jtree) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # a CLIP tree loads into the pre-norm tower
    tm = load_params(tv.VisionTransformer(tv.ViTConfig.tiny(
        use_pre_norm=True)), tconv.convert_clip_vit(sd))
    assert float(tm.pre_norm.scale[0]) == float(
        sd["vision_model.pre_layrnorm.weight"][0])


def test_attention_runs_the_flash_forward_on_projection_views(monkeypatch):
    """Without a relative bias each block's attention is one call of the
    flash forward on head-transposed views of the q/k/v projections (no
    copy: the kernel's operands), D = hidden / heads; with a bias it runs
    none."""
    calls = []
    orig = tv.flash_attention

    def spy(q, k, v, *a):
        calls.append((q.shape, q.is_contiguous(), q.stride()))
        return orig(q, k, v, *a)

    monkeypatch.setattr(tv, "flash_attention", spy)
    _, params = _jax_vit({})
    tm = load_params(tv.VisionTransformer(tv.ViTConfig.tiny()), params)
    with torch.no_grad():
        tm(torch.from_numpy(_pixels()))
    assert len(calls) == 2
    assert all(s == (2, 4, 5, 8) and not c and st == (160, 8, 32, 1)
               for s, c, st in calls)
    calls.clear()
    _, params = _jax_vit(CONFIGS["shared_rel_bias"])
    tm = load_params(tv.VisionTransformer(tv.ViTConfig.tiny(
        **CONFIGS["shared_rel_bias"])), params)
    with torch.no_grad():
        tm(torch.from_numpy(_pixels()))
    assert calls == []


def test_configs_identical_to_jax():
    for name in ("blip2_vision", "clip_vit_l", "eva_vit_g", "tiny"):
        t, j = getattr(tv.ViTConfig, name)(), getattr(jv.ViTConfig, name)()
        for f in ("hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "image_size", "patch_size", "hidden_act",
                  "layer_norm_eps", "use_pre_norm", "patch_bias",
                  "num_positions"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    g = tv.ViTConfig.blip2_vision()
    assert g.hidden_size // g.num_heads == 88 and g.num_positions == 257
