"""Port parity: thinkdiff_torch.models.qwen2_vl against the JAX model, on
Qwen2VLConfig.tiny() in f32. Parameters come from the JAX model's init and
reach the port through the weight bridge; inputs are seeded numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.models import qwen2_vl as tm
from thinkdiff_torch.models.bridge import flatten, load_params, params_of
from thinkdiff_torch.ops import rope as trope
from thinkdiff_tpu.models import golden_pack
from thinkdiff_tpu.models import qwen2_vl as jm
from thinkdiff_tpu.ops import quant as jq
from thinkdiff_tpu.ops import rope as jrope

# f32 on both sides; the attention and matmul sums run in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def base():
    cfg = jm.Qwen2VLConfig.tiny()
    rng = jax.random.PRNGKey(0)
    vp = jm.Qwen2VisionTower(cfg.vision).init(
        rng, jnp.zeros((4, cfg.vision.patch_dim)),
        jnp.zeros((4, cfg.vision.head_dim // 2)),
        jnp.zeros((4, cfg.vision.head_dim // 2)), None)["params"]
    lp = jm.Qwen2VLModel(cfg).init(
        rng, input_ids=jnp.zeros((1, 4), jnp.int32),
        position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
    return _np_tree(vp), _np_tree(lp)


# variant -> (config overrides, lm tree transform)
VARIANTS = {
    "fp": ({}, lambda lm: lm),
    "fused": ({"fused_proj": True}, jm.fuse_qwen2_params),
    "int8": ({"quant_int8": True},
             lambda lm: jq.quantize_tree(lm, min_size=0)),
    "w8a8_fused": ({"quant_int8": "w8a8", "fused_proj": True},
                   lambda lm: jm.fuse_qwen2_params(
                       jq.quantize_tree(lm, min_size=0, w8a8=True))),
}


def _models(base, variant):
    over, transform = VARIANTS[variant]
    lm_tree = _np_tree(transform(base[1]))
    jcfg = jm.Qwen2VLConfig.tiny(**over)
    tcfg = tm.Qwen2VLConfig.tiny(**over)
    port = load_params(tm.Qwen2VLModel(tcfg), lm_tree).eval()
    return jm.Qwen2VLModel(jcfg), lm_tree, port, tcfg


def _prompt(cfg, n_img_tokens=4, lens=(12, 9)):
    """Two padded sequences with an image span in the first."""
    rs = np.random.RandomState(1)
    t = max(lens)
    ids = rs.randint(1, 200, (len(lens), t)).astype(np.int64)
    ids[0, 2:2 + n_img_tokens] = cfg.image_token_id
    mask = (np.arange(t)[None] < np.asarray(lens)[:, None]).astype(np.int64)
    pos = np.zeros((3, len(lens), t), np.int64)
    deltas = []
    for b, L in enumerate(lens):
        grids = [(1, 4, 4)] if b == 0 else []
        p, d = jm.get_mrope_position_ids(ids[b, :L], grids, cfg.image_token_id)
        pos[:, b, :L] = p
        deltas.append(int(d))
    img = rs.randn(len(lens), t, cfg.hidden_size).astype(np.float32)
    img_mask = (ids == cfg.image_token_id).astype(np.int64)
    return ids, mask, pos, img, img_mask, np.asarray(lens), np.asarray(deltas)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridge_round_trip_exact(base, variant):
    _, lm_tree, port, _ = _models(base, variant)
    back = flatten(params_of(port))
    want = flatten(lm_tree)
    assert sorted(back) == sorted(want)
    for key, val in want.items():
        assert back[key].dtype == val.dtype, key
        np.testing.assert_array_equal(back[key], val, err_msg=key)


@pytest.mark.parametrize("vquant", [False, True, "w8a8"])
def test_vision_tower_matches(base, vquant):
    vtree = base[0] if not vquant else _np_tree(
        jq.quantize_tree(base[0], min_size=0, w8a8=vquant == "w8a8"))
    jvc = dataclasses.replace(jm.Qwen2VLConfig.tiny().vision, quant_int8=vquant)
    tvc = dataclasses.replace(tm.Qwen2VLConfig.tiny().vision, quant_int8=vquant)
    port = load_params(tm.Qwen2VisionTower(tvc), vtree).eval()
    grid = np.asarray([[1, 4, 4]])
    cos, sin = tm.vision_cos_sin(tm.vision_rot_pos_emb(grid, 2), tvc.head_dim)
    patches = np.random.RandomState(2).randn(2, 16, tvc.patch_dim).astype(
        np.float32)
    def jax_tower(x):
        return np.asarray(jm.Qwen2VisionTower(jvc).apply(
            {"params": vtree}, jnp.asarray(x), jnp.asarray(cos),
            jnp.asarray(sin)))

    for x in (patches, patches[0]):           # batched and 2-D inputs
        want = jax_tower(x)
        got = port(torch.from_numpy(x), torch.from_numpy(cos),
                   torch.from_numpy(sin)).detach().numpy()
        assert got.shape == want.shape
        atol = TOL["atol"]
        if vquant == "w8a8":
            # per-row activation rounding at these 32-wide layers: a 1e-7
            # relative nudge of the input moves the JAX tower's own output
            # by ~2.5e-2 (one flipped int8 step in block 0). Hold the port
            # to that sensitivity on top of the f32 tolerance.
            atol += np.abs(jax_tower(x * (1 + 1e-7)) - want).max()
        np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_hidden_and_logits_match(base, variant):
    jmodel, lm_tree, port, cfg = _models(base, variant)
    ids, mask, pos, img, img_mask, _, _ = _prompt(cfg)
    want_logits, want_hidden, _ = jmodel.apply(
        {"params": lm_tree}, input_ids=jnp.asarray(ids),
        position_ids=jnp.asarray(pos), mask=jnp.asarray(mask),
        image_embeds=jnp.asarray(img), image_mask=jnp.asarray(img_mask))
    with torch.no_grad():
        logits, hidden, _ = port(
            input_ids=torch.from_numpy(ids), position_ids=torch.from_numpy(pos),
            mask=torch.from_numpy(mask), image_embeds=torch.from_numpy(img),
            image_mask=torch.from_numpy(img_mask))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_cache_prefill_and_decode_match(base, variant):
    """JAX prefills through its cache branch (cache_len 0); the port runs the
    causal flash path and writes the cache. Real positions must agree, and
    so must three decode steps over the cache (hidden tap and logits)."""
    jmodel, lm_tree, port, cfg = _models(base, variant)
    ids, mask, pos, img, img_mask, lens, deltas = _prompt(cfg)
    b, t = ids.shape
    shape = (b, cfg.num_kv_heads, t + 4, cfg.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape))
               for _ in range(cfg.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape))
               for _ in range(cfg.num_layers)]
    params = {"params": lm_tree}
    _, jh, jcaches = jmodel.apply(
        params, input_ids=jnp.asarray(ids), position_ids=jnp.asarray(pos),
        mask=jnp.asarray(mask), image_embeds=jnp.asarray(img),
        image_mask=jnp.asarray(img_mask), caches=jcaches,
        cache_len=jnp.zeros((b,), jnp.int32), compute_logits=False)
    with torch.no_grad():
        _, th, tcaches = port(
            input_ids=torch.from_numpy(ids), position_ids=torch.from_numpy(pos),
            mask=torch.from_numpy(mask), image_embeds=torch.from_numpy(img),
            image_mask=torch.from_numpy(img_mask), caches=tcaches,
            compute_logits=False)
    real = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], **TOL)

    tokens = np.asarray([5, 17])
    for step in range(3):
        p = np.broadcast_to((lens + deltas + step)[None, :, None], (3, b, 1))
        cache_len = lens + step
        jl, jh, jcaches = jmodel.apply(
            params, input_ids=jnp.asarray(tokens)[:, None],
            position_ids=jnp.asarray(p), caches=jcaches,
            cache_len=jnp.asarray(cache_len, jnp.int32))
        with torch.no_grad():
            tl, th, tcaches = port(
                input_ids=torch.from_numpy(tokens)[:, None],
                position_ids=torch.from_numpy(np.ascontiguousarray(p)),
                caches=tcaches, cache_len=torch.from_numpy(cache_len))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tokens = np.asarray(jnp.argmax(jl[:, 0], -1))


def test_goldens_hidden_tap_and_logits():
    """The committed HF-derived golden pack, through the port's converter:
    the same checks and tolerances as golden_pack.check_qwen2_vl."""
    root = golden_pack.default_root()
    with np.load(root / "qwen2_vl_ckpt.npz") as z:
        sd = {k: z[k] for k in z.files}
    with np.load(root / "qwen2_vl_io.npz") as z:
        io = {k: z[k] for k in z.files}
    params = tm.convert_qwen2_vl(sd)
    jparams = jm.convert_qwen2_vl(sd)
    for key, val in flatten(jparams).items():
        np.testing.assert_array_equal(flatten(params)[key], val)
    cfg = tm.Qwen2VLConfig.tiny()
    vision = load_params(tm.Qwen2VisionTower(cfg.vision), params["vision"])
    lm = load_params(tm.Qwen2VLModel(cfg), params["lm"])
    ids, grid = io["input_ids"], io["grid_thw"]
    cos, sin = tm.vision_cos_sin(
        tm.vision_rot_pos_emb(grid, cfg.vision.spatial_merge_size),
        cfg.vision.head_dim)
    with torch.no_grad():
        img = vision(torch.from_numpy(io["pixel_values"]), torch.from_numpy(cos),
                     torch.from_numpy(sin))
        is_img = torch.from_numpy(ids == cfg.image_token_id)
        full = torch.zeros((1, len(ids), cfg.hidden_size))
        full[0, is_img] = img
        pos, _ = tm.get_mrope_position_ids(ids, grid, cfg.image_token_id,
                                           cfg.vision.spatial_merge_size)
        logits, hidden, _ = lm(
            input_ids=torch.from_numpy(ids)[None],
            position_ids=torch.from_numpy(pos)[:, None],
            image_embeds=full, image_mask=is_img[None].long())
    tol = dict(atol=golden_pack.ATOL, rtol=golden_pack.RTOL)
    np.testing.assert_allclose(logits[0].numpy(), io["logits"], **tol)
    np.testing.assert_allclose(hidden[0].numpy(), io["hidden_tap"], **tol)


@pytest.mark.parametrize("grids", [[(1, 4, 4)], [(1, 4, 6), (1, 2, 2)], []])
def test_position_helpers_identical(grids):
    cfg = tm.Qwen2VLConfig.tiny()
    ids = [7, 8]
    for t, h, w in grids:
        ids += [cfg.vision_start_token_id] + [cfg.image_token_id] * (
            t * h * w // 4) + [9]
    ids += [10, 11]
    got = tm.get_mrope_position_ids(np.asarray(ids), grids, cfg.image_token_id)
    want = jm.get_mrope_position_ids(np.asarray(ids), grids, cfg.image_token_id)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    if grids:
        g = np.asarray(grids)
        np.testing.assert_array_equal(tm.vision_rot_pos_emb(g, 2),
                                      jm.vision_rot_pos_emb(g, 2))
        for a, b in zip(tm.vision_cos_sin(tm.vision_rot_pos_emb(g, 2), 80),
                        jm.vision_cos_sin(jm.vision_rot_pos_emb(g, 2), 80)):
            np.testing.assert_array_equal(a, b)


def test_mrope_tables_and_rope_match():
    rs = np.random.RandomState(3)
    pos = rs.randint(0, 300, (3, 2, 7))
    want = jrope.mrope_cos_sin(jnp.asarray(pos), 128, [16, 24, 24])
    got = trope.mrope_cos_sin(torch.from_numpy(pos), 128, [16, 24, 24])
    for a, b in zip(got, want):
        # f32 pow/cos/sin in two libraries: a few ulps at angles up to ~300
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    q = rs.randn(2, 4, 7, 128).astype(np.float32)
    k = rs.randn(2, 2, 7, 128).astype(np.float32)
    cos, sin = (np.asarray(t)[:, None] for t in want)
    jq_, jk_ = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(cos), jnp.asarray(sin))
    tq_, tk_ = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq_), atol=1e-6)
    np.testing.assert_allclose(tk_.numpy(), np.asarray(jk_), atol=1e-6)
