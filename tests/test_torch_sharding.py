"""The port's fsdp / model sharding (thinkdiff_torch/parallel/sharding.py)
against JAX's (thinkdiff_tpu/parallel/sharding.py): each leaf's placement
from the rules, each rank's block against JAX's addressable shard, the
mesh's axes and coordinates, the sharded QDense against the whole layer
(w8a8 bit for bit), the seeded sharded build, and the model peers'
loaders. Ranks are gloo subprocesses of tests/_torch_dist_child.py."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_distributed import launch
from thinkdiff_torch.models import aligner_clip as tc
from thinkdiff_torch.models import aligner_lvlm as ta
from thinkdiff_torch.models.bridge import flatten, params_of
from thinkdiff_torch.parallel import mesh as tmesh
from thinkdiff_torch.parallel import sharding as tsh
from thinkdiff_tpu.core.config import ConfigNode
from thinkdiff_tpu.models import aligner_clip as jc
from thinkdiff_tpu.models import aligner_lvlm as jl
from thinkdiff_tpu.parallel import mesh as jmesh
from thinkdiff_tpu.parallel import sharding as jsh

MESHES = [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4), (1, 4, 1)]
TINY_T5 = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
               num_decoder_layers=2, num_heads=4)
TINY_VIT = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, image_size=56, patch_size=14)


def lvlm_cfg(quant, fused, **t5):
    return {"dtype": "float32", "load_pretrained": False,
            "quantize_frozen": quant, "vlm_hidden_size": 16,
            "t5_config": {**TINY_T5, "fused_proj": fused, **t5}}


def clip_cfg(**kw):
    return {"arch": "blip-vision-t5-decoder", "dtype": "float32",
            "load_pretrained": False, "t5_config": dict(TINY_T5, num_layers=2),
            "vision_config": dict(TINY_VIT), "vision_downsample_factor": 2,
            **kw}


def _jax_mesh(shape):
    d, f, m = shape
    return jmesh.make_mesh(d, f, m, devices=jax.devices()[:d * f * m])


def _spec(p, ndim):
    return tuple(p) + (None,) * (ndim - len(tuple(p)))


def _port_specs(module, mesh, prefix):
    return {f"{prefix}/{k.replace('.', '/')}": pl
            for k, pl in tsh.placements(module, mesh).items()}


def leaves_tree(tree):
    return {k: leaves_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _check_tree(jtree, port_pls, shape):
    """Every leaf of the JAX tree: the port has it, with JAX's spec after
    _valid_spec, the same shape and, on every device of the mesh, the
    block shape of JAX's addressable shard."""
    jm = _jax_mesh(shape)
    mesh = tmesh.Mesh(*shape)
    specs = flatten(jax.tree_util.tree_map(
        lambda s: s, jsh.shard_spec_tree(jtree, mesh=jm),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    leaves = flatten(jtree)
    assert sorted(specs) == sorted(port_pls)
    port_specs = flatten(tsh.shard_spec_tree(leaves_tree(jtree), mesh))
    for path, jspec in specs.items():
        assert _spec(port_specs[path], leaves[path].ndim) == _spec(
            jspec, leaves[path].ndim), path
        pl, leaf = port_pls[path], leaves[path]
        assert tuple(pl.shape) == tuple(leaf.shape), path
        assert _spec(pl.spec, leaf.ndim) == _spec(jspec, leaf.ndim), path
    return jm, mesh, leaves


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("quant,fused", [(None, True), (None, False),
                                         ("int8", True), ("int8_dyn", True),
                                         ("int8_dyn", False)])
def test_lvlm_tree_placement_is_jax_s(shape, quant, fused):
    """The tiny LVLM frozen tree (float, weight-only int8, w8a8; fused and
    unfused): each leaf's spec is JAX's spec_for_param + _valid_spec, and
    each rank's block has the shape and bytes of JAX's shard on the
    device at its coordinate."""
    jm = jl.MllamaT5EmbedDecoder(ConfigNode(lvlm_cfg(quant, fused)), seed=0)
    tm = ta.MllamaT5EmbedDecoder(lvlm_cfg(quant, fused), device="cpu")
    jtree = {"t5": jax.tree.map(np.asarray, jm.frozen["t5"])}
    pls = _port_specs(tm.frozen["t5"], tmesh.Mesh(*shape), "t5")
    jmh, mesh, leaves = _check_tree(jtree, pls, shape)
    shardings = jsh.sharding_tree(jtree, jmh)
    devices = list(jmh.devices.flat)
    for path, leaf in leaves.items():
        placed = jax.device_put(leaf, flatten(shardings)[path])
        by_dev = {s.device: s.data for s in placed.addressable_shards}
        for rank, dev in enumerate(devices):
            block = tsh.local_block(torch.from_numpy(np.asarray(leaf)),
                                    pls[path], mesh, mesh.coords(rank))
            want = by_dev[dev]
            assert tuple(block.shape) == tuple(want.shape), (path, rank)
            assert block.numel() * block.element_size() == want.nbytes
            if pls[path].parts_dim is None:
                np.testing.assert_array_equal(block.numpy(),
                                              np.asarray(want), err_msg=path)


@pytest.mark.parametrize("shape", MESHES)
def test_clip_tree_placement_is_jax_s(shape):
    """The tiny ThinkDiff-CLIP frozen trees (ViT and T5 encoder/decoder):
    specs as JAX's, blocks as JAX's shards (out_proj, q/k/v of T5 and the
    patch kernel split over fsdp only)."""
    jm = jc.BlipVisionT5Decoder(ConfigNode(clip_cfg()), seed=0)
    tm = tc.BlipVisionT5Decoder(clip_cfg(), device="cpu")
    jtree = {k: jax.tree.map(np.asarray, v) for k, v in jm.frozen.items()}
    mesh = tmesh.Mesh(*shape)
    pls = {**_port_specs(tm.frozen["vision"], mesh, "vision"),
           **_port_specs(tm.frozen["t5"], mesh, "t5")}
    jmh, mesh, leaves = _check_tree(jtree, pls, shape)
    shardings = flatten(jsh.sharding_tree(jtree, jmh))
    devices = list(jmh.devices.flat)
    for path, leaf in leaves.items():
        placed = jax.device_put(leaf, shardings[path])
        by_dev = {s.device: s.data.shape for s in placed.addressable_shards}
        for rank, dev in enumerate(devices):
            assert pls[path].local_shape(mesh) == tuple(by_dev[dev]), path


def _meta_struct(module, prefix):
    return {f"{prefix}/{k.replace('.', '/')}": jax.ShapeDtypeStruct(
        tuple(t.shape), np.int8 if t.dtype == torch.int8 else np.float32)
        for k, t in [*module.named_parameters(), *module.named_buffers()]}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("which", ["lvlm_w8a8", "lvlm_yaml", "clip"])
def test_full_shape_placement_is_jax_s(shape, which):
    """The shipped configurations at their full shapes (flan-t5-xxl,
    ViT-g; the port's modules on ``meta``, JAX's rules on shape structs
    of the same names): every leaf's spec is JAX's."""
    from thinkdiff_torch.models.t5 import T5Config, T5ForConditionalGeneration
    from thinkdiff_torch.models.vit import ViTConfig, VisionTransformer

    towers = {}
    if which == "clip":
        towers["vision"] = VisionTransformer(ViTConfig(), device="meta")
        towers["t5"] = T5ForConditionalGeneration(
            T5Config.flan_t5_xxl(), device="meta", encoder=True)
    else:
        quant = "w8a8" if which == "lvlm_w8a8" else False
        towers["t5"] = T5ForConditionalGeneration(
            T5Config.flan_t5_xxl(fused_proj=quant == "w8a8",
                                 quant_int8=quant), device="meta")
    mesh = tmesh.Mesh(*shape)
    structs, pls = {}, {}
    for name, module in towers.items():
        structs.update(_meta_struct(module, name))
        pls.update(_port_specs(module, mesh, name))
    jtree = {}
    for path, st in structs.items():
        node = jtree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = st
    _check_tree(jtree, pls, shape)
    if which == "lvlm_w8a8" and shape == (1, 1, 2):
        # the sharded leaves of the benched configuration, as the rules
        # give them (the attention's o, cross q and cross o stay whole
        # over model)
        blk = "t5/decoder/block_0"
        assert pls[f"{blk}/self_attn/qkv/kernel_q"].spec == (None, "model")
        assert pls[f"{blk}/self_attn/qkv/kernel_q"].parts == 3
        assert pls[f"{blk}/ffn/wo/kernel_q"].spec == ("model", None)
        assert pls[f"{blk}/cross_attn/q/kernel_q"].spec == (None, None)
        assert pls[f"{blk}/self_attn/o/kernel_q"].spec == (None, None)
        assert pls["t5/shared/embedding"].spec == ("model", None)
        assert pls["t5/decoder/rel_bias/rel_embedding"].spec == ()


# -- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"model": 2},
                                  {"data": 1, "fsdp": 2, "model": 2},
                                  {"fsdp": 2, "model": 2},
                                  {"model": 4}, {"data": 2, "model": 2}])
def test_mesh_coordinates_are_jax_s(axes):
    """A 4-rank mesh has JAX's 4-device axis sizes, and rank r sits where
    JAX puts device r (``reshape(data, fsdp, model)``, model innermost)."""
    jm = jmesh.mesh_from_config({"mesh": axes}, devices=jax.devices()[:4])
    tm = tmesh.mesh_from_config({"mesh": axes}, world=4)
    assert tm.shape == dict(jm.shape)
    for idx, dev in np.ndenumerate(jm.devices):
        assert tm.coords(dev.id) == dict(zip(jmesh.AXES, idx))


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1), (2, 1, 1)],
                         ids=str)
def test_a_mesh_larger_than_the_world_is_refused(shape):
    """In a world of one, a Trainer given a mesh of 2 devices raises: a
    rank is one device, and no group would reduce its sharded layers (a
    row-parallel product would silently be a different function)."""
    from types import SimpleNamespace

    from thinkdiff_torch.engines.trainer import Trainer

    with pytest.raises(ValueError, match="world of 1"):
        Trainer(SimpleNamespace(device=torch.device("cpu")), {},
                device="cpu", mesh=tmesh.Mesh(*shape))
    assert tmesh.current_mesh() is None


def test_batch_rows_are_jax_s_batch_sharding():
    """The rows of a global batch a rank reads are its device's rows under
    JAX's (data, fsdp) batch sharding; model peers read the same."""
    shape = (2, 2, 2)
    jm, tm = _jax_mesh(shape), tmesh.Mesh(*shape)
    x = np.arange(8 * 3).reshape(8, 3)
    placed = jax.device_put(x, jmesh.batch_sharding(jm))
    by_dev = {s.device.id: np.asarray(s.data)
              for s in placed.addressable_shards}
    for rank in range(8):
        np.testing.assert_array_equal(
            tsh.batch_rows({"x": x}, tm, rank)["x"], by_dev[rank])


# -- the sharded QDense -----------------------------------------------------

LAYERS = {"qkv": (32, 96, 8), "wi_0": (32, 64, 1), "wo": (64, 32, 1),
          "o": (32, 32, 1), "lm_head": (32, 48, 1)}


def _qdense_inputs():
    from torch import nn

    from thinkdiff_torch.models.qdense import QDense

    rs = np.random.RandomState(0)
    weights = {}
    for quant in (False, "int8", "w8a8"):
        box = nn.Module()
        for name, (k, n, _) in LAYERS.items():
            setattr(box, name, QDense(k, n, torch.float32, quant,
                                      device="cpu", train_layout=True))
        tree = {}
        for name, t in [*box.named_parameters(), *box.named_buffers()]:
            if t.dtype == torch.int8:
                v = rs.randint(-127, 128, t.shape).astype(np.int8)
            elif name.endswith("kernel_scale"):
                v = (rs.rand(*t.shape) * 0.02 + 0.005).astype(np.float32)
            elif name.endswith("input_scale"):
                v = (rs.rand(*t.shape) + 0.5).astype(np.float32)
            else:
                v = rs.randn(*t.shape).astype(np.float32) * 0.2
            tree[name.replace(".", "/")] = v
        from thinkdiff_torch.models.bridge import unflatten
        weights[str(quant)] = unflatten(tree)
    x = {n: rs.randn(2, 40, k).astype(np.float32) for n, (k, _, _) in
         LAYERS.items()}
    dy = {n: rs.randn(2, 40, m).astype(np.float32) for n, (_, m, _) in
          LAYERS.items()}
    return weights, x, dy


def _whole(weights, quant, name, x, dy):
    from torch import nn

    from thinkdiff_torch.models.bridge import load_params
    from thinkdiff_torch.models.qdense import QDense

    k, n, _ = LAYERS[name]
    box = nn.Module()
    setattr(box, name, QDense(k, n, torch.float32, quant or False,
                              device="cpu", train_layout=True))
    load_params(box, {name: weights[str(quant)][name]})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = getattr(box, name)(xt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)])
def test_sharded_qdense_is_the_whole_layer(tmp_path, shape):
    """Column (fused qkv arranged by head, wi_0, lm_head), row (wo) and
    fsdp-only (o) QDense layers at every quant mode on a model-2 mesh:
    forward and dx against the unsharded layer. w8a8 bit for bit (global
    row absmax, int32 partial sums added over the group); float and
    weight-only int8 (f32 partials summed in another order) within 1e-6
    of the reference's largest magnitude."""
    weights, x, dy = _qdense_inputs()
    layers = {n: list(v) for n, v in LAYERS.items()}
    world = int(np.prod(shape))
    outs = launch("qdense", tmp_path, {
        "mesh": shape, "layers": layers, "weights": weights, "x": x,
        "dy": dy}, world=world)
    for quant in (False, "int8", "w8a8"):
        for name in LAYERS:
            want_y, want_dx = _whole(weights, quant, name, x[name], dy[name])
            for out in outs:
                got_y, got_dx = out["result"][(str(quant), name)]
                if quant == "w8a8":
                    assert np.array_equal(got_y, want_y), (name, "y")
                    assert np.array_equal(got_dx, want_dx), (name, "dx")
                else:
                    for got, want in ((got_y, want_y), (got_dx, want_dx)):
                        np.testing.assert_allclose(
                            got, want, rtol=0,
                            atol=1e-6 * np.abs(want).max(), err_msg=name)


# -- the serving models: Qwen2-VL, FLUX with its VAE, CogVideoX ---------------

# JAX's tiny configs of tests/test_engine_sharding.py
QWEN_TINY = dict(hidden_size=128, intermediate_size=256, num_heads=4,
                 num_kv_heads=2, mrope_section=(4, 6, 6), vocab_size=512)
QWEN_TINY_VISION = dict(depth=2, embed_dim=32, hidden_size=128, num_heads=4,
                        patch_size=4, spatial_merge_size=2,
                        temporal_patch_size=2)
QWEN_VARIANTS = {  # (quant, fused, tied)
    "f32": (False, False, False), "f32_fused": (False, True, False),
    "int8": (True, True, False), "w8a8": ("w8a8", True, False),
    "w8a8_unfused": ("w8a8", False, False), "f32_tied": (False, False, True),
    "w8a8_tied": ("w8a8", True, True)}


def qwen_towers(variant, size="tiny"):
    """{"vision", "lm"} of a Qwen2-VL variant on ``meta``: the tiny config
    of JAX's engine test, or the shipped 2B / 7B shapes."""
    from thinkdiff_torch.models import qwen2_vl as tq

    quant, fused, tied = QWEN_VARIANTS[variant]
    if size == "tiny":
        cfg = tq.Qwen2VLConfig.tiny(
            **QWEN_TINY, quant_int8=quant, fused_proj=fused,
            tie_word_embeddings=tied, vision=tq.Qwen2VLVisionConfig(
                **QWEN_TINY_VISION, quant_int8=quant))
    else:
        make = {"2b": tq.Qwen2VLConfig.qwen2_vl_2b,
                "7b": tq.Qwen2VLConfig.qwen2_vl_7b}[size]
        cfg = make(quant_int8=quant, fused_proj=fused, vision_quant=quant)
    return {"vision": tq.Qwen2VisionTower(cfg.vision, device="meta"),
            "lm": tq.Qwen2VLModel(cfg, device="meta")}


def flux_towers(size="tiny"):
    from thinkdiff_torch.models import flux as tf
    from thinkdiff_torch.models import flux_vae as tv

    if size == "tiny":
        cfg = tf.FluxConfig.tiny(hidden_size=128, num_heads=4,
                                 axes_dims_rope=(8, 12, 12))
        vcfg = tv.VAEConfig.tiny()
    else:
        cfg, vcfg = tf.FluxConfig.flux_dev(), tv.VAEConfig.flux()
    return {"transformer": tf.FluxTransformer(cfg, device="meta"),
            "vae": tv.VAEDecoder(vcfg, device="meta")}


def cog_towers(size="tiny"):
    from thinkdiff_torch.models import cogvideox as tc

    cfg = (tc.CogVideoXConfig.tiny(hidden_size=128, num_heads=4)
           if size == "tiny" else tc.CogVideoXConfig.cogvideox_5b())
    return {"transformer": tc.CogVideoXTransformer(cfg, device="meta")}


def _towers_placed(towers, shape):
    """The towers' placements, each leaf's spec held against JAX's rules on
    shape structs of the same names (``_check_tree``)."""
    from thinkdiff_torch.models.bridge import unflatten

    mesh = tmesh.Mesh(*shape)
    structs, pls = {}, {}
    for name, module in towers.items():
        structs.update(_meta_struct(module, name))
        pls.update(_port_specs(module, mesh, name))
    _check_tree(unflatten(structs), pls, shape)
    return pls, structs


SERVING = ([("qwen", v, "tiny") for v in QWEN_VARIANTS]
           + [("qwen", v, s) for s in ("2b", "7b")
              for v in ("f32", "w8a8", "int8")]
           + [("flux", None, s) for s in ("tiny", "dev")]
           + [("cog", None, s) for s in ("tiny", "5b")])


def _serving_towers(model, variant, size):
    if model == "qwen":
        return qwen_towers(variant, size)
    return (flux_towers if model == "flux" else cog_towers)(size)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("model,variant,size", SERVING,
                         ids=["-".join(str(x) for x in c if x)
                              for c in SERVING])
def test_serving_placement_is_jax_s(shape, model, variant, size):
    """Every leaf of the serving models (Qwen2-VL's vision tower and LM in
    float, weight-only int8 and w8a8, fused and unfused, tied and untied;
    FLUX with its VAE; CogVideoX), at JAX's tiny shapes and on ``meta`` at
    the shipped 2B / 7B / FLUX.1-dev / CogVideoX-5b shapes: its spec is
    JAX's ``spec_for_param`` + ``_valid_spec``, and its block is the shape
    of JAX's shard."""
    _towers_placed(_serving_towers(model, variant, size), shape)


def _blocks_round_trip(full, pl, mesh):
    """Every rank's block of ``full``; their fsdp and model blocks joined
    and un-arranged again (what ``tree_of`` gathers) must be ``full``."""
    blocks = {r: tsh.local_block(full, pl, mesh, mesh.coords(r))
              for r in range(mesh.size)}
    fd, md = pl.dim_of("fsdp"), pl.dim_of("model")
    for d in range(mesh.data):
        def at(f, m):
            return blocks[(d * mesh.fsdp + f) * mesh.model + m]
        rows = []
        for f in range(mesh.fsdp):
            parts = [at(f, m) for m in range(mesh.model)]
            rows.append(torch.cat(parts, md) if md is not None else parts[0])
        x = torch.cat(rows, fd) if fd is not None else rows[0]
        if pl.parts_dim is not None:
            x = tsh.unarrange_parts(x, pl.parts_dim, pl.widths, mesh.model)
        assert torch.equal(x, full)
    return blocks


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 1, 2)], ids=str)
@pytest.mark.parametrize("variant", ["f32", "w8a8", "f32_tied"])
def test_qwen2_vl_blocks_are_jax_shards(shape, variant):
    """The tiny Qwen2-VL's leaves on a mesh: each rank's block has the
    shape and bytes of JAX's addressable shard on the device at its
    coordinate, equals it where the leaf keeps JAX's contiguous block, and
    the blocks gather back (``tree_of``'s way) into the whole leaf."""
    pls, structs = _towers_placed(qwen_towers(variant), shape)
    jm, mesh = _jax_mesh(shape), tmesh.Mesh(*shape)
    devices = list(jm.devices.flat)
    rs = np.random.RandomState(0)
    for path, st in structs.items():
        full = (rs.randint(-127, 128, st.shape).astype(np.int8)
                if st.dtype == np.int8 else
                rs.randn(*st.shape).astype(np.float32))
        spec = jsh._valid_spec(jsh.spec_for_param(
            [jax.tree_util.DictKey(k) for k in path.split("/")], full),
            full.shape, jm)
        placed = jax.device_put(full, jax.sharding.NamedSharding(jm, spec))
        by_dev = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        blocks = _blocks_round_trip(torch.from_numpy(full), pls[path], mesh)
        for rank, dev in enumerate(devices):
            assert tuple(blocks[rank].shape) == by_dev[dev].shape, path
            if pls[path].parts_dim is None:
                np.testing.assert_array_equal(blocks[rank].numpy(),
                                              by_dev[dev], err_msg=path)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, "w8a8"])
def test_qwen2_7b_fused_qkv_gives_whole_heads(m, quant):
    """Qwen2-VL-7B's fused GQA ``qkv`` (q | k | v = 3584 | 512 | 512
    columns) at ``model`` m: rank r holds exactly query heads [r H/m,
    (r+1) H/m) and kv heads [r Hkv/m, (r+1) Hkv/m) of 128 columns each,
    in q | k | v order (kernel and scale alike; the bias is replicated,
    and the layer takes the same columns of it); ``gate_up``
    (18944 | 18944) whole gate/up pairs: gate columns [r I/m, (r+1) I/m)
    then the same up columns."""
    towers = qwen_towers("w8a8" if quant else "f32_fused", "7b")
    mesh = tmesh.Mesh(1, 1, m)
    pls = {f"lm/{k.replace('.', '/')}": pl for k, pl in
           tsh.placements(towers["lm"], mesh).items()}
    hd, h, hkv, i = 128, 28, 4, 18944
    attn = "lm/decoder/layer_0/self_attn/qkv"
    kernel = "kernel_q" if quant else "kernel"
    assert pls[f"{attn}/bias"].spec == ()
    for leaf in (kernel,) + (("kernel_scale",) if quant else ()):
        pl = pls[f"{attn}/{leaf}"]
        assert pl.widths == (h * hd, hkv * hd, hkv * hd), leaf
        ids = torch.arange(pl.shape[-1]).expand(*pl.shape[:-1], -1)
        for r in range(m):
            got = tsh.local_block(ids, pl, mesh, mesh.coords(r))
            q = torch.arange(r * h // m * hd, (r + 1) * h // m * hd)
            k = h * hd + torch.arange(r * hkv // m * hd,
                                      (r + 1) * hkv // m * hd)
            want = torch.cat([q, k, k + hkv * hd])
            assert torch.equal(got.reshape(-1, got.shape[-1])[0], want), (
                leaf, r)
    pl = pls[f"lm/decoder/layer_0/gate_up/{kernel}"]
    assert pl.widths == (i, i)
    ids = torch.arange(2 * i)[None].expand(pl.shape[0], -1)
    for r in range(m):
        got = tsh.local_block(ids, pl, mesh, mesh.coords(r))[0]
        gate = torch.arange(r * i // m, (r + 1) * i // m)
        assert torch.equal(got, torch.cat([gate, gate + i])), r
    down = pls[f"lm/decoder/layer_0/down_proj/{kernel}"]
    assert down.spec == ("model", None)


def _rank_fraction(pls, names=None):
    mesh_pls = {k: v for k, v in pls.items()
                if names is None or names(k, v)}
    mesh = tmesh.Mesh(1, 2, 2)
    whole = sum(int(np.prod(p.shape)) for p in mesh_pls.values())
    local = sum(int(np.prod(p.local_shape(mesh))) for p in mesh_pls.values())
    return local / whole


@pytest.mark.parametrize("variant", ["f32", "w8a8"])
def test_qwen2_vl_params_not_silently_replicated(variant):
    """JAX's guard on the port: on (1, 2, 2), every LM leaf of 64 KiB or
    more with two dimensions is split, and a rank holds < 0.40 of the LM's
    elements (the same for the w8a8 twin)."""
    towers = qwen_towers(variant)
    pls = {k: pl for k, pl in tsh.placements(
        towers["lm"], tmesh.Mesh(1, 2, 2)).items()}
    for name, pl in pls.items():
        t = dict([*towers["lm"].named_parameters(),
                  *towers["lm"].named_buffers()])[name]
        if t.numel() * 4 >= 64 * 1024 and t.dim() >= 2:
            assert any(pl.spec), name
    frac = _rank_fraction(pls)
    assert frac < 0.40, frac


def test_flux_params_not_silently_replicated():
    """JAX's FLUX guard on the port: on (1, 2, 2) every matrix leaf of the
    tiny FLUX transformer is split, and a rank holds < 0.55 of their
    elements."""
    towers = flux_towers()
    pls = tsh.placements(towers["transformer"], tmesh.Mesh(1, 2, 2))
    mats = {k for k, pl in pls.items() if len(pl.shape) >= 2}
    for name in mats:
        assert any(pls[name].spec), name
    assert _rank_fraction(pls, lambda k, _: k in mats) < 0.55
