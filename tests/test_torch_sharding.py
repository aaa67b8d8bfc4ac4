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
