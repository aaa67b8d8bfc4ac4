"""Port parity: the ThinkDiff-CLIP aligner (thinkdiff_torch.models.aligner_clip)
against the JAX package's ``BlipVisionT5Decoder`` at tiny geometry on the
CPU (the kernels' plain versions), on the same frozen and trainable trees:
the caption-split loss and the projector's gradients (f32, bf16, weight-only
int8, w8a8), eval metrics, the inference encoder, the LayerNorm re-init,
the reference checkpoint's round trip, local HF checkpoints converted, the
launch count of a step, and that no gradient reaches the vision tower."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flux import randomize
from thinkdiff_torch.core.optim import tree_leaves
from thinkdiff_torch.models import aligner_clip as tc
from thinkdiff_torch.models.bridge import load_params, params_of
from thinkdiff_tpu.core.config import ConfigNode
from thinkdiff_tpu.models import aligner_clip as jc
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root

GOLDENS = default_root()
TINY_T5 = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_decoder_layers=2, num_heads=4)
# 56 x 56 images, patches of 14: a 4 x 4 grid, pooled x2 to 2 x 2 (5 tokens)
TINY_VIT = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, image_size=56, patch_size=14)


def model_cfg(quant=None, dtype="float32", **kw):
    return {"arch": "blip-vision-t5-decoder", "dtype": dtype,
            "load_pretrained": False, "t5_config": dict(TINY_T5),
            "vision_config": dict(TINY_VIT), "vision_downsample_factor": 2,
            "layer_norm_reinit_weight_with_language_encoder": True,
            "quantize_frozen": quant, **kw}


def same_models(quant=None, dtype="float32", seed=0):
    """The JAX model (its frozen vision tree redrawn so that norms and
    biases matter) and the port's model on the CPU holding the same frozen
    and trainable trees."""
    jm = jc.BlipVisionT5Decoder(ConfigNode(model_cfg(quant, dtype)), seed=seed)
    vision = randomize(jax.tree.map(np.asarray, jm.frozen["vision"]),
                       np.random.RandomState(seed + 1))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm.frozen["vision"] = jax.tree.map(lambda a: jnp.asarray(a, jdt), vision)
    tm = tc.BlipVisionT5Decoder(model_cfg(quant, dtype), device="cpu")
    load_params(tm.frozen["vision"], vision)
    load_params(tm.frozen["t5"], jax.tree.map(np.asarray, jm.frozen["t5"]))
    tm.load_trainable(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jm.trainable_params()))
    return jm, tm


def caption_batch(seed=3, b=2, hw=56):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 128, (b, 7)).astype(np.int32)
    mask = np.ones((b, 7), np.int32)
    mask[1, 4:] = 0
    ids[mask == 0] = 0
    labels = rs.randint(3, 128, (b, 6)).astype(np.int32)
    labels[0, 4:] = -100
    return {"pixel_values": rs.randn(b, hw, hw, 3).astype(np.float32),
            "input_ids": ids, "input_mask": mask, "labels": labels}


def _port_step(tm, batch):
    params = {k: {n: t.clone().requires_grad_() for n, t in d.items()}
              for k, d in tm.trainable["projector"].items()}
    loss = tm.loss_fn({"projector": params}, tm.frozen,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = tree_leaves({"projector": params})
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return float(loss), {n: g.numpy() for (n, _), g in zip(leaves, grads)}


def _jax_step(jm, batch):
    loss, grads = jax.value_and_grad(jm.loss_fn)(
        jm.trainable, jm.frozen, jax.tree.map(jnp.asarray, batch))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        g, np.float32) for path, g in jax.tree_util.tree_flatten_with_path(
            grads)[0]}
    return float(loss), flat


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# (loss rtol, gradient atol, gradient rtol) a mode, measured over seeds
# 0-2 (largest gradient error relative to the leaf's largest entry): f32,
# summation order only, loss 8.7e-8, gradients 3.1e-6; int8 weight-only,
# the same f32 products of the same int8 weights, 9.8e-8 and 7.1e-7; w8a8
# 9.8e-8 and 7.8e-7 (no activation here lands on a quantization edge; the
# decoder tests' 2e-3 covers one that does). bf16: the two packages round
# at other places; held by the loss within 2e-2 relative and each
# gradient's cosine >= 0.99 (measured loss 5.4e-4-1.4e-3, cosine 0.99954
# at worst).
TOLS = {None: (1e-5, 1e-6, 1e-4), "int8": (1e-5, 1e-6, 1e-4),
        "int8_dyn": (2e-3, 2e-4, 2e-3)}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8_dyn"])
def test_loss_and_projector_gradients_match_jax(mode):
    quant = None if mode in ("f32", "bf16") else mode
    dtype = "bfloat16" if mode == "bf16" else "float32"
    jm, tm = same_models(quant, dtype)
    batch = caption_batch()
    want_loss, want = _jax_step(jm, batch)
    got_loss, got = _port_step(tm, batch)
    assert set(got) == set(want) == {"projector/layer_0/kernel",
                                     "projector/layer_0/bias",
                                     "projector/layer_1/kernel",
                                     "projector/layer_1/bias",
                                     "projector/t5_norm/weight"}
    if mode == "bf16":
        np.testing.assert_allclose(got_loss, want_loss, rtol=2e-2)
        for k in want:
            assert _cos(got[k], want[k]) >= 0.99, k
        return
    lrt, gat, grt = TOLS[quant]
    np.testing.assert_allclose(got_loss, want_loss, rtol=lrt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=gat, rtol=grt,
                                   err_msg=k)


def test_eval_metrics_and_forward_encoder_match_jax():
    jm, tm = same_models(seed=4)
    batch = caption_batch(5)
    want = [float(x) for x in jm.eval_metrics_fn(
        jm.trainable, jm.frozen, jax.tree.map(jnp.asarray, batch))]
    got = [float(x) for x in tm.eval_metrics_fn(
        tm.trainable, tm.frozen,
        {k: torch.from_numpy(v) for k, v in batch.items()})]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    enc = tm.forward_encoder(batch["pixel_values"])
    assert enc.shape == (2, 5, 32) and not enc.requires_grad
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jm.forward_encoder(batch["pixel_values"])),
        atol=2e-5, rtol=2e-5)
    # without the pool: all 17 tokens
    tm.downsample_factor = None
    assert tm.forward_encoder(batch["pixel_values"][:1]).shape == (1, 17, 32)


def test_no_gradient_reaches_the_vision_tower(monkeypatch):
    """The ViT runs without autograd: each of its flash forward calls sees
    grad mode off (its head dim 88 has no backward kernel), its output
    needs no gradient, and none of its weights get one."""
    from thinkdiff_torch.models import vit as vit_mod

    modes = []
    orig = vit_mod.flash_attention

    def spy(*a):
        modes.append(torch.is_grad_enabled())
        return orig(*a)

    monkeypatch.setattr(vit_mod, "flash_attention", spy)
    _, tm = same_models(seed=6)
    batch = {k: torch.from_numpy(v) for k, v in caption_batch().items()}
    params = {k: {n: t.clone().requires_grad_() for n, t in d.items()}
              for k, d in tm.trainable["projector"].items()}
    tm.loss_fn({"projector": params}, tm.frozen, batch).backward()
    assert modes == [False, False]
    assert all(p.grad is None and not p.requires_grad
               for p in tm.frozen["vision"].parameters())
    assert not tm.encode_image(tm.frozen, batch["pixel_values"]).requires_grad
    assert all(p.grad is not None for d in params.values()
               for p in d.values())


def test_layer_norm_reinit_copies_the_encoder_final_norm():
    jm, tm = same_models(seed=7)
    np.testing.assert_array_equal(
        np.asarray(jm.trainable["projector"]["t5_norm"]["weight"]),
        np.asarray(jm.frozen["t5"]["encoder"]["final_norm"]["weight"]))
    fresh = tc.BlipVisionT5Decoder(model_cfg(), seed=2, device="cpu")
    assert torch.equal(fresh.trainable["projector"]["t5_norm"]["weight"],
                       fresh.frozen["t5"].encoder.final_norm.weight)
    off = tc.BlipVisionT5Decoder(model_cfg(
        layer_norm_reinit_weight_with_language_encoder=False), seed=2,
        device="cpu")
    assert torch.equal(off.trainable["projector"]["t5_norm"]["weight"],
                       torch.ones(32))


def test_reference_checkpoint_round_trip_matches_jax(tmp_path):
    jm, tm = same_models(seed=8)
    sd = tm.export_reference_checkpoint(tm.trainable)
    want = jm.export_reference_checkpoint(jm.trainable)
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(sd[k], np.float32),
                                      np.asarray(want[k], np.float32))
    path = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in
                          sd.items()}}, path)
    other = tc.BlipVisionT5Decoder(model_cfg(), seed=9, device="cpu")
    other.load_checkpoint_from_config({"ckpt": str(path)})
    for (n, a), (_, b) in zip(tree_leaves(other.trainable),
                              tree_leaves(tm.trainable)):
        assert torch.equal(a, b), n


def _write_safetensors(path, sd):
    from safetensors.numpy import save_file

    path.mkdir(parents=True)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))


def test_local_hf_checkpoints_are_converted(tmp_path):
    """With HF directories on disk the tower and the T5 come from them:
    the BLIP-2 tower reproduces HF's last_hidden_state (golden pack), the
    T5 its full logits, and the projector's t5_norm starts from the
    checkpoint's encoder final norm."""
    vit_sd = dict(np.load(GOLDENS / "blip2_vit_ckpt.npz"))
    t5_sd = dict(np.load(GOLDENS / "t5_ckpt.npz"))
    _write_safetensors(tmp_path / "blip2", {f"vision_model.{k}": v
                                            for k, v in vit_sd.items()})
    _write_safetensors(tmp_path / "t5", t5_sd)
    cfg = model_cfg(load_pretrained=True,
                    blip_pretrained_model_name_or_path=str(tmp_path / "blip2"),
                    text_pretrained_model_name_or_path=str(tmp_path / "t5"),
                    vision_config=dict(TINY_VIT, image_size=28))
    tm = tc.BlipVisionT5Decoder(cfg, device="cpu")
    vio, tio = np.load(GOLDENS / "blip2_vit_io.npz"), np.load(
        GOLDENS / "t5_io.npz")
    with torch.no_grad():
        hidden = tm.frozen["vision"](torch.from_numpy(
            vio["pixels"].transpose(0, 2, 3, 1)))
        logits = tm.frozen["t5"](
            input_ids=torch.from_numpy(tio["input_ids"]),
            attention_mask=torch.from_numpy(tio["attention_mask"]),
            decoder_input_ids=torch.from_numpy(tio["decoder_input_ids"]))
    np.testing.assert_allclose(hidden.numpy(), vio["last_hidden"], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(logits.numpy(), tio["logits"], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(
        tm.trainable["projector"]["t5_norm"]["weight"].numpy(),
        t5_sd["encoder.final_layer_norm.weight"])
    # the weight-only T5 quantizes the converted weights as JAX does
    from thinkdiff_tpu.models.convert import convert_t5
    from thinkdiff_tpu.ops.quant import quantize_tree

    q = tc.BlipVisionT5Decoder({**cfg, "quantize_frozen": "int8"},
                               device="cpu")
    want = quantize_tree(convert_t5(t5_sd), min_size=0)
    got = params_of(q.frozen["t5"])
    for path in (("decoder", "block_1", "ffn", "wo"), ("encoder", "block_0",
                                                      "self_attn", "q")):
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        np.testing.assert_array_equal(g["kernel_q"], np.asarray(w["kernel_q"]))
        np.testing.assert_allclose(g["kernel_scale"],
                                   np.asarray(w["kernel_scale"]), rtol=1e-7)


def test_train_step_launches_match_counted_calls(monkeypatch):
    """The flash forward and RMSNorm calls of one training step, counted
    at their call sites (ViT, T5, projector), equal clip_train_launches
    (its backward counts are the LVLM step's, held by that step's tests)."""
    from thinkdiff_torch.models import projector as proj_mod
    from thinkdiff_torch.models import t5 as t5_mod
    from thinkdiff_torch.models import vit as vit_mod

    calls = {"flash_attention_fwd": 0, "rmsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for mod in (vit_mod, t5_mod):
        monkeypatch.setattr(mod, "flash_attention", counted(
            "flash_attention_fwd", mod.flash_attention))
    for mod in (t5_mod, proj_mod):
        monkeypatch.setattr(mod, "rmsnorm", counted("rmsnorm", mod.rmsnorm))
    _, tm = same_models(seed=10)
    batch = caption_batch()
    _port_step(tm, batch)
    want = tc.clip_train_launches(tm, batch["labels"].shape[1])
    assert calls == {k: want[k] for k in calls}
    assert want["flash_attention_dq"] == want["flash_attention_dkv"] == 3
    full = tc.BlipVisionT5Decoder.__new__(tc.BlipVisionT5Decoder)
    from thinkdiff_torch.models.t5 import T5Config
    from thinkdiff_torch.models.vit import ViTConfig

    full.t5_cfg, full.vit_cfg = T5Config.flan_t5_xxl(), ViTConfig.blip2_vision()
    assert tc.clip_train_launches(full, 128) == {
        "flash_attention_fwd": 39 + 24 + 48, "flash_attention_dq": 47,
        "flash_attention_dkv": 47, "rmsnorm": 49 + 74}


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tc.BlipVisionT5Decoder(model_cfg())
    assert tc.BlipVisionT5Decoder(model_cfg(), device="cpu").device == \
        torch.device("cpu")
