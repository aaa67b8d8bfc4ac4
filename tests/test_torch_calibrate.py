"""Port parity: SmoothQuant calibration of the w8a8 frozen tower
(``ops/quant.py`` ``collect_act_stats`` / ``equalize_quantized_tree``,
``MllamaT5EmbedDecoder.calibrate_w8a8``) against the JAX package at tiny
geometry on the CPU, on the same bridged weights and seeded batches.

Tolerances, from four seeded draws of this file's models on the CPU.
The statistics are maxima of activations that passed through w8a8 layers,
where an f32 rounding difference upstream could move an int8 activation by
one quantum; measured within 1.0e-6 relative of JAX's: held at 1e-5. On
the SAME statistics both equalizers compute one f32 formula, where
``torch.pow`` and ``np.power`` may differ by an ulp and so flip an int8
weight at a rounding tie: the scales measured within 3.3e-7 relative (held
at 1e-6), and no int8 weight of the 32,768 differed (held at 0.1% of
them, each by one step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.models import aligner_lvlm as ta
from thinkdiff_torch.models.bridge import flatten, params_of
from thinkdiff_torch.ops import quant as tq
from thinkdiff_tpu.models.t5 import shift_right as jshift
from thinkdiff_tpu.ops import quant as jq
from tests.test_torch_aligner_train import _batch, _cfg, _models, _tensors

STATS_RTOL = 1e-5
SCALE_RTOL = 1e-6
Q_FLIP_SHARE = 1e-3


def _batches(seeds=(3, 5)):
    return [_batch("padded", s) for s in seeds]


def _jax_stats(jm, batches):
    stats = None
    for b in batches:
        proj = jm.project(jm.trainable, jnp.asarray(b["embeds"]))
        stats = jq.collect_act_stats(
            jm.t5, {"params": jm.frozen["t5"]},
            method=jm.t5.decode_with_encoder_states,
            decoder_input_ids=jshift(jnp.asarray(b["labels"])),
            encoder_states=proj, cross_mask=jnp.asarray(b["embed_mask"]),
            stats=stats)
    return {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, stats)).items()}


def _port_stats(tm, batches, stats=None):
    for b in batches:
        t = _tensors(b)
        proj = tm.project(tm.trainable, t["embeds"])
        stats = tq.collect_act_stats(
            tm.frozen["t5"], ta.shift_right(t["labels"]), proj,
            method="decode_with_encoder_states", cross_mask=t["embed_mask"],
            stats=stats)
    return stats


def test_collect_act_stats_matches_jax_and_folds_the_max():
    jm, tm = _models(True)
    batches = _batches()
    want = _jax_stats(jm, batches)
    got = {k: v.numpy() for k, v in flatten(_port_stats(tm, batches)).items()}
    # every w8a8 layer, fused nodes as one: qkv, q + kv_fused, wi_fused, o,
    # wo, and the lm_head
    assert sorted(got) == sorted(want)
    assert any(k.endswith("kv_fused/amax") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL,
                                   atol=1e-6, err_msg=k)
    one = [flatten(_port_stats(tm, [b])) for b in batches]
    folded = flatten(_port_stats(tm, batches[1:], _port_stats(tm, batches[:1])))
    for k in got:
        np.testing.assert_array_equal(
            folded[k].numpy(), torch.maximum(one[0][k], one[1][k]).numpy())
        np.testing.assert_array_equal(folded[k].numpy(), got[k])
    # the hooks are gone, and the forward is the layers' own
    assert all(not m._forward_pre_hooks
               for m in tq.w8a8_layers(tm.frozen["t5"]).values())


def _flip_share(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1
    return float((d > 0).mean())


def test_equalizer_matches_jax_on_the_same_stats():
    jm, tm = _models(True)
    stats_tree = jax.tree.map(np.asarray, jq.collect_act_stats(
        jm.t5, {"params": jm.frozen["t5"]},
        method=jm.t5.decode_with_encoder_states,
        decoder_input_ids=jshift(jnp.asarray(_batch("padded", 3)["labels"])),
        encoder_states=jm.project(jm.trainable, jnp.asarray(
            _batch("padded", 3)["embeds"]))))
    frozen = jax.tree.map(np.asarray, jm.frozen["t5"])
    want = flatten(jq.equalize_quantized_tree(frozen, stats_tree, 0.5))
    got = {k: np.asarray(v) for k, v in flatten(
        tq.equalize_quantized_tree(frozen, stats_tree, 0.5)).items()}
    assert sorted(got) == sorted(want)
    flips = []
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("kernel_q"):
            flips.append(_flip_share(got[k], w))
        else:
            np.testing.assert_allclose(got[k], w, rtol=SCALE_RTOL, err_msg=k)
    assert max(flips) <= Q_FLIP_SHARE, flips
    assert any(not np.allclose(v, 1) for k, v in got.items()
               if k.endswith("input_scale"))


def test_equalizer_rules_on_edge_channels():
    """amax_x <= 0 keeps s = 1; the scale is clipped to [1e-4, 1e4]; a
    stored input_scale composes; a node without stats passes through."""
    rs = np.random.RandomState(0)
    qw = tq.quantize_weight(rs.randn(4, 3).astype(np.float32))
    node = {"kernel_q": qw["q"], "kernel_scale": qw["scale"],
            "input_scale": torch.tensor([1.0, 2.0, 1.0, 1.0])}
    stats = {"a": {"amax": np.array([0.0, 1.0, 1e12, 1e-30], np.float32)}}
    out = tq.equalize_quantized_tree({"a": node, "b": dict(node)}, stats)
    w = qw["q"].float() * qw["scale"][None]
    amax_w = w.abs().amax(1)
    s = torch.tensor([1.0, float(1.0 / amax_w[1].sqrt()), 1e4, 1e-4])
    torch.testing.assert_close(out["a"]["input_scale"],
                               torch.tensor([1.0, 2.0, 1.0, 1.0]) * s)
    want = jq.equalize_quantized_tree(
        {"a": {k: np.asarray(v) for k, v in node.items()}}, stats)
    np.testing.assert_allclose(out["a"]["input_scale"].numpy(),
                               want["a"]["input_scale"], rtol=SCALE_RTOL)
    assert out["b"] is not node and out["b"]["input_scale"] is node[
        "input_scale"]


def test_calibrate_w8a8_end_to_end_matches_jax():
    """Both models calibrated on the same two batches: the loss before and
    after (rtol 2e-3, the w8a8 loss limit of test_torch_aligner_train),
    every input_scale (the maxima's tolerance), and the tower equalized in
    place on the port's side."""
    jm, tm = _models(True)
    batches = _batches()
    probe = _batch("padded", 7)
    jb = {k: jnp.asarray(v) for k, v in probe.items()}
    before = (float(jm.loss_fn(jm.trainable, jm.frozen, jb)),
              float(tm.loss_fn(tm.trainable, tm.frozen, _tensors(probe))))
    qkv = tm.frozen["t5"].decoder.block_0.self_attn.qkv
    storage = qkv.kernel_q.data_ptr()
    jm.calibrate_w8a8(batches)
    stats = tm.calibrate_w8a8(batches)
    assert qkv.kernel_q.data_ptr() == storage
    after = (float(jm.loss_fn(jm.trainable, jm.frozen, jb)),
             float(tm.loss_fn(tm.trainable, tm.frozen, _tensors(probe))))
    np.testing.assert_allclose(before[1], before[0], rtol=2e-3)
    np.testing.assert_allclose(after[1], after[0], rtol=2e-3)
    want = flatten(jax.tree.map(np.asarray, jm.frozen["t5"]))
    got = flatten(params_of(tm.frozen["t5"]))
    scales = [k for k in want if k.endswith("input_scale")]
    assert scales and sorted(flatten(stats)) == sorted(
        k[: -len("input_scale")] + "amax" for k in scales)
    for k in scales:
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL, err_msg=k)
        assert not np.allclose(got[k], 1.0), k


@pytest.mark.parametrize("quant", [None, "int8"])
def test_calibrate_refuses_a_tower_without_w8a8_layers(quant):
    cfg = _cfg(False)
    cfg["quantize_frozen"] = quant
    tm = ta.MllamaT5EmbedDecoder(cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="w8a8"):
        tm.calibrate_w8a8(_batches((3,)))


def test_quantize_like_follows_the_reference_structure():
    """Only the kernels that the reference tree declares as QDense triplets
    are quantized (int8 and w8a8), as JAX's quantize_like does; the other
    leaves pass through."""
    rs = np.random.RandomState(1)
    params = {"blk": {"kernel": rs.randn(8, 4).astype(np.float32),
                      "bias": rs.randn(4).astype(np.float32)},
              "emb": {"kernel": rs.randn(8, 4).astype(np.float32)},
              "w8": {"kernel": rs.randn(4, 6).astype(np.float32)}}
    ref = {"blk": {"kernel_q": 0, "kernel_scale": 0, "bias": 0},
           "emb": {"kernel": 0},
           "w8": {"kernel_q": 0, "kernel_scale": 0, "input_scale": 0}}
    got = flatten(tq.quantize_like(params, ref))
    want = flatten(jq.quantize_like(params, ref))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)
    deq = tq.dequantize_weight({"q": got["blk/kernel_q"],
                                "scale": got["blk/kernel_scale"]})
    want_deq = jq.dequantize_weight({"q": want["blk/kernel_q"],
                                     "scale": want["blk/kernel_scale"]})
    np.testing.assert_array_equal(deq.float().numpy(),
                                  np.asarray(want_deq, np.float32))
