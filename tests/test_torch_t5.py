"""Port parity: the T5 decoder side (thinkdiff_torch.models.t5), the
projector and the chunked lm_head + CE against the JAX package, on the same
weights (bridged key for key) and seeded inputs, at tiny geometry on the
CPU (the kernels' plain versions)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinkdiff_torch.data.packing import pack_rows as t_pack_rows
from thinkdiff_torch.models import t5 as tt
from thinkdiff_torch.models.bridge import load_params, params_of
from thinkdiff_torch.models.projector import build_vision_projector
from thinkdiff_torch.ops import chunked_ce as tce
from thinkdiff_tpu.data.packing import pack_rows as j_pack_rows
from thinkdiff_tpu.models import t5 as jt
from thinkdiff_tpu.models.golden_pack import ATOL, RTOL, default_root
from thinkdiff_tpu.ops import chunked_ce as jce
from thinkdiff_tpu.ops.quant import quantize_tree

GOLDENS = default_root()


def _jax_t5(fused: bool, quant):
    """A tiny JAX T5 (encoder dropped) and its parameter tree: initialized
    unfused in f32, quantized (w8a8) and fused as the aligner does."""
    cfg = jt.T5Config.tiny(fused_proj=fused, quant_int8=quant)
    ids = jnp.zeros((1, 4), jnp.int32)
    fp = jt.T5ForConditionalGeneration(dataclasses.replace(
        cfg, quant_int8=False, fused_proj=False))
    params = jax.tree.map(np.asarray, fp.init(
        {"params": jax.random.PRNGKey(0)}, input_ids=ids,
        decoder_input_ids=ids)["params"])
    params.pop("encoder")
    if quant:
        params = quantize_tree(params, min_size=0, w8a8=True)
    if fused:
        params = jt.fuse_t5_params(params)
    return jt.T5ForConditionalGeneration(cfg), params


def _port_t5(fused: bool, quant, params):
    m = tt.T5ForConditionalGeneration(
        tt.T5Config.tiny(fused_proj=fused, quant_int8=quant))
    return load_params(m, params)


def _samples(rs, n, d=32, vocab=128):
    return [{"embeds": rs.randn(rs.randint(2, 9), d).astype(np.float32),
             "label_ids": rs.randint(1, vocab, (rs.randint(2, 10),)
                                     ).astype(np.int32)} for _ in range(n)]


def _batch(layout: str):
    rs = np.random.RandomState(11)
    if layout == "packed":
        return j_pack_rows(_samples(rs, 6), enc_cap=20, dec_cap=24,
                           row_bucket=2)
    enc = rs.randn(2, 7, 32).astype(np.float32)
    labels = rs.randint(1, 128, (2, 9)).astype(np.int32)
    labels[1, 6:] = -100
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    return {"embeds": enc, "embed_mask": mask, "labels": labels,
            "decoder_input_ids": np.asarray(jt.shift_right(labels))}


@pytest.mark.parametrize("bidirectional", [False, True])
def test_relative_position_bucket_table_identical(bidirectional):
    """The float32 log and truncation put the bucket edges where JAX puts
    them, for every offset of sequences up to 512."""
    rel = np.arange(512)[None] - np.arange(512)[:, None]
    want = np.asarray(jt.relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, 32, 128))
    got = tt.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                      32, 128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quant", [False, "w8a8"])
def test_decoder_hidden_logits_and_loss_match_jax(quant, fused, layout):
    jm, params = _jax_t5(fused, quant)
    tm = _port_t5(fused, quant, params)
    b = _batch(layout)
    kw = dict(cross_mask=b["embed_mask"], decoder_segments=b.get("dec_segments"),
              encoder_segments=b.get("enc_segments"))
    want = np.asarray(jm.apply(
        {"params": params}, method=jm.decode_hidden,
        decoder_input_ids=jnp.asarray(b["decoder_input_ids"]),
        encoder_states=jnp.asarray(b["embeds"]),
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tm.decode_hidden(
            torch.from_numpy(b["decoder_input_ids"]),
            torch.from_numpy(b["embeds"]),
            **{k: None if v is None else torch.from_numpy(v)
               for k, v in kw.items()})
        logits = tm.logits(got)
        loss = tt.cross_entropy_loss(logits, torch.from_numpy(b["labels"]))
    want_logits = np.asarray(jce.apply_lm_head(
        jnp.asarray(want), params["lm_head"], jnp.float32))
    want_loss = float(jt.cross_entropy_loss(jnp.asarray(want_logits),
                                            jnp.asarray(b["labels"])))
    # f32 both sides, summation order only: 2e-5. w8a8: per-row int8
    # activations, where an f32 rounding difference before the absmax
    # quantization can move an element one quantum (1/127 of its row's
    # max) through two layers: 2e-3.
    tol = 2e-3 if quant else 2e-5
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=tol, rtol=tol)
    np.testing.assert_allclose(float(loss), want_loss, rtol=tol)


def test_packed_decoder_inputs_are_per_segment():
    """The port's packer builds each segment's decoder inputs itself; a
    global shift_right of the packed labels differs at every segment start
    after the first."""
    rs = np.random.RandomState(2)
    samples = _samples(rs, 6)
    got = t_pack_rows(samples, enc_cap=20, dec_cap=24, row_bucket=2)
    want = j_pack_rows(samples, enc_cap=20, dec_cap=24, row_bucket=2)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    shifted = tt.shift_right(torch.from_numpy(got["labels"])).numpy()
    seg = got["dec_segments"]
    starts = (seg[:, 1:] != seg[:, :-1]) & (seg[:, 1:] > 0)
    assert starts.any()
    assert (shifted[:, 1:][starts] != got["decoder_input_ids"][:, 1:][starts]).all()


def test_shift_right_and_ce_stats_match_jax():
    rs = np.random.RandomState(4)
    labels = rs.randint(0, 50, (3, 8)).astype(np.int32)
    labels[0, 5:] = -100
    logits = rs.randn(3, 8, 50).astype(np.float32)
    np.testing.assert_array_equal(
        tt.shift_right(torch.from_numpy(labels)).numpy(),
        np.asarray(jt.shift_right(jnp.asarray(labels))))
    got = [float(x) for x in tt.ce_stats(torch.from_numpy(logits),
                                         torch.from_numpy(labels))]
    want = [float(x) for x in jt.ce_stats(jnp.asarray(logits),
                                          jnp.asarray(labels))]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fuse_t5_params_identical_to_jax():
    _, params = _jax_t5(False, "w8a8")
    got = tt.fuse_t5_params(params)
    want = jt.fuse_t5_params(params)
    flat = lambda t: {"/".join(map(str, k)): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert set(flat(got)) == set(flat(want))
    for k, v in flat(want).items():
        np.testing.assert_array_equal(np.asarray(flat(got)[k]), np.asarray(v))


def test_bridge_round_trip_is_exact():
    _, params = _jax_t5(True, "w8a8")
    tm = _port_t5(True, "w8a8", params)
    back = params_of(tm)
    flat = lambda t: {"/".join(map(str, k)): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the training copy of every w8a8 kernel is its (K, N) row-major twin
    layer = tm.decoder.block_0.ffn.wo
    assert layer.kernel_q_kn.is_contiguous()
    assert torch.equal(layer.kernel_q_kn, layer.kernel_q)


def test_golden_encoderless_logits():
    """HF flan-t5 (tiny) converted by the JAX package's convert_t5 and
    bridged: the port's encoder-less decode reproduces HF's logits."""
    from thinkdiff_tpu.models.convert import convert_t5

    sd = dict(np.load(GOLDENS / "t5_ckpt.npz"))
    io = np.load(GOLDENS / "t5_io.npz")
    params = jax.tree.map(np.asarray, convert_t5(sd))
    params.pop("encoder")
    tm = load_params(tt.T5ForConditionalGeneration(tt.T5Config.tiny()), params)
    with torch.no_grad():
        got = tm.decode_with_encoder_states(
            torch.from_numpy(io["decoder_input_ids2"]),
            torch.from_numpy(io["encoder_states"])).numpy()
    np.testing.assert_allclose(got, io["logits2"], atol=ATOL, rtol=RTOL)


def _projector_params():
    sd = np.load(GOLDENS / "projector_ckpt.npz")
    return {"layer_0": {"kernel": sd["mm_projector.0.weight"].T.copy(),
                        "bias": sd["mm_projector.0.bias"]},
            "layer_1": {"kernel": sd["mm_projector.2.weight"].T.copy(),
                        "bias": sd["mm_projector.2.bias"]},
            "t5_norm": {"weight": sd["mm_projector.3.weight"]}}


def test_projector_golden_forward_and_grads_match_jax():
    """mlp2x_gelu_t5_norm against the reference's output (golden) and the
    JAX module's forward and parameter gradients (f32)."""
    from thinkdiff_tpu.models.projector import build_vision_projector as jbuild

    io = np.load(GOLDENS / "projector_io.npz")
    params = _projector_params()
    proj = build_vision_projector("mlp2x_gelu_t5_norm", 32)
    tparams = {k: {n: torch.tensor(v, requires_grad=True) for n, v in d.items()}
               for k, d in params.items()}
    out = proj(tparams, torch.from_numpy(io["x"]))
    np.testing.assert_allclose(out.detach().numpy(), io["out"], atol=ATOL,
                               rtol=RTOL)
    w = np.random.RandomState(0).randn(*io["out"].shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    jproj = jbuild("mlp2x_gelu_t5_norm", out_dim=32)
    jgrads = jax.grad(lambda p: jnp.sum(jproj.apply(
        {"params": p}, jnp.asarray(io["x"])) * w))(
        jax.tree.map(jnp.asarray, params))
    for k, d in params.items():
        for n in d:
            np.testing.assert_allclose(tparams[k][n].grad.numpy(),
                                       np.asarray(jgrads[k][n]),
                                       atol=1e-5, rtol=1e-4, err_msg=f"{k}/{n}")


@pytest.mark.parametrize("quant", [False, "w8a8"])
def test_chunked_ce_matches_monolithic_and_jax(quant):
    """Chunked head + CE equals the full-logits loss (chunk 4 over T = 10,
    so the last chunk is padded), and its hidden-state gradient too; the
    loss equals the JAX chunked loss."""
    jm, params = _jax_t5(True, quant)
    tm = _port_t5(True, quant, params)
    rs = np.random.RandomState(6)
    hidden = rs.randn(2, 10, 32).astype(np.float32)
    labels = rs.randint(0, 128, (2, 10)).astype(np.int32)
    labels[1, 7:] = -100
    h1 = torch.tensor(hidden, requires_grad=True)
    h2 = torch.tensor(hidden, requires_grad=True)
    y = torch.from_numpy(labels)
    chunked = tce.chunked_head_cross_entropy(h1, y, tm.lm_head, torch.float32, 4)
    full = tt.cross_entropy_loss(tm.lm_head(h2), y)
    chunked.backward()
    full.backward()
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)
    np.testing.assert_allclose(h1.grad.numpy(), h2.grad.numpy(), atol=1e-7,
                               rtol=1e-5)
    want = float(jce.chunked_head_cross_entropy(
        jnp.asarray(hidden), jnp.asarray(labels), params["lm_head"],
        dtype=jnp.float32, chunk=4))
    np.testing.assert_allclose(float(chunked), want, rtol=2e-5)
    loss, hit, count = tce.chunked_head_ce_stats(h1.detach(), y, tm.lm_head,
                                                 torch.float32, 4)
    jloss, jhit, jcount = jce.chunked_head_ce_stats(
        jnp.asarray(hidden), jnp.asarray(labels), params["lm_head"],
        dtype=jnp.float32, chunk=4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    assert (float(hit), float(count)) == (float(jhit), float(jcount))
