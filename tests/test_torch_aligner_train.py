"""Port parity: the LVLM aligner's training step (MllamaT5EmbedDecoder
.loss_fn, the optimizer, the Trainer) against the JAX package on the same
bridged weights and seeded batches, at tiny geometry on the CPU (the
kernels' plain versions)."""

from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import thinkdiff_torch
from thinkdiff_torch.core import optim as to
from thinkdiff_torch.engines.trainer import Trainer as TTrainer
from thinkdiff_torch.models import aligner_lvlm as ta
from thinkdiff_torch.models.bridge import load_params, to_tensor
from thinkdiff_tpu.core import optim as jo
from thinkdiff_tpu.core.config import ConfigNode
from thinkdiff_tpu.data.packing import pack_rows
from thinkdiff_tpu.engines.trainer import Trainer as JTrainer
from thinkdiff_tpu.models.aligner_lvlm import MllamaT5EmbedDecoder as JModel
from thinkdiff_tpu.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]
D_VLM = 16


def _cfg(quant, chunk=8):
    return {"dtype": "float32", "load_pretrained": False,
            "quantize_frozen": "int8_dyn" if quant else None,
            "chunked_ce": chunk, "mm_projector_type": "mlp2x_gelu_t5_norm",
            "vlm_hidden_size": D_VLM,
            "t5_config": dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                              num_layers=1, num_decoder_layers=2,
                              num_heads=4, fused_proj=True)}


def _models(quant, chunk=8):
    """The JAX model and the port's, with the JAX weights bridged in."""
    jm = JModel(ConfigNode(_cfg(quant, chunk)), seed=0)
    tm = ta.MllamaT5EmbedDecoder(_cfg(quant, chunk), seed=1, device="cpu")
    load_params(tm.frozen["t5"], jax.tree.map(np.asarray, jm.frozen["t5"]))
    tm.load_trainable(jax.tree.map(np.asarray, jm.trainable_params()))
    return jm, tm


def _samples(rs, n, vocab=128):
    return [{"embeds": rs.randn(rs.randint(2, 9), D_VLM).astype(np.float32),
             "label_ids": rs.randint(1, vocab, (rs.randint(2, 12),)
                                     ).astype(np.int32)} for _ in range(n)]


def _batch(layout, seed):
    rs = np.random.RandomState(seed)
    if layout == "packed":
        return pack_rows(_samples(rs, 6), enc_cap=20, dec_cap=24, row_bucket=2)
    labels = rs.randint(1, 128, (3, 10)).astype(np.int32)
    labels[1, 6:] = -100
    mask = np.ones((3, 8), np.int32)
    mask[2, 3:] = 0
    return {"embeds": rs.randn(3, 8, D_VLM).astype(np.float32),
            "embed_mask": mask, "labels": labels}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("quant", [False, True])
def test_loss_and_projector_grads_match_jax(quant, layout):
    """f32: summation order only (loss 1e-5, gradients 1e-4 of their
    largest element). w8a8: the int8 activations of two layers, each
    element of which an f32 rounding difference can move by one quantum
    (1/127 of its row's max), in the forward and again in the requantized
    backward: loss 2e-3, gradients 5e-2 of their largest element."""
    jm, tm = _models(quant)
    b = _batch(layout, 3)
    jl, jg = jax.jit(jax.value_and_grad(lambda tr, fz, bt: jm.loss_fn(
        tr, fz, bt)))(jm.trainable_params(), jm.frozen,
                      {k: jnp.asarray(v) for k, v in b.items()})
    params = to.tree_map(lambda x: x.clone().requires_grad_(True),
                         tm.trainable_params())
    loss = tm.loss_fn(params, tm.frozen, _tensors(b))
    loss.backward()
    tol_l, tol_g = (2e-3, 5e-2) if quant else (1e-5, 1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=tol_l)
    got = {p: t.grad.numpy() for p, t in to.tree_leaves(params)}
    for path, want in _flat(jg).items():
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=tol_g * np.abs(want).max(),
                                   err_msg=path)


def test_eval_metrics_match_jax():
    jm, tm = _models(False)
    b = _batch("packed", 4)
    want = [float(x) for x in jm.eval_metrics_fn(
        jm.trainable_params(), jm.frozen,
        {k: jnp.asarray(v) for k, v in b.items()})]
    got = [float(x) for x in tm.eval_metrics_fn(
        tm.trainable_params(), tm.frozen, _tensors(b))]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _run_both(quant, run_cfg, steps=5):
    jm, tm = _models(quant)
    jt = JTrainer(jm, run_cfg, mesh=make_mesh(devices=jax.devices()[:1]))
    tt = TTrainer(tm, run_cfg, device="cpu")
    js, ts = jt.init_state(), tt.init_state()
    batches = [_batch("packed", 5), _batch("padded", 6)]
    jloss, tloss, lrs = [], [], []
    for i in range(steps):
        b = batches[i % 2]
        js, jmet = jt.train_step(js, jt.prepare_batch(b), jax.random.PRNGKey(0))
        ts, tmet = tt.train_step(ts, tt.prepare_batch(b))
        jloss.append(float(jmet["loss"]))
        tloss.append(float(tmet["loss"]))
        lrs.append((float(jmet["lr"]), tmet["lr"]))
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=5e-2 if quant else 1e-4)
    return js, ts, jloss, tloss, lrs


@pytest.mark.parametrize("quant", [False, True])
def test_trainer_trajectory_matches_jax(quant):
    """Five steps at warmup_steps 2 (both schedule branches), AdamW with
    weight decay on the kernels. f32: losses within 1e-4, the lr of every
    step equal, the parameters after five steps within a tenth of one
    step's size (the Adam update is normalized, so an element with a tiny
    gradient may step either way). w8a8: losses within 2e-3 (the
    quantization of the forward, as in the loss test), parameters within
    two steps of the lr."""
    run_cfg = {"lr_sched": "linear_warmup_cosine_lr", "init_lr": 1e-3,
               "min_lr": 1e-4, "warmup_lr": 1e-4, "warmup_steps": 2,
               "max_epoch": 1, "iters_per_epoch": 5, "weight_decay": 0.05}
    js, ts, jloss, tloss, lrs = _run_both(quant, run_cfg)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-3 if quant else 1e-4)
    for jlr, tlr in lrs:
        np.testing.assert_allclose(tlr, jlr, rtol=1e-6)
    assert lrs[0][1] == pytest.approx(1e-4)   # step 0 reads warmup_lr
    got = {p: t.numpy() for p, t in to.tree_leaves(ts["params"])}
    tol = 2e-3 if quant else 1e-4
    for path, want in _flat(js["params"]).items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=tol,
                                   err_msg=path)
    assert ts["step"] == 5 and ts["opt_state"]["count"] == 5


def test_adamw_clip_and_accumulation_match_optax():
    """AdamW's update, with the global-norm clip and accum_grad_iters 2,
    against optax on one tree of random gradients: same parameters after
    four micro-steps (two updates), same masks."""
    rs = np.random.RandomState(7)
    tree = {"projector": {"layer_0": {"kernel": rs.randn(4, 3), "bias":
                                      rs.randn(3)},
                          "t5_norm": {"weight": rs.randn(3)}}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    run_cfg = {"init_lr": 1e-2, "warmup_lr": 1e-3, "warmup_steps": 3,
               "max_epoch": 1, "iters_per_epoch": 8, "weight_decay": 0.05,
               "use_clip_grad_norm": True, "max_grad_norm": 0.5,
               "accum_grad_iters": 2}
    assert _flat(to.weight_decay_mask(tree)) == _flat(jo.weight_decay_mask(tree))
    tx, sched = jo.make_optimizer(run_cfg, tree)
    ttx, tsched = to.make_optimizer(run_cfg, tree)
    for s in range(10):  # JAX evaluates the schedule in f32
        assert tsched(s) == pytest.approx(float(sched(s)), rel=1e-5)
    jp, jstate = tree, tx.init(tree)
    tp = to.tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    tstate = ttx.init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: (rs.randn(*a.shape) * 3).astype(np.float32),
                         tree)
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update(to.tree_map(torch.from_numpy, g), tstate, tp)
    got = {p: t.numpy() for p, t in to.tree_leaves(tp)}
    for path, want in _flat(jp).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=path)
    assert tstate["count"] == 2


def test_step_launches_match_the_wrapper_calls():
    """On the CPU every kernel wrapper takes its plain path, so counting the
    wrapper calls of one training step counts what the card launches: the
    flash forward and its backward, the s8 GEMM and its input gradient, the
    RMSNorm forward. The counts equal ``step_launches`` of the config."""
    from thinkdiff_torch.ops import flash_attention as tf
    from thinkdiff_torch.ops import norms as tn
    from thinkdiff_torch.ops import quant as tq

    _, tm = _models(True, chunk=8)
    tt = TTrainer(tm, {"warmup_steps": 0}, device="cpu")
    state = tt.init_state()
    b = tt.prepare_batch(_batch("packed", 8))
    calls = {}

    def counted(name, fn):
        def wrap(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrap

    bwd = tf.flash_attention_backward
    with mock.patch.object(tf, "_forward", counted("flash_attention_fwd",
                                                   tf._forward)), \
            mock.patch.object(tf, "flash_attention_backward",
                              counted("flash_attention_dq", bwd)), \
            mock.patch.object(tq, "s8_matmul", counted("s8_matmul",
                                                       tq.s8_matmul)), \
            mock.patch.object(tq, "s8_matmul_bwd", counted(
                "s8_matmul_bwd", tq.s8_matmul_bwd)), \
            mock.patch.object(tn, "_rmsnorm_forward", counted(
                "rmsnorm", tn._rmsnorm_forward)):
        tt.train_step(state, b)
    calls["flash_attention_dkv"] = calls["flash_attention_dq"]
    want = ta.step_launches(tm.t5_cfg, b["labels"].shape[1], 8)
    assert calls == want


def test_shipped_config_builds_as_written():
    """configs/train_thinkdiff_lvlm_ccsbu.yaml's model section, unmodified
    except for a tiny T5 geometry and VLM width (the full xxl tower does not
    belong on a test's CPU), builds the port's model: bf16, unquantized
    unfused T5, mlp2x_gelu_t5_norm, the default CE chunk of 32; its run
    section builds the optimizer (warmup-cosine, decay masked off the
    norm and biases)."""
    doc = yaml.safe_load((REPO / "configs/train_thinkdiff_lvlm_ccsbu.yaml"
                          ).read_text())
    cfg = dict(doc["model"])
    cls = thinkdiff_torch.registry.get_model_class(cfg["arch"])
    assert cls is ta.MllamaT5EmbedDecoder
    cfg.update(vlm_hidden_size=D_VLM, t5_config=dict(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_decoder_layers=2,
        num_heads=4))
    m = cls(cfg, device="cpu")
    assert m.dtype == torch.bfloat16 and not m.quantize_frozen
    assert m.t5_cfg.quant_int8 is False and not m.t5_cfg.fused_proj
    assert int(m.cfg.get("chunked_ce", 32) or 0) == 32
    assert set(m.trainable["projector"]) == {"layer_0", "layer_1", "t5_norm"}
    assert m.vlm_hidden == D_VLM
    run = doc["run"]
    tr = TTrainer(m, run, device="cpu")
    # PyYAML reads 1e-4 (no dot) as a string; the port's schedule takes
    # float() of each value, the JAX one is given the numbers
    jsched = jo.make_schedule_from_config({
        k: float(run[k]) for k in ("init_lr", "min_lr", "warmup_lr",
                                   "warmup_steps", "max_epoch",
                                   "iters_per_epoch")})
    for step in (0, 1000, 1999, 2000, 100_000, 200_000):
        assert tr.schedule(step) == pytest.approx(float(jsched(step)),
                                                  rel=1e-5)
    assert tr.schedule(0) == pytest.approx(float(run["warmup_lr"]))
    mask = tr.tx.mask["projector"]
    assert mask["layer_0"] == {"kernel": True, "bias": False}
    assert mask["t5_norm"] == {"weight": False}
    state = tr.init_state()
    b = tr.prepare_batch(_batch("padded", 9))
    state, met = tr.train_step(state, b)
    assert np.isfinite(float(met["loss"])) and state["step"] == 1


def test_bench_batches_identical_to_bench_py():
    """The port's copies of bench.py's padded and packed batch functions
    give the same batches from the same seed."""
    import bench
    from thinkdiff_torch.data import synthetic

    a = bench.build_batches(np.random.RandomState(0), 3, 4, 8, 50)
    b = synthetic.build_batches(np.random.RandomState(0), 3, 4, 8, 50)
    (c, nc) = bench.build_batches_packed(np.random.RandomState(1), 2, 2, 256,
                                         256, 8, 50)
    (d, nd) = synthetic.build_batches_packed(np.random.RandomState(1), 2, 2,
                                             256, 256, 8, 50)
    assert nc == nd
    for x, y in zip(a + c, b + d):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_input_dropout_draws_from_the_generator():
    """mllama_output_embeddings_drop_rate: the projector's input dropout
    draws from the given torch.Generator (the same seed, the same mask),
    scales the kept embeds by 1/(1-p), and is off without a generator (the
    eval path). The trainer seeds it from rng and the step."""
    cfg = dict(_cfg(False), mllama_output_embeddings_drop_rate=0.5)
    cfg["mm_projector_type"] = "identity"
    cfg["t5_config"] = dict(cfg["t5_config"], d_model=D_VLM)
    tm = ta.MllamaT5EmbedDecoder(cfg, device="cpu")
    x = torch.ones(2, 64, D_VLM)
    a, b = (tm.project({"projector": {}}, x, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.3 < float((a == 0).float().mean()) < 0.7
    assert torch.equal(tm.project({"projector": {}}, x, None), x)
    tr = TTrainer(tm, {}, device="cpu")
    assert tr._generator(None, 0) is None
    g1, g2 = tr._generator(7, 1), tr._generator(7, 2)
    assert not torch.equal(torch.rand(8, generator=g1),
                           torch.rand(8, generator=g2))


def test_trainable_and_frozen_trees_round_trip():
    """load_trainable / export_trainable and the frozen tower's
    load_params / params_of are exact inverses on the JAX trees."""
    from thinkdiff_torch.models.bridge import params_of

    jm, tm = _models(True)
    tree = jax.tree.map(lambda t: np.asarray(t) * 2, tm.export_trainable())
    tm.load_trainable(tree)
    back = tm.export_trainable()
    for path, want in _flat(tree).items():
        got = _flat(back)[path]
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    assert to_tensor(_flat(back)["projector/layer_0/kernel"]).dtype == \
        torch.float32
    frozen = _flat(params_of(tm.frozen["t5"]))
    for path, want in _flat(jm.frozen["t5"]).items():
        assert np.array_equal(frozen[path], np.asarray(want)), path
