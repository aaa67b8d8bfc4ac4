"""Sharded training (run.mesh with fsdp / model > 1) against JAX's
Trainer on the same mesh shape: the LVLM aligner (w8a8 and f32) and
ThinkDiff-CLIP, the seeded sharded build, and the model peers' loaders.
Ranks are gloo subprocesses of tests/_torch_dist_child.py, each reading
its (data, fsdp) coordinate's batch."""

import jax
import numpy as np
import pytest

from tests.test_torch_aligner_clip import caption_batch, same_models
from tests.test_torch_aligner_train import _cfg, _models
from tests.test_torch_distributed import (
    RUN_CFG, _port_inputs, concat, launch, lvlm_batches, start)
from thinkdiff_torch.models.bridge import flatten, params_of
from thinkdiff_torch.parallel import mesh as tmesh
from thinkdiff_tpu.engines.trainer import Trainer as JTrainer
from thinkdiff_tpu.parallel import mesh as jmesh


def _jax_run(jm, batches, shape):
    """JAX's Trainer on the (data, fsdp, model) mesh, fed the readers'
    batches concatenated in reader order (its batch sharding puts reader
    r's rows on the devices at coordinate r)."""
    d, f, m = shape
    jt = JTrainer(jm, RUN_CFG, mesh=jmesh.make_mesh(
        d, f, m, devices=jax.devices()[:d * f * m]))
    js = jt.init_state()
    losses, norms = [], []
    for step_batches in batches:
        js, met = jt.train_step(js, jt.prepare_batch(concat(step_batches)),
                                jax.random.PRNGKey(0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    from tests.test_torch_aligner_train import _flat

    return losses, norms, _flat(js["params"])


def _equal_rows(batches):
    """Each step's readers' batches cut to one row count and one label
    width, so that JAX can place their concatenation over (data, fsdp)."""
    out = []
    for step in batches:
        n = min(b["labels"].shape[0] for b in step)
        out.append([{k: v[:n] for k, v in b.items()} for b in step])
    return out


def _world1_eval(tm, eval_batches):
    """The port's eval pass at a world of one from the initial state, each
    batch the readers' batches concatenated."""
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.tasks.base_task import BaseTask

    trainer = Trainer(tm, dict(RUN_CFG), device="cpu")
    return BaseTask(device="cpu").evaluation(
        trainer, trainer.init_state(),
        iter([concat(list(b)) for b in zip(*eval_batches)]),
        best_metric="token_acc")


def _check_eval(outs, want, readers, tol):
    """Every rank's eval metrics the world-1 run's within ``tol`` relative,
    and the global sums of [2.5 x 4, 3, 4] from each reader (each model
    peer adding them too) those of ``readers`` readers."""
    for out in outs:
        got = out["result"]["eval"]
        for k in ("loss", "token_acc", "agg_metrics"):
            np.testing.assert_allclose(got["metrics"][k], want[k], rtol=tol,
                                       err_msg=k)
        assert got["stats"] == [2.5, 3.0 * readers, 4.0 * readers]


def _check(outs, want, tol):
    want_l, want_n, want_p = want
    tol_l, tol_n, tol_p = tol
    for out in outs:
        got = out["result"]
        np.testing.assert_allclose(got["losses"], want_l, rtol=tol_l)
        np.testing.assert_allclose(got["grad_norms"], want_n, rtol=tol_n)
        for path, w in want_p.items():
            np.testing.assert_allclose(got["params"][path], w, rtol=0,
                                       atol=tol_p, err_msg=path)
        # the tree gathered back from the blocks is the JAX tree
        assert got["same_tree"]
    # every rank holds one projector state, bit for bit
    first = outs[0]["result"]["params"]
    for out in outs[1:]:
        for path in first:
            assert np.array_equal(out["result"]["params"][path],
                                  first[path]), path


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 1, 2)], ids=str)
@pytest.mark.parametrize("quant", [False, True])
def test_lvlm_sharded_training_is_jax_s(tmp_path, shape, quant):
    """The LVLM aligner (fused T5, f32 or w8a8) trained 3 steps on a
    sharded mesh (packed and padded rows, warmup and cosine, the clip),
    rank 1.. starting from other parameters that init_state overwrites,
    against JAX's Trainer on the same mesh shape. Tolerances as the
    two-rank test's (tests/test_torch_distributed.py): f32 losses and
    grad_norm 1e-4 relative, parameters 1e-4; w8a8 2e-3, 5e-2, 2e-3. The
    model peers end bit-identical. An eval pass from the initial state
    gives the world-1 pass's loss and token accuracy on the readers'
    batches concatenated, within the loss limit."""
    d, f, m = shape
    readers = d * f
    batches = _equal_rows(lvlm_batches(3, world=max(readers, 2)))
    batches = [b[:readers] for b in batches]
    jm, tm = _models(quant)
    eval_batches = [[step[r] for step in batches[:2]] for r in range(readers)]
    ranks = start("sharded_trainer", tmp_path, _port_inputs(
        "lvlm", _cfg(quant), tm, batches=batches, mesh=shape,
        eval_batches=eval_batches), world=d * f * m)
    want_eval, want = _world1_eval(tm, eval_batches), _jax_run(
        jm, batches, shape)
    outs = ranks()
    tol = (2e-3, 5e-2, 2e-3) if quant else (1e-4, 1e-4, 1e-4)
    _check_eval(outs, want_eval, readers, tol[0])
    _check(outs, want, tol)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1)], ids=str)
def test_clip_sharded_training_is_jax_s(tmp_path, shape):
    """ThinkDiff-CLIP (ViT heads and MLP over model, T5 encoder and
    decoder, f32) 3 steps on a sharded mesh against JAX's Trainer on the
    same mesh shape: losses and grad_norm 1e-4 relative, parameters
    1e-4."""
    from tests.test_torch_aligner_clip import model_cfg

    d, f, m = shape
    jm, tm = same_models()
    batches = [[caption_batch(seed=10 * s + r) for r in range(d * f)]
               for s in range(3)]
    ranks = start("sharded_trainer", tmp_path, _port_inputs(
        "clip", model_cfg(), tm, batches=batches, mesh=shape),
        world=d * f * m)
    want = _jax_run(jm, batches, shape)
    _check(ranks(), want, (1e-4, 1e-4, 1e-4))


@pytest.mark.parametrize("arch,shape", [("lvlm", (1, 2, 2)),
                                        ("clip", (1, 1, 2))])
def test_a_sharded_build_draws_one_process_s_tree(tmp_path, arch, shape):
    """Built from its seed with the mesh set, every rank keeps its block
    of the tree one process draws: gathered, the trees are that process's
    bit for bit, and a rank holds less than the whole."""
    from tests.test_torch_aligner_clip import model_cfg
    from thinkdiff_torch.models import aligner_clip as tc
    from thinkdiff_torch.models import aligner_lvlm as ta

    cfg = _cfg(True) if arch == "lvlm" else model_cfg("int8_dyn")
    cls = ta.MllamaT5EmbedDecoder if arch == "lvlm" else tc.BlipVisionT5Decoder
    ranks = start("seeded_build", tmp_path, {"arch": arch, "cfg": cfg,
                                             "seed": 5, "mesh": shape},
                  world=int(np.prod(shape)))
    whole = cls(cfg, seed=5, device="cpu")
    outs = ranks()
    total = sum(t.numel() * t.element_size() for mod in whole.frozen.values()
                for t in [*mod.parameters(), *mod.buffers()])
    for out in outs:
        got = out["result"]
        assert got["held"] < total
        for name, mod in whole.frozen.items():
            want = flatten(params_of(mod))
            for path, v in flatten(got["trees"][name]).items():
                assert np.array_equal(np.asarray(v).view(np.uint8),
                                      np.asarray(want[path]).view(np.uint8)), \
                    path


@pytest.mark.parametrize("shape,rank", [((1, 1, 2), 0), ((1, 1, 2), 1),
                                        ((1, 2, 2), 2), ((1, 2, 2), 3)])
def test_model_peers_read_their_coordinate_s_batches(tmp_path, monkeypatch,
                                                     shape, rank):
    """A rank reads as JAX process (d * F + f) of D * F: the embed stream
    and the cc_sbu caption splits (drawn from the host generator, seeded
    with the reader's index) are its model peers' too."""
    from tests.test_torch_distributed import LOADERS

    monkeypatch.setattr(tmesh, "get_rank", lambda: rank)
    monkeypatch.setattr(tmesh, "get_world_size", lambda: int(np.prod(shape)))
    monkeypatch.setitem(tmesh._CURRENT, "mesh", tmesh.Mesh(*shape))
    reader, readers = tmesh.loader_rank(), tmesh.loader_world()
    assert (reader, readers) == (rank // shape[2], shape[0] * shape[1])
    for source in ("embed", "cc_sbu"):
        make, n = LOADERS[source]
        got_want = []
        for loader in make(tmp_path / source, reader, readers):
            it = iter(loader)
            got_want.append([next(it) for _ in range(n)])
            if hasattr(it, "close"):
                it.close()
        got, want = got_want
        for a, b in zip(got, want):
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_save_result_writes_one_file_a_reader(tmp_path):
    """On {data 1, fsdp 2, model 2} the two model peers of a (data, fsdp)
    reader hold the same results: each reader writes val_rank{reader}.json
    once (its first peer), and rank 0 merges the readers' files in order,
    dropping a repeated id."""
    import json

    per_reader = [[{"id": 1, "v": "a"}, {"id": 2, "v": "b"}],
                  [{"id": 2, "v": "c"}, {"id": 3, "v": "d"}]]
    results = [per_reader[r // 2] for r in range(4)]
    outs = launch("save_result", tmp_path, {
        "results": results, "result_dir": str(tmp_path / "res"),
        "mesh": (1, 2, 2)}, world=4)
    final = tmp_path / "res" / "val.json"
    assert [o["result"] for o in outs] == [str(final)] * 4
    assert sorted(p.name for p in (tmp_path / "res").iterdir()) == [
        "val.json", "val_rank0.json", "val_rank1.json"]
    assert json.loads(final.read_text()) == [
        {"id": 1, "v": "a"}, {"id": 2, "v": "b"}, {"id": 3, "v": "d"}]
