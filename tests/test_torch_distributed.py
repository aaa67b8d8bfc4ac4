"""The port over several ranks (thinkdiff_torch.core.distributed,
parallel/mesh.py, the Trainer's global token mean, the task's evaluation
and save_result), on the CPU over gloo, against the JAX package on one
device fed the concatenation of the ranks' batches: what GSPMD computes
over JAX's ``data`` axis. Each rank is a subprocess
(tests/_torch_dist_child.py) with its own free port and a timeout, so a
collective out of step fails one test in seconds."""

import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_aligner_clip import caption_batch, same_models
from tests.test_torch_aligner_train import D_VLM, _flat, _models, _samples
from thinkdiff_torch.core import distributed as td
from thinkdiff_torch.models.bridge import params_of
from thinkdiff_torch.parallel import mesh as tmesh
from thinkdiff_tpu.data.packing import pack_rows
from thinkdiff_tpu.engines.trainer import Trainer as JTrainer
from thinkdiff_tpu.parallel import mesh as jmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_dist_child.py")
TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode, work, inp, world=2, env=None):
    """``world`` ranks of the child in MODE on ``inp``: their outputs, in
    rank order. Every rank must exit 0 within TIMEOUT seconds."""
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    port = str(free_port())
    procs = []
    for rank in range(world):
        child_env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                         LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                         LOCAL_WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                         OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, mode, str(work)], env=child_env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errors.append(f"rank {rank} exit {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    outs = []
    for rank in range(world):
        with open(work / f"out_rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# -- the batches: each rank's label count differs -------------------------

def _padded(seed, cut):
    """A padded LVLM batch whose rows keep ``cut[i]`` labels."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(1, 128, (3, 10)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    for i, c in enumerate(cut):
        labels[i, c:] = -100
    mask[2, 3 + seed % 4:] = 0
    return {"embeds": rs.randn(3, 8, D_VLM).astype(np.float32),
            "embed_mask": mask, "labels": labels}


def _packed(seed, n):
    rs = np.random.RandomState(seed)
    return pack_rows(_samples(rs, n), enc_cap=20, dec_cap=24, row_bucket=2)


def lvlm_batches(steps, world=2):
    """[step][rank] batches: packed rows (a different number of samples
    per rank) and padded rows (different label tails per rank), in
    turn."""
    cuts = ([10, 8, 9], [2, 1, 3], [5, 4, 6])
    out = []
    for s in range(steps):
        if s % 2:
            out.append([_padded(10 * s + r, cuts[r]) for r in range(world)])
        else:
            out.append([_packed(10 * s + r, 6 - 4 * r + 2 * (r > 1))
                        for r in range(world)])
    return out


def concat(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def label_counts(step_batches):
    return [int((b["labels"] != -100).sum()) for b in step_batches]


RUN_CFG = {"lr_sched": "linear_warmup_cosine_lr", "init_lr": 1e-3,
           "min_lr": 1e-4, "warmup_lr": 1e-4, "warmup_steps": 2,
           "max_epoch": 1, "iters_per_epoch": 4, "weight_decay": 0.05,
           "use_clip_grad_norm": True, "max_grad_norm": 50.0}


def _jax_run(jm, batches):
    jt = JTrainer(jm, RUN_CFG, mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state()
    losses, norms, lrs = [], [], []
    for step_batches in batches:
        js, met = jt.train_step(js, jt.prepare_batch(concat(step_batches)),
                                jax.random.PRNGKey(0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        lrs.append(float(met["lr"]))
    return losses, norms, lrs, _flat(js["params"])


def _port_inputs(arch, cfg, tm, **extra):
    return {"arch": arch, "cfg": cfg, "run_cfg": RUN_CFG,
            "frozen": {k: params_of(m) for k, m in tm.frozen.items()},
            "trainable": tm.export_trainable(), **extra}


@pytest.mark.parametrize("quant", [False, True])
def test_two_ranks_train_the_global_token_mean_like_jax(tmp_path, quant):
    """Two gloo ranks of the port's Trainer, each on its own batch, against
    JAX's Trainer on one device fed both batches concatenated: 4 steps
    (packed and padded rows, warmup and cosine, the global-norm clip),
    rank 1 starting from other parameters that init_state overwrites.
    Tolerances as test_trainer_trajectory_matches_jax's: f32 losses and
    grad_norm 1e-4 relative, parameters 1e-4; w8a8 2e-3, 5e-2, 2e-3."""
    from tests.test_torch_aligner_train import _cfg

    batches = lvlm_batches(4)
    assert all(len(set(label_counts(b))) == 2 for b in batches)
    jm, tm = _models(quant)
    outs = launch("trainer", tmp_path, _port_inputs(
        "lvlm", _cfg(quant), tm, batches=batches))
    want_l, want_n, want_lr, want_p = _jax_run(jm, batches)
    tol_l, tol_n, tol_p = (2e-3, 5e-2, 2e-3) if quant else (1e-4, 1e-4, 1e-4)
    for out in outs:
        got = out["result"]
        assert out["backend"] == "gloo" and out["run_cfg"]["distributed"]
        np.testing.assert_allclose(got["losses"], want_l, rtol=tol_l)
        np.testing.assert_allclose(got["grad_norms"], want_n, rtol=tol_n)
        np.testing.assert_allclose(got["lrs"], want_lr, rtol=1e-6)
        for path, want in want_p.items():
            np.testing.assert_allclose(got["params"][path], want, rtol=0,
                                       atol=tol_p, err_msg=path)
    # the replicas hold one state
    a, b = (o["result"] for o in outs)
    assert a["losses"] == b["losses"] and a["count"] == b["count"] == 4
    for path in a["params"]:
        assert np.array_equal(a["params"][path], b["params"][path]), path


def test_two_ranks_train_the_clip_aligner_like_jax(tmp_path):
    """BlipVisionT5Decoder's caption-split loss at two ranks (f32) against
    JAX on the concatenated batch: losses and grad_norm 1e-4 relative,
    parameters 1e-4."""
    from tests.test_torch_aligner_clip import model_cfg

    jm, tm = same_models()
    batches = []
    for s in range(3):
        pair = [caption_batch(seed=10 * s + r) for r in range(2)]
        pair[1]["labels"][1, 2 + s:] = -100
        batches.append(pair)
    assert all(len(set(label_counts(b))) == 2 for b in batches)
    outs = launch("trainer", tmp_path, _port_inputs(
        "clip", model_cfg(), tm, batches=batches))
    want_l, want_n, want_lr, want_p = _jax_run(jm, batches)
    for out in outs:
        got = out["result"]
        np.testing.assert_allclose(got["losses"], want_l, rtol=1e-4)
        np.testing.assert_allclose(got["grad_norms"], want_n, rtol=1e-4)
        np.testing.assert_allclose(got["lrs"], want_lr, rtol=1e-6)
        for path, want in want_p.items():
            np.testing.assert_allclose(got["params"][path], want, rtol=0,
                                       atol=1e-4, err_msg=path)


@pytest.mark.parametrize("group", ["no process group", "a group of one"])
def test_a_world_of_one_is_the_single_card_step_bit_for_bit(tmp_path, group):
    """WORLD_SIZE 1 through init_distributed_mode (with no process group,
    or with one the caller made) trains bit for bit as the Trainer in a
    process that never joined a world."""
    from tests.test_torch_aligner_train import _cfg
    from thinkdiff_torch.core.optim import tree_leaves
    from thinkdiff_torch.engines.trainer import Trainer

    batches = lvlm_batches(3, world=1)
    _, tm = _models(False)
    inp = _port_inputs("lvlm", _cfg(False), tm, batches=batches,
                       group_of_one=group == "a group of one")
    out = launch("trainer", tmp_path, inp, world=1)[0]
    assert out["run_cfg"] == {"rank": 0, "world_size": 1,
                              "distributed": False}
    assert (out["backend"] == "gloo") == inp["group_of_one"]
    tr = Trainer(tm, RUN_CFG, device="cpu")
    state = tr.init_state()
    losses = []
    for (b,) in batches:
        state, m = tr.train_step(state, tr.prepare_batch(b))
        losses.append(float(m["loss"]))
    assert out["result"]["losses"] == losses
    for path, t in tree_leaves(state["params"]):
        assert np.array_equal(out["result"]["params"][path], t.numpy()), path


@pytest.mark.parametrize("metric", ["loss", "token_acc"])
def test_evaluation_reduces_over_ranks_with_unequal_batch_counts(tmp_path,
                                                                 metric):
    """Rank 0 has three eval batches, rank 1 two: both ranks run two (the
    smaller count, agreed batch by batch: no rank waits in a collective
    the other never calls) and return the same metrics, each batch's loss
    the token mean of both ranks' rows and token_acc from the summed
    counts, as one process gets on the concatenated batches."""
    from tests.test_torch_aligner_train import _cfg
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.tasks.base_task import BaseTask

    steps = lvlm_batches(3)
    per_rank = [[s[0] for s in steps], [s[1] for s in steps[:2]]]
    _, tm = _models(False)
    outs = launch("eval", tmp_path, _port_inputs(
        "lvlm", _cfg(False), tm, eval_batches=per_rank, best_metric=metric))
    a, b = (o["result"] for o in outs)
    assert a == b
    tr = Trainer(tm, RUN_CFG, device="cpu")
    want = BaseTask(device="cpu").evaluation(
        tr, tr.init_state(), [concat(s) for s in steps[:2]],
        best_metric=metric)
    assert set(a) == set(want) == (
        {"agg_metrics", "loss", "token_acc"} if metric == "token_acc"
        else {"agg_metrics", "loss"})
    for k in want:
        np.testing.assert_allclose(a[k], want[k], rtol=1e-5, err_msg=k)


def test_save_result_merges_the_ranks_files_on_rank_0(tmp_path):
    """Each rank writes val_rank{r}.json; rank 0 merges them in rank
    order, dropping a repeated id, and every rank returns the merged
    file's path after it is written."""
    import json

    results = [[{"id": 1, "v": "a"}, {"id": 2, "v": "b"}],
               [{"id": 2, "v": "c"}, {"id": 3, "v": "d"}]]
    outs = launch("save_result", tmp_path, {
        "results": results, "result_dir": str(tmp_path / "res")})
    final = tmp_path / "res" / "val.json"
    assert [o["result"] for o in outs] == [str(final)] * 2
    assert json.loads(final.read_text()) == [
        {"id": 1, "v": "a"}, {"id": 2, "v": "b"}, {"id": 3, "v": "d"}]
    for rank in range(2):
        assert json.loads((tmp_path / "res" / f"val_rank{rank}.json")
                          .read_text()) == results[rank]


# -- the mesh -------------------------------------------------------------

@pytest.mark.parametrize("world,data", [(1, -1), (1, 1), (2, -1), (2, 2),
                                        (4, -1), (8, -1), (8, 8)])
def test_mesh_axes_follow_jax_make_mesh(world, data):
    """A data-parallel run.mesh over ``world`` ranks has the axes JAX's
    make_mesh gives over as many devices."""
    got = tmesh.mesh_from_config({"mesh": {"data": data, "fsdp": 1,
                                           "model": 1}}, world=world)
    want = jmesh.mesh_from_config({"mesh": {"data": data, "fsdp": 1,
                                            "model": 1}},
                                  devices=jax.devices()[:world])
    assert got.shape == dict(want.shape)
    assert tmesh.AXES == jmesh.AXES


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"model": 2},
                                  {"data": 1, "fsdp": 2, "model": 2}])
def test_mesh_with_sharded_axes_is_refused(axes):
    """JAX builds these meshes over 4 or 8 devices; the port shards no
    parameters yet and says where that work is queued."""
    assert jmesh.mesh_from_config({"mesh": axes},
                                  devices=jax.devices()[:4]).size == 4
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1, item 12c"):
        tmesh.mesh_from_config({"mesh": axes}, world=4)


@pytest.mark.parametrize("world,data", [(2, 1), (2, 3), (4, 2)])
def test_mesh_that_does_not_cover_the_world_is_refused(world, data):
    with pytest.raises(AssertionError):
        jmesh.make_mesh(data=data, devices=jax.devices()[:world])
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_mesh(data=data, world=world)


def test_local_batch_slice_is_jax_s_at_a_world_of_one():
    assert tmesh.local_batch_slice(12) == jmesh.local_batch_slice(12) == (0, 12)


# -- joining a world ------------------------------------------------------

def test_a_failed_join_raises(monkeypatch):
    """A launcher's world of two without a rendezvous address: the join
    raises; nothing goes on as rank 0 of 1."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        td.init_distributed_mode({}, "cpu")
    assert not td.is_dist_avail_and_initialized()


def test_cuda_without_a_card_raises_before_the_join(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.init_distributed_mode({}, "cuda")
    assert not td.is_dist_avail_and_initialized()


def test_a_world_of_one_records_rank_0_of_1():
    cfg = {}
    td.init_distributed_mode(cfg, "cpu")
    assert cfg == {"rank": 0, "world_size": 1, "distributed": False}
    assert not td.is_dist_avail_and_initialized()
    assert td.get_rank() == 0 and td.get_world_size() == 1
    assert td.is_main_process()
    assert td.main_process(lambda: 7)() == 7
    td.barrier()
    assert td.broadcast_object("job") == "job"
    assert td.all_reduce_min(3) == 3


def test_a_kernel_operand_on_another_card_raises(monkeypatch):
    """Every wrapper takes its stream from kernels.stream_of before it
    launches: a tensor on a card other than the current one raises there
    (the launchers set shared-memory opt-ins and read SM counts on the
    current card only); nothing switches device or falls back."""
    from thinkdiff_torch import kernels

    class OnCard1:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        kernels.stream_of(OnCard1())


# -- the ranks' loaders ---------------------------------------------------

def _embed_loaders(tmp_path, rank, world):
    from tests.test_torch_data import (
        COLLATE_MODES, T5Tok, _embed_cfg, _embed_samples, _write_jax_shards,
        vlm_decode)
    from thinkdiff_torch.core.config import ConfigNode as TNode
    from thinkdiff_torch.data import builders as tb
    from thinkdiff_tpu.core.config import ConfigNode as JNode
    from thinkdiff_tpu.data import builders as jb

    shards = _write_jax_shards(tmp_path, _embed_samples(60))
    storage = str(tmp_path / ("e-{000000..%06d}.tar" % (len(shards) - 1)))
    cfg = _embed_cfg(storage, **COLLATE_MODES["packed"])
    for cls, node in ((tb.LlavaInstructEmbedBuilder, TNode),
                      (jb.LlavaInstructEmbedBuilder, JNode)):
        bundle = cls(node(cfg), model_cfg=node({})).build_datasets()[
            "train"]
        bundle.set_tokenizers(T5Tok(), vlm_decode)
        yield bundle.get_loader(rank=rank, world_size=world, seed=3, epoch=1)


def _wids_loaders(tmp_path, rank, world):
    from PIL import Image

    from thinkdiff_torch.core.config import ConfigNode as TNode
    from thinkdiff_torch.data import builders as tb
    from thinkdiff_tpu.core.config import ConfigNode as JNode
    from thinkdiff_tpu.data import builders as jb
    from thinkdiff_tpu.data import tario as jt

    rs = np.random.RandomState(1)
    with jt.ShardWriter(str(tmp_path / "img-%06d.tar"), maxcount=7) as w:
        for i in range(17):
            w.write({"__key__": f"img{i:04d}", "jpg": Image.fromarray(
                rs.randint(0, 256, (12, 12, 3), np.uint8)),
                "json": {"caption": f"c {i}"}})
        n = w.shard
    index = str(tmp_path / "i.json")
    jt.write_wids_index([str(tmp_path / f"img-{i:06d}.tar") for i in range(n)],
                        index, "imgs")
    cfg = {"batch_size": 3, "build_info": {"storage": index}}
    for cls, node in ((tb.CCSBUWidsProcessBuilder, TNode),
                      (jb.CCSBUWidsProcessBuilder, JNode)):
        yield cls(node(cfg)).build_datasets()["train"].get_loader(
            rank=rank, world_size=world, seed=42)


def _cc_sbu_loaders(tmp_path, rank, world):
    import random

    from tests.test_torch_clip_data import (
        JConfigNode, TConfigNode, _cc_sbu_cfg, t5_tok, write_cc_sbu_shards)
    from thinkdiff_torch.data import builders as tb
    from thinkdiff_tpu.data import builders as jb

    storage = write_cc_sbu_shards(tmp_path / "shards", n=36, per_shard=6)
    for mod, node in ((tb, TConfigNode), (jb, JConfigNode)):
        bundle = mod.CCSBUBuilder(_cc_sbu_cfg(storage, node),
                                  model_cfg={"max_txt_len": 99}
                                  ).build_datasets()["train"]
        bundle.set_tokenizers(t5_tok(), None)
        # the caption splits draw from the module-level generator, which
        # the CLIs seed with seed + rank in both packages
        random.seed(9 + rank)
        loader = bundle.get_loader(rank=rank, world_size=world, seed=4,
                                   epoch=1)
        # JAX's PrefetchLoader has no stop: its thread would go on drawing
        # splits after the case, so its synchronous pipeline is read
        yield loader if mod is tb else loader.loader


LOADERS = {"embed": (_embed_loaders, 4), "wids": (_wids_loaders, None),
           "cc_sbu": (_cc_sbu_loaders, 2)}


@pytest.mark.parametrize("source", sorted(LOADERS))
@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 2)])
def test_a_rank_s_loader_is_the_jax_process_s(tmp_path, source, world,
                                              rank):
    """Rank r of W reads what JAX process r of W reads: the webdataset
    embed stream (packed rows), the wids-indexed precompute reader (the
    whole pass) and the cc_sbu caption-split path give identical
    batches at the same rank, world and seeds."""
    make, n = LOADERS[source]
    got_want = []
    for loader in make(tmp_path, rank, world):
        it = iter(loader)
        got_want.append(list(it) if n is None else [next(it)
                                                    for _ in range(n)])
        if hasattr(it, "close"):
            it.close()
    got, want = got_want
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            elif k == "images":
                assert all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(a[k], b[k]))
            else:
                assert a[k] == b[k], k
