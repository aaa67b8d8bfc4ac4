"""Stages 1 and 2 of the port on several ranks from their CLIs, on the CPU
over gloo: ``python -m torch.distributed.run --nproc_per_node 2 -m
thinkdiff_torch.train ... --device cpu`` writes one job directory (rank
0's job id), its checkpoints and one profiler trace a rank, trains what
JAX's Trainer trains on the concatenation of the ranks' batches, and
resumes bit for bit; the two-rank precompute CLI writes disjoint shard
ranges (rank r from r x 100000 on) that hold every sample once, as the
world-1 run holds them."""

import glob
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_aligner_train import _flat
from tests.test_torch_cli import _cfg, _in_process, _log, _shards
from tests.test_torch_data import T5Tok, vlm_decode
from tests.test_torch_distributed import free_port, launch
from tests.test_torch_embed_engine import ENGINE_KW, TINY_SPECIALS
from tests.test_torch_precompute import (  # noqa: F401 (a fixture)
    N_IMAGES, _image_index, _precompute_cfg, qwen_params)
from thinkdiff_torch.data import tario as tt
from thinkdiff_torch.models.bridge import params_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# imported by every Python process the launcher starts (PYTHONPATH): the
# model has no tokenizer files here, so the T5 tokenizer and the VLM decode
# (tests/test_torch_data.py's stand-ins, copied: no JAX in the ranks) are
# patched in before the CLI runs
SITECUSTOMIZE = '''
from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder


class T5Tok:
    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text, add_special_tokens=True):
        ids = [3 + sum(map(ord, w)) % 297 for w in text.split()]
        return ids + [1] if add_special_tokens else ids


def vlm_decode(ids):
    return " ".join(f"w{i}" for i in ids)


MllamaT5EmbedDecoder.get_t5_tokenizer = lambda self: T5Tok()
MllamaT5EmbedDecoder.get_vlm_decode_fn = lambda self: vlm_decode
'''
WORLD = 2


def torchrun(tmp_path, cfg_path, *args, nproc=WORLD):
    """The training CLI on ``nproc`` gloo ranks through the launcher."""
    shim = tmp_path / "shim"
    shim.mkdir(exist_ok=True)
    (shim / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=f"{shim}{os.pathsep}{REPO}")
    argv = [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
            "--master_port", str(free_port()), "-m", "thinkdiff_torch.train",
            "--cfg-path", str(cfg_path), "--device", "cpu", *args]
    proc = subprocess.run(argv, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Two epochs of three steps on two ranks, no --job-id, epoch 0
    traced: (work dir, the config, the job directory)."""
    tmp = tmp_path_factory.mktemp("ddp_train")
    cfg = _cfg(tmp, _shards(tmp), profile_dir=str(tmp / "trace"))
    path = tmp / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    torchrun(tmp, path)
    jobs = os.listdir(tmp / "out")
    assert len(jobs) == 1, jobs
    return tmp, cfg, tmp / "out" / jobs[0]


def test_one_job_dir_one_log_and_a_trace_a_rank(straight):
    """Both ranks write under rank 0's job id; only rank 0 writes log.txt
    (the config once, one line an epoch) and the checkpoints; epoch 0's
    trace is written once a rank."""
    tmp, _, job = straight
    lines = _log(job)
    assert sum("run" in e for e in lines) == 1
    assert [e["epoch"] for e in lines if "train_loss" in e] == [0, 1]
    assert sorted(p.name for p in job.glob("checkpoint_*.pth")) == [
        "checkpoint_0.pth", "checkpoint_1.pth"]
    for rank in range(WORLD):
        trace = json.loads((tmp / "trace" / f"trace_rank{rank}.json")
                           .read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any(n.startswith("aten::") for n in names)
    assert sorted(os.listdir(tmp / "trace")) == ["trace_rank0.json",
                                                 "trace_rank1.json"]


def _pad_to(batch, enc, dec):
    """A collated batch padded to ``enc`` embed rows and ``dec`` labels:
    masked condition rows and ignored labels, which change no loss."""
    b = dict(batch)
    s, t = b["embeds"].shape[1], b["labels"].shape[1]
    b["embeds"] = np.pad(b["embeds"], ((0, 0), (0, enc - s), (0, 0)))
    b["embed_mask"] = np.pad(b["embed_mask"], ((0, 0), (0, enc - s)))
    b["labels"] = np.pad(b["labels"], ((0, 0), (0, dec - t)),
                         constant_values=-100)
    return b


def _global_batches(cfg_path, epochs, steps):
    """[epoch][step] the ranks' batches as the runner's loaders give them
    (rank r of WORLD), concatenated: what JAX's Trainer takes as the global
    batch. Also each step's label count a rank."""
    from thinkdiff_torch.core.config import Config
    from thinkdiff_torch.tasks import setup_task

    cfg = Config(cfg_path=str(cfg_path))
    task = setup_task(cfg, device="cpu")
    bundle = task.build_datasets(cfg)["llava_instruct_mllama_embed_2"]["train"]
    bundle.set_tokenizers(T5Tok(), vlm_decode)
    out, counts = [], []
    for epoch in range(epochs):
        per_rank = []
        for rank in range(WORLD):
            it = iter(bundle.get_loader(rank=rank, world_size=WORLD,
                                        seed=int(cfg.run_cfg.seed),
                                        epoch=epoch))
            per_rank.append([next(it) for _ in range(steps)])
            it.close()
        for step in zip(*per_rank):
            enc = max(b["embeds"].shape[1] for b in step)
            dec = max(b["labels"].shape[1] for b in step)
            step = [_pad_to(b, enc, dec) for b in step]
            counts.append([int((b["labels"] != -100).sum()) for b in step])
            out.append({k: np.concatenate([b[k] for b in step])
                        for k in step[0]})
    return out, counts


def _jax_losses(tmp, cfg, mesh_shape=(1, 1, 1)):
    """JAX's Trainer on the (data, fsdp, model) mesh, from the port
    model's weights, fed each step's WORLD reader batches concatenated:
    (each epoch's mean loss, the final trainable tree)."""
    from thinkdiff_torch.core.config import Config
    from thinkdiff_torch.tasks import setup_task
    from thinkdiff_tpu.core.config import ConfigNode
    from thinkdiff_tpu.engines.trainer import Trainer as JTrainer
    from thinkdiff_tpu.models.aligner_lvlm import MllamaT5EmbedDecoder
    from thinkdiff_tpu.parallel.mesh import make_mesh

    path = tmp / "cfg.yaml"
    run = cfg["run"]
    batches, counts = _global_batches(path, run["max_epoch"],
                                      run["iters_per_epoch"])
    assert any(a != b for a, b in counts), counts
    tconfig = Config(cfg_path=str(path))
    tm = setup_task(tconfig, device="cpu").build_model(tconfig)
    jm = MllamaT5EmbedDecoder(ConfigNode(cfg["model"]), seed=0)
    jm.frozen = {"t5": jax.tree.map(jax.numpy.asarray,
                                    params_of(tm.frozen["t5"]))}
    jm.trainable = jax.tree.map(jax.numpy.asarray, tm.export_trainable())
    run_cfg = {k: (float(v) if k.endswith("lr") else v)
               for k, v in run.items()}
    d, f, m = mesh_shape
    jt = JTrainer(jm, run_cfg, mesh=make_mesh(
        d, f, m, devices=jax.devices()[:d * f * m]))
    js = jt.init_state()
    losses = []
    for b in batches:
        js, met = jt.train_step(js, jt.prepare_batch(b),
                                jax.random.PRNGKey(run["seed"]))
        losses.append(float(met["loss"]))
    steps = run["iters_per_epoch"]
    return ([np.mean(losses[e * steps:(e + 1) * steps])
             for e in range(run["max_epoch"])], _flat(js["params"]))


def test_training_cli_on_an_fsdp_model_mesh_matches_jax_s(tmp_path):
    """``run.mesh {data 1, fsdp 2, model 2}`` through the launcher on four
    gloo ranks (the model built from its seed as each rank's blocks, the
    two (data, fsdp) readers' batches, the model peers alike): each
    epoch's mean loss within 1e-4 relative of JAX's Trainer on the same
    mesh shape fed the readers' batches concatenated, the projector within
    1e-4, and one checkpoint and one log."""
    cfg = _cfg(tmp_path, _shards(tmp_path),
               mesh={"data": 1, "fsdp": 2, "model": 2})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    torchrun(tmp_path, path, nproc=4)
    jobs = os.listdir(tmp_path / "out")
    assert len(jobs) == 1, jobs
    job = tmp_path / "out" / jobs[0]
    want, want_p = _jax_losses(tmp_path, cfg, (1, 2, 2))
    got = [float(e["train_loss"]) for e in _log(job) if "train_loss" in e]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ck = torch.load(job / "checkpoint_1.pth", weights_only=True)
    for name, w in want_p.items():
        np.testing.assert_allclose(ck["model"][name].numpy(), w, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_training_cli_matches_jax_on_the_global_batch(straight):
    """The JAX Trainer on one device, from the port model's weights, fed
    each step's two rank batches concatenated (label counts unequal):
    each epoch's mean loss (log.txt) within 1e-4 relative, the projector
    after six steps within 1e-4, as the one-rank CLI holds to JAX
    (tests/test_torch_precompute.py)."""
    from thinkdiff_torch.core.config import Config
    from thinkdiff_torch.tasks import setup_task
    from thinkdiff_tpu.core.config import ConfigNode
    from thinkdiff_tpu.engines.trainer import Trainer as JTrainer
    from thinkdiff_tpu.models.aligner_lvlm import MllamaT5EmbedDecoder
    from thinkdiff_tpu.parallel.mesh import make_mesh

    tmp, cfg, job = straight
    path = tmp / "cfg.yaml"
    run = cfg["run"]
    batches, counts = _global_batches(path, run["max_epoch"],
                                      run["iters_per_epoch"])
    assert any(a != b for a, b in counts), counts
    tconfig = Config(cfg_path=str(path))
    tm = setup_task(tconfig, device="cpu").build_model(tconfig)
    jm = MllamaT5EmbedDecoder(ConfigNode(cfg["model"]), seed=0)
    jm.frozen = {"t5": jax.tree.map(jax.numpy.asarray,
                                    params_of(tm.frozen["t5"]))}
    jm.trainable = jax.tree.map(jax.numpy.asarray, tm.export_trainable())
    run_cfg = {k: (float(v) if k.endswith("lr") else v)
               for k, v in run.items()}
    jt = JTrainer(jm, run_cfg, mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state()
    losses = []
    for b in batches:
        js, met = jt.train_step(js, jt.prepare_batch(b),
                                jax.random.PRNGKey(run["seed"]))
        losses.append(float(met["loss"]))
    steps = run["iters_per_epoch"]
    want = [np.mean(losses[e * steps:(e + 1) * steps]) for e in range(2)]
    got = [float(e["train_loss"]) for e in _log(job) if "train_loss" in e]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ck = torch.load(job / "checkpoint_1.pth", weights_only=True)
    assert ck["step"] == 2 * steps
    for name, want_p in _flat(js["params"]).items():
        np.testing.assert_allclose(ck["model"][name].numpy(), want_p, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_two_rank_resume_ends_where_the_straight_run_ends(straight):
    """Resumed from checkpoint_0.pth on two ranks (each loads it onto its
    device, rank 0's state broadcast): epoch 1 only, its stats and
    checkpoint_1 bit for bit the straight run's."""
    tmp, _, job = straight
    torchrun(tmp, tmp / "cfg.yaml", "--job-id", "resumed", "--options",
             f"run.resume_ckpt_path={job / 'checkpoint_0.pth'}")
    resumed = tmp / "out" / "resumed"
    train = [e for e in _log(job) if "train_loss" in e]
    assert [e for e in _log(resumed) if "train_loss" in e] == [train[1]]
    a = torch.load(job / "checkpoint_1.pth", weights_only=True)
    b = torch.load(resumed / "checkpoint_1.pth", weights_only=True)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for part in ("mu", "nu"):
        for k in a["optimizer"][part]:
            assert torch.equal(a["optimizer"][part][k],
                               b["optimizer"][part][k]), (part, k)


def _samples(tars):
    out = {}
    for tar in tars:
        for s in tt.tar_sample_iterator(tar):
            assert s["__key__"] not in out, s["__key__"]
            out[s["__key__"]] = s
    return out


def test_two_rank_precompute_writes_disjoint_ranges_of_every_sample(
        tmp_path, qwen_params):
    """The precompute CLI at two ranks (each its own tiny engine): rank r
    writes from shard r x 100000 on; the ranks' samples are disjoint, add
    up to every image once (the world-1 run's images and captions), each
    with bf16 embeddings of as many finite rows as its tokens."""
    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models import qwen2_vl as tq
    from thinkdiff_torch.scripts import generate_embedding_webdataset as cli

    index = _image_index(tmp_path)
    outs = launch("precompute", tmp_path / "ddp", {
        "qwen_params": qwen_params, "specials": TINY_SPECIALS,
        "engine_kw": ENGINE_KW,
        "cfg_path": _precompute_cfg(tmp_path, index, "ranks")})
    stats = [o["result"] for o in outs]
    assert all(s["num_samples"] > 0 for s in stats)
    assert sum(s["num_samples"] for s in stats) == N_IMAGES
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "ranks" / "*.tar")))
    assert names == ["000000.tar", "100000.tar"]
    by_rank = [_samples([str(tmp_path / "ranks" / n)]) for n in names]
    assert not set(by_rank[0]) & set(by_rank[1])
    assert [len(r) for r in by_rank] == [s["num_samples"] for s in stats]

    engine = te.EmbedEngine(
        tq.Qwen2VLConfig.tiny(), qwen_params,
        StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201),
        device="cpu", **ENGINE_KW)
    mp = pytest.MonkeyPatch()
    mp.setattr(te.EmbedEngine, "from_config",
               classmethod(lambda cls, cfg, device="cuda": engine))
    try:
        cli.main(["--cfg-path", _precompute_cfg(tmp_path, index, "one"),
                  "--device", "cpu"])
    finally:
        mp.undo()
    want = _samples(sorted(glob.glob(str(tmp_path / "one" / "*.tar"))))
    got = {**by_rank[0], **by_rank[1]}
    assert sorted(got) == sorted(want) and len(want) == N_IMAGES
    for key, sample in want.items():
        # the instruction is drawn from a rank-seeded generator, as in the
        # JAX processes, so the prompts may differ from the world-1 run's;
        # the image and its caption may not
        assert got[key]["jpg"] == sample["jpg"], key
        js, want_js = json.loads(got[key]["json"]), json.loads(sample["json"])
        assert js["caption"] == want_js["caption"], key
        for kind, ids in (("input", js["input_prompt_token_ids"]),
                          ("output", js["output_token_ids"])):
            e = torch.load(io.BytesIO(got[key][f"model.norm.{kind}_embed.pth"]),
                           weights_only=True)
            assert e.dtype == torch.bfloat16 and e.shape[0] == len(ids)
            assert torch.isfinite(e.float()).all()


def test_profile_dir_writes_epoch_0_s_trace(tmp_path):
    """run.profile_dir: epoch 0's iterations under torch.profiler, written
    as a Chrome trace, trace_rank0.json in a world of one; epoch 1 is not
    traced. The trace carries the program's spans on its own clock: one
    train.step an iteration of epoch 0, inside the trace's time range,
    each holding its forward's matrix products."""
    cfg = _cfg(tmp_path, _shards(tmp_path, 16),
               profile_dir=str(tmp_path / "trace"))
    runner = _in_process(tmp_path, cfg, "--device", "cpu", "--job-id", "p")
    assert os.listdir(tmp_path / "trace") == ["trace_rank0.json"]
    trace = json.loads((tmp_path / "trace" / "trace_rank0.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert runner.state["step"] == 6
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    steps = [e for e in events if e.get("cat") == "program_span"
             and e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    for s in steps:
        assert lo <= s["ts"] and s["ts"] + s["dur"] <= hi
        assert any(e["name"] == "aten::mm" and s["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= s["ts"] + s["dur"] for e in ops)
