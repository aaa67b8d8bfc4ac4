"""The port's training CLI end to end (counterpart of tests/test_cli.py and
the runner cases of tests/test_train_e2e.py): ``python -m
thinkdiff_torch.train --device cpu`` in a subprocess on embedding shards
writes ``log.txt`` and per-epoch checkpoints, and a run resumed from
epoch 0's checkpoint ends bit for bit where the straight run ends. In the
test's process: the card as the default device, the one-device mesh,
per-epoch evaluation with the best checkpoint and the final test split
from it."""

import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from tests.test_torch_data import _embed_samples
from thinkdiff_torch.data import tario as tt
from thinkdiff_torch.models.bridge import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_T5 = dict(vocab_size=300, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_decoder_layers=2, num_heads=4, dropout_rate=0.0)

# the model has no tokenizer files here: the T5 tokenizer and the VLM
# decode are patched in before the CLI's main runs
SHIM = """import sys
from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder
from tests.test_torch_data import T5Tok, vlm_decode
MllamaT5EmbedDecoder.get_t5_tokenizer = lambda self: T5Tok()
MllamaT5EmbedDecoder.get_vlm_decode_fn = lambda self: vlm_decode
from thinkdiff_torch import train
train.main(sys.argv[1:])
"""


def _shards(tmp_path, n=48):
    with tt.ShardWriter(str(tmp_path / "%06d.tar"), maxcount=20) as w:
        for s in _embed_samples(n):
            w.write(s)
        last = w.shard - 1
    return str(tmp_path / ("{000000..%06d}.tar" % last))


def _cfg(tmp_path, storage, **run):
    return {
        "model": {"arch": "mllama-vllm-t5-embed-decoder-2", "dtype": "float32",
                  "load_pretrained": False, "vlm_hidden_size": 12,
                  "t5_config": TINY_T5},
        "datasets": {"llava_instruct_mllama_embed_2": {
            "batch_size": 4, "max_txt_len": 12,
            "build_info": {"storage": storage, "use_input_embed": False,
                           "use_output_embed": True,
                           "random_split_output_embed": True,
                           "output_embed_max_split_len": 6}}},
        "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                "lr_sched": "linear_warmup_cosine_lr", "init_lr": "1e-2",
                "min_lr": 1e-3, "warmup_lr": 1e-6, "warmup_steps": 2,
                "weight_decay": 0.05, "max_epoch": 2, "iters_per_epoch": 3,
                "seed": 0, "log_freq": 1, "output_dir": str(tmp_path / "out"),
                "mesh": {"data": -1, "fsdp": 1, "model": 1}, **run},
    }


def _run_cli(tmp_path, cfg_path, job_id, *options):
    shim = tmp_path / "shim.py"
    shim.write_text(SHIM)
    env = dict(os.environ, PYTHONPATH=REPO)
    argv = [sys.executable, str(shim), "--cfg-path", str(cfg_path),
            "--job-id", job_id, "--device", "cpu"]
    if options:
        argv += ["--options", *options]
    proc = subprocess.run(argv, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp_path / "out" / job_id


def _log(job_dir):
    with open(job_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_log_checkpoints_and_resumes_bit_for_bit(tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(tmp_path, _shards(tmp_path))))
    straight = _run_cli(tmp_path, cfg_path, "straight")
    lines = _log(straight)
    assert lines[0]["run"]["init_lr"] == "1e-2"   # the config, as read
    train = [e for e in lines if "train_loss" in e]
    assert [e["epoch"] for e in train] == [0, 1]
    assert all(float(e["train_loss"]) > 0 for e in train)
    for tag in (0, 1):
        assert (straight / f"checkpoint_{tag}.pth").exists()
        assert (straight / f"checkpoint_{tag}.config.json").exists()

    resumed = _run_cli(
        tmp_path, cfg_path, "resumed",
        f"run.resume_ckpt_path={straight / 'checkpoint_0.pth'}")
    rlines = [e for e in _log(resumed) if "train_loss" in e]
    assert rlines == [train[1]]                  # epoch 1 only, same stats
    assert not (resumed / "checkpoint_0.pth").exists()
    a = torch.load(straight / "checkpoint_1.pth", weights_only=True)
    b = torch.load(resumed / "checkpoint_1.pth", weights_only=True)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (6, 1)
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 6
    for part in ("mu", "nu"):
        for k in a["optimizer"][part]:
            assert torch.equal(a["optimizer"][part][k],
                               b["optimizer"][part][k]), (part, k)


def _in_process(tmp_path, cfg, *extra):
    """The CLI's main in this process, the tokenizers patched."""
    from tests.test_torch_data import T5Tok, vlm_decode
    from thinkdiff_torch import train
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    mp = pytest.MonkeyPatch()
    mp.setattr(MllamaT5EmbedDecoder, "get_t5_tokenizer", lambda self: T5Tok())
    mp.setattr(MllamaT5EmbedDecoder, "get_vlm_decode_fn",
               lambda self: vlm_decode)
    try:
        return train.main(["--cfg-path", str(path), *extra])
    finally:
        mp.undo()


def test_train_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _in_process(tmp_path, _cfg(tmp_path, "unused"), "--job-id", "x")


def test_precompute_cli_defaults_to_the_card(monkeypatch):
    from thinkdiff_torch.scripts import generate_embedding_webdataset as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--cfg-path",
                  os.path.join(REPO, "configs/qwen2_vl_embed_ccsbu.yaml")])


@pytest.mark.parametrize("mesh", [{"data": 2}, {"fsdp": 2}, {"model": 4}])
def test_a_mesh_of_more_than_one_device_is_refused(tmp_path, mesh):
    with pytest.raises(ValueError, match="one device"):
        _in_process(tmp_path, _cfg(tmp_path, _shards(tmp_path, 8), mesh=mesh),
                    "--device", "cpu")


def test_eval_splits_keep_the_best_checkpoint_and_test_from_it(tmp_path):
    """valid_splits evaluate every epoch and keep checkpoint_best; the test
    split is evaluated after training from the reloaded best, logged under
    epoch 'best'."""
    storage = _shards(tmp_path, 24)
    cfg = _cfg(tmp_path, storage, valid_splits=["eval"], test_splits=["eval"],
               max_eval_batches=2)
    from thinkdiff_torch.core.registry import registry
    from thinkdiff_torch.data.builders import LlavaInstructEmbedBuilder

    name = "llava_instruct_mllama_embed_2_testsplit"
    if registry.get_builder_class(name) is None:
        registry.register_builder(name)(
            type(name, (LlavaInstructEmbedBuilder,), {}))
    cfg["evaluation_datasets"] = {name: {
        **cfg["datasets"]["llava_instruct_mllama_embed_2"], "resample": False}}
    runner = _in_process(tmp_path, cfg, "--device", "cpu", "--job-id", "ev")
    lines = _log(tmp_path / "out" / "ev")
    evals = [e for e in lines if "eval_loss" in e]
    assert [e["epoch"] for e in evals] == [0, 1, "best"]
    best = torch.load(runner.ckpt.path("best"), weights_only=True)
    want = max(evals[:2], key=lambda e: e["eval_agg_metrics"])
    assert best["epoch"] == want["epoch"]
    for k, t in flatten(runner.model.trainable).items():
        assert torch.equal(t, best["model"][k]), k
    # the logged test stats are those of the reloaded best state
    again = runner.task.evaluation(
        runner.trainer, runner.state,
        runner._eval_loader(runner.datasets[name]["eval"], 0), max_batches=2)
    assert again["loss"] == evals[2]["eval_loss"]


def test_model_loads_its_checkpoint_and_the_reference_layout(tmp_path):
    """``model.ckpt`` names a ``.pth`` that build_model loads: the port's
    checkpoint (its ``model`` under the JAX paths) or the reference's
    (``mm_projector.*`` under ``model``, converted)."""
    from thinkdiff_torch.core.config import Config
    from thinkdiff_torch.engines.checkpoint import CheckpointManager
    from thinkdiff_torch.tasks import setup_task

    cfg = _cfg(tmp_path, "unused")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    task = setup_task(Config(cfg_path=str(path)), device="cpu")
    src = task.build_model(Config(cfg_path=str(path)))
    for leaf in flatten(src.trainable).values():
        leaf.add_(torch.randn_like(leaf))
    state = {"params": src.trainable, "step": 3,
             "opt_state": {"count": 3, "mu": {}, "nu": {}}}
    ours = CheckpointManager(str(tmp_path / "ck")).save(state, 0)
    theirs = tmp_path / "reference.pth"
    torch.save({"model": {k: torch.as_tensor(v) for k, v in
                          src.export_reference_checkpoint(
                              src.export_trainable()).items()}}, theirs)
    for ckpt in (ours, str(theirs)):
        cfg["model"]["ckpt"] = ckpt
        path.write_text(yaml.safe_dump(cfg))
        got = task.build_model(Config(cfg_path=str(path)))
        want = flatten(src.trainable)
        assert sorted(flatten(got.trainable)) == sorted(want)
        for k, t in flatten(got.trainable).items():
            assert torch.equal(t, want[k]), (ckpt, k)
