"""Port parity: stages 1 and 2 of the workflow in miniature on both
packages (the counterpart of tests/test_precompute_e2e.py). Stage 1 runs
the port's precompute CLI (``generate_embedding_webdataset.main`` with
``--device cpu``) and the JAX package's task and runner over the same
wids-indexed image shards, with one tiny Qwen2-VL's weights in both
engines (greedy): the shards must hold the same members in the same
order, identical JSON (text, prompts, token ids) and embeddings within
``_bf16_close``. Stage 2 trains the aligner on the port's shards in both
packages, the JAX weights bridged into the port's model: the losses follow
JAX's within test_trainer_trajectory_matches_jax's f32 tolerance (1e-4
relative), the projector within 1e-4."""

import tarfile

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_data import T5Tok
from tests.test_torch_embed_engine import (
    ENGINE_KW, TINY_SPECIALS, _bf16_close)
from thinkdiff_torch.core.optim import tree_leaves
from thinkdiff_torch.data import tario as tt
from thinkdiff_torch.engines import embed_engine as te
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_torch.models import qwen2_vl as tm
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.scripts import generate_embedding_webdataset as gen_cli
from thinkdiff_tpu.data import tario as jt
from thinkdiff_tpu.engines import embed_engine as je
from thinkdiff_tpu.models import qwen2_vl as jm

N_IMAGES = 8
TINY_T5 = dict(vocab_size=300, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_decoder_layers=2, num_heads=4, dropout_rate=0.0)


def _tokenizer():
    return StandInTokenizer(TINY_SPECIALS, word_lo=1, word_hi=201)


@pytest.fixture(scope="module")
def qwen_params():
    import jax.numpy as jnp

    cfg = jm.Qwen2VLConfig.tiny()
    rng = jax.random.PRNGKey(0)
    vp = jm.Qwen2VisionTower(cfg.vision).init(
        rng, jnp.zeros((4, cfg.vision.patch_dim)),
        jnp.zeros((4, cfg.vision.head_dim // 2)),
        jnp.zeros((4, cfg.vision.head_dim // 2)), None)["params"]
    lp = jm.Qwen2VLModel(cfg).init(
        rng, input_ids=jnp.zeros((1, 4), jnp.int32),
        position_ids=jnp.zeros((3, 1, 4), jnp.int32))["params"]
    return jax.tree.map(np.array, {"vision": vp, "lm": lp})


def _image_index(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    with jt.ShardWriter(str(tmp_path / "img-%06d.tar"), maxcount=5) as w:
        for i in range(N_IMAGES):
            hw = (16, 16) if i % 2 else (24, 16)
            w.write({"__key__": f"img{i:06d}", "jpg": Image.fromarray(
                (rs.rand(*hw, 3) * 255).astype("uint8")),
                "json": {"caption": f"caption {i}"}})
        n = w.shard
    index = str(tmp_path / "wids_index.json")
    jt.write_wids_index([str(tmp_path / f"img-{i:06d}.tar") for i in range(n)],
                        index, "test")
    return index


def _precompute_cfg(tmp_path, index, out):
    cfg = {
        "model": {"arch": "mllama-vllm-generate-1",
                  "vllm_config": {"embedding_layer_name": "model.norm",
                                  "max_num_seqs": 4}},
        "datasets": {"cc_sbu_mllama_vllm_process_wids": {
            "batch_size": 4, "build_info": {"storage": index}}},
        "run": {"task": "image_text_process_data",
                "runner": "runner_process_data",
                "output_shard_path": [str(tmp_path / out), "%06d.tar", 0],
                "seed": 0, "log_freq": 1},
    }
    path = tmp_path / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run_jax_precompute(cfg_path, engine):
    import thinkdiff_tpu.data  # noqa: F401
    import thinkdiff_tpu.runners  # noqa: F401
    import thinkdiff_tpu.tasks  # noqa: F401
    from thinkdiff_tpu.core.config import Config
    from thinkdiff_tpu.core.registry import registry
    from thinkdiff_tpu.tasks import setup_task

    cfg = Config(cfg_path=cfg_path)
    task = setup_task(cfg)
    model = je.MllamaVllmGenerateModel(cfg.model_cfg, engine=engine)
    runner = registry.get_runner_class("runner_process_data")(
        cfg=cfg, task=task, model=model, datasets=task.build_datasets(cfg))
    return runner.train()


def _members(path):
    with tarfile.open(path) as tf:
        return [m.name for m in tf.getmembers()]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory, qwen_params):
    """Both packages' stage 1 on the same images: (dir, port stats, JAX
    stats)."""
    tmp = tmp_path_factory.mktemp("stage1")
    index = _image_index(tmp)
    jeng = je.EmbedEngine(jm.Qwen2VLConfig.tiny(), qwen_params, _tokenizer(),
                          **ENGINE_KW)
    teng = te.EmbedEngine(tm.Qwen2VLConfig.tiny(), qwen_params, _tokenizer(),
                          device="cpu", **ENGINE_KW)
    want = _run_jax_precompute(_precompute_cfg(tmp, index, "jax"), jeng)
    mp = pytest.MonkeyPatch()
    mp.setattr(te.EmbedEngine, "from_config",
               classmethod(lambda cls, cfg, device="cuda": teng))
    try:
        got = gen_cli.main(["--cfg-path", _precompute_cfg(tmp, index, "port"),
                            "--device", "cpu"])
    finally:
        mp.undo()
    return tmp, got, want


def test_precompute_shards_match_jax(stage1):
    tmp, got, want = stage1
    assert got == want == {"num_samples": N_IMAGES, "num_shards": 1}
    port, jax_tar = tmp / "port" / "000000.tar", tmp / "jax" / "000000.tar"
    assert _members(port) == _members(jax_tar)
    samples = list(tt.tar_sample_iterator(str(port), decode=True))
    jsamples = list(jt.tar_sample_iterator(str(jax_tar), decode=True))
    assert len(samples) == N_IMAGES
    lengths = set()
    for s, js in zip(samples, jsamples):
        assert s["__key__"] == js["__key__"]
        assert s["json"] == js["json"]
        assert set(s["json"]) == {"caption", "generated_text", "input_prompt",
                                  "input_prompt_token_ids", "output_text",
                                  "output_token_ids"}
        for field in ("model.norm.input_embed.pth",
                      "model.norm.output_embed.pth"):
            e = s[field]
            assert e.dtype == torch.bfloat16 and torch.isfinite(e.float()).all()
            _bf16_close(e, np.asarray(js[field], np.float32))
        out = s["model.norm.output_embed.pth"]
        assert out.shape == (len(s["json"]["output_token_ids"]), 64)
        assert s["model.norm.input_embed.pth"].shape[0] == len(
            s["json"]["input_prompt_token_ids"])
        assert np.array_equal(np.asarray(s["jpg"]), np.asarray(js["jpg"]))
        lengths.add(len(s["json"]["output_token_ids"]))
    assert len(lengths) > 1


def _train_cfg(tmp_path, storage, name):
    return {
        "model": {"arch": "mllama-vllm-t5-embed-decoder-2", "dtype": "float32",
                  "load_pretrained": False, "vlm_hidden_size": 64,
                  "t5_config": TINY_T5},
        "datasets": {"llava_instruct_mllama_embed_2": {
            "batch_size": 4, "max_txt_len": 8,
            "build_info": {"storage": storage, "use_input_embed": False,
                           "use_output_embed": True,
                           "random_split_output_embed": True,
                           "output_embed_max_split_len": 3}}},
        "run": {"task": "image_text_pretrain", "runner": "runner_clip_t5",
                "lr_sched": "linear_warmup_cosine_lr", "init_lr": 1e-2,
                "min_lr": 1e-3, "warmup_lr": 1e-6, "warmup_steps": 2,
                "weight_decay": 0.05, "max_epoch": 2, "iters_per_epoch": 3,
                "seed": 0, "output_dir": str(tmp_path / f"out_{name}")},
    }


def test_training_on_the_shards_follows_jax(stage1, monkeypatch):
    """Two epochs of three steps on the port's shards in both packages,
    from the same weights: each epoch's mean loss within 1e-4 relative, the
    projector after six steps within 1e-4, checkpoints of both epochs."""
    import thinkdiff_tpu.data  # noqa: F401
    import thinkdiff_tpu.runners  # noqa: F401
    import thinkdiff_tpu.tasks  # noqa: F401
    from thinkdiff_torch.core.config import Config as TConfig
    from thinkdiff_torch.core.registry import registry as treg
    from thinkdiff_torch.tasks import setup_task as tsetup
    from thinkdiff_tpu.core.config import Config as JConfig
    from thinkdiff_tpu.core.registry import registry as jreg
    from thinkdiff_tpu.parallel.mesh import make_mesh
    from thinkdiff_tpu.runners import runner_base as jrb
    from thinkdiff_tpu.tasks import setup_task as jsetup

    tmp, _, _ = stage1
    storage = str(tmp / "port" / "{000000..000000}.tar")
    monkeypatch.setattr(jrb, "mesh_from_config",
                        lambda run: make_mesh(devices=jax.devices()[:1]))
    decode = _tokenizer().decode
    runs = {}
    for name, config, setup, reg, kw in (
            ("jax", JConfig, jsetup, jreg, {}),
            ("port", TConfig, tsetup, treg, {"device": "cpu"})):
        path = tmp / f"train_{name}.yaml"
        path.write_text(yaml.safe_dump(_train_cfg(tmp, storage, name)))
        cfg = config(cfg_path=str(path))
        task = setup(cfg, **kw)
        model = task.build_model(cfg)
        model.t5_tokenizer = T5Tok()
        model.vlm_decode_fn = decode
        runs[name] = (cfg, task, model, reg)
    jm_, tm_ = runs["jax"][2], runs["port"][2]
    load_params(tm_.frozen["t5"], jax.tree.map(np.asarray, jm_.frozen["t5"]))
    tm_.load_trainable(jax.tree.map(np.asarray, jm_.trainable_params()))
    runners = {}
    for name, (cfg, task, model, reg) in runs.items():
        runners[name] = reg.get_runner_class("runner_clip_t5")(
            cfg=cfg, task=task, model=model,
            datasets=task.build_datasets(cfg), job_id="rt")
        runners[name].train()

    def epoch_losses(runner):
        import json

        with open(f"{runner.output_dir}/log.txt") as f:
            lines = [json.loads(x) for x in f]
        return [float(e["train_loss"]) for e in lines if "train_loss" in e]

    got, want = epoch_losses(runners["port"]), epoch_losses(runners["jax"])
    assert len(got) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jparams = jax.tree.map(np.asarray, runners["jax"].state["params"])
    tparams = runners["port"].state["params"]
    for path, t in tree_leaves(tparams):
        node = jparams
        for k in path.split("/"):
            node = node[k]
        np.testing.assert_allclose(t.numpy(), node, rtol=0, atol=1e-4,
                                   err_msg=path)
    assert runners["port"].state["step"] == 6
    out = runners["port"].output_dir
    assert out == str(tmp / "out_port" / "rt")
    for tag in (0, 1):
        ck = torch.load(runners["port"].ckpt.path(tag), weights_only=True)
        assert ck["epoch"] == tag and ck["step"] == 3 * (tag + 1)
        assert set(ck) == {"model", "optimizer", "step", "epoch"}
        assert "projector/layer_0/kernel" in ck["model"]
