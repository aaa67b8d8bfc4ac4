"""One rank of the port's multi-rank CPU tests (tests/test_torch_distributed
.py, tests/test_torch_distributed_cli.py), started once a rank with the
launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT):

    python tests/_torch_dist_child.py MODE DIR

It reads DIR/in.pkl (written by the test), joins the world through
``init_distributed_mode`` over gloo on the CPU, runs MODE and writes
DIR/out_rank{r}.pkl. It imports nothing of JAX: the test holds the
result against the JAX package."""

import os
import pickle
import sys

import torch

from thinkdiff_torch.core import distributed as td
from thinkdiff_torch.core.optim import tree_leaves


def _model(inp):
    from thinkdiff_torch.models import aligner_clip, aligner_lvlm
    from thinkdiff_torch.models.bridge import load_params

    cls = {"lvlm": aligner_lvlm.MllamaT5EmbedDecoder,
           "clip": aligner_clip.BlipVisionT5Decoder}[inp["arch"]]
    model = cls(inp["cfg"], device="cpu")
    for name, tree in inp["frozen"].items():
        load_params(model.frozen[name], tree)
    model.load_trainable(inp["trainable"])
    return model


def _trainer(inp):
    from thinkdiff_torch.engines.trainer import Trainer

    return Trainer(_model(inp), dict(inp["run_cfg"]), device="cpu")


def _flat_params(state):
    return {p: t.numpy().copy() for p, t in tree_leaves(state["params"])}


def run_trainer(inp, rank):
    """``steps`` train steps, each on this rank's batch of that step; a
    rank that is not rank 0 starts from other parameters, which
    ``init_state`` must overwrite with rank 0's."""
    trainer = _trainer(inp)
    if rank:
        for _, t in tree_leaves(trainer.model.trainable):
            t.add_(1.0)
    state = trainer.init_state()
    out = {"losses": [], "grad_norms": [], "lrs": []}
    for step_batches in inp["batches"]:
        state, m = trainer.train_step(
            state, trainer.prepare_batch(step_batches[rank]))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lrs"].append(m["lr"])
    out["params"] = _flat_params(state)
    out["count"] = state["opt_state"]["count"]
    return out


def run_eval(inp, rank):
    from thinkdiff_torch.tasks.base_task import BaseTask

    trainer = _trainer(inp)
    state = trainer.init_state()
    return BaseTask(device="cpu").evaluation(
        trainer, state, iter(inp["eval_batches"][rank]),
        max_batches=inp.get("max_batches"),
        best_metric=inp.get("best_metric", "loss"))


def run_save_result(inp, rank):
    from thinkdiff_torch.tasks.base_task import save_result

    return save_result(inp["results"][rank], inp["result_dir"], "val",
                       remove_duplicate="id")


def run_precompute(inp, rank):
    """The precompute CLI on a tiny Qwen2-VL engine (the test's weights)."""
    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models import qwen2_vl as tq
    from thinkdiff_torch.scripts import generate_embedding_webdataset as cli

    def from_config(cls, cfg, device="cuda"):
        return te.EmbedEngine(
            tq.Qwen2VLConfig.tiny(), inp["qwen_params"],
            StandInTokenizer(inp["specials"], word_lo=1, word_hi=201),
            device=device, **inp["engine_kw"])

    te.EmbedEngine.from_config = classmethod(from_config)
    return cli.main(["--cfg-path", inp["cfg_path"], "--device", "cpu"])


MODES = {"trainer": run_trainer, "eval": run_eval,
         "save_result": run_save_result, "precompute": run_precompute}


def main():
    mode, work = sys.argv[1], sys.argv[2]
    with open(os.path.join(work, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    if inp.get("group_of_one"):
        # a process group the caller made, at a world of one: the port
        # must use it as it is and still take the single-card step
        torch.distributed.init_process_group("gloo", init_method="env://")
    run_cfg = {}
    td.init_distributed_mode(run_cfg, "cpu")
    rank = run_cfg["rank"]
    out = MODES[mode](inp, rank)
    out = {"result": out, "run_cfg": run_cfg,
           "backend": (torch.distributed.get_backend()
                       if td.is_dist_avail_and_initialized() else None)}
    with open(os.path.join(work, f"out_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if td.is_dist_avail_and_initialized():
        torch.distributed.destroy_process_group()
    print(f"rank {rank} done")


if __name__ == "__main__":
    main()
