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

    if "mesh" in inp:
        _mesh(inp)
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


def _mesh(inp):
    from thinkdiff_torch.parallel.mesh import Mesh, set_mesh

    return set_mesh(Mesh(*inp["mesh"]))


def run_sharded_trainer(inp, rank):
    """The Trainer on ``inp["mesh"]`` (data, fsdp, model): the whole model
    built from the JAX trees and cut by the Trainer; each step's batch is
    the one of this rank's (data, fsdp) reader. Also: each frozen leaf's
    block (shape, dtype), and whether the gathered tree is the JAX one."""
    import numpy as np

    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.models.bridge import flatten, params_of
    from thinkdiff_torch.parallel.mesh import loader_rank

    mesh = _mesh(inp)
    model = _model(inp)
    trainer = Trainer(model, dict(inp["run_cfg"]), device="cpu", mesh=mesh)
    if rank:
        for _, t in tree_leaves(trainer.model.trainable):
            t.add_(1.0)
    state = trainer.init_state()
    out = {"losses": [], "grad_norms": [], "blocks": {}, "same_tree": True}
    if "eval_batches" in inp:
        out["eval"] = _sharded_eval(inp, trainer, state)
    for step_batches in inp["batches"]:
        state, m = trainer.train_step(
            state, trainer.prepare_batch(step_batches[loader_rank()]))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = _flat_params(state)
    for tower, module in model.frozen.items():
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            out["blocks"][f"{tower}/{name}"] = (tuple(t.shape), str(t.dtype))
        want = flatten(inp["frozen"][tower])
        for k, v in flatten(params_of(module)).items():
            if not np.array_equal(np.asarray(v).view(np.uint8),
                                  np.asarray(want[k]).view(np.uint8)):
                out["same_tree"] = False
    out["frozen_bytes"] = trainer.frozen_bytes()
    return out


def _sharded_eval(inp, trainer, state):
    """An eval pass from the initial state over this rank's reader's
    ``eval_batches`` (loss and token accuracy of the global batches), and
    the global (loss, correct, tokens) of fixed per-reader sums."""
    from thinkdiff_torch.parallel.mesh import loader_rank
    from thinkdiff_torch.tasks.base_task import BaseTask, _global_eval_stats

    metrics = BaseTask(device="cpu").evaluation(
        trainer, state, iter(inp["eval_batches"][loader_rank()]),
        best_metric="token_acc")
    stats = _global_eval_stats(torch.tensor(2.5), torch.tensor(3.0),
                               torch.tensor(4))
    return {"metrics": metrics, "stats": [float(x) for x in stats]}


def run_qdense(inp, rank):
    """Sharded QDense layers (their names set their roles) against the
    whole ones: forward and dx on the same x and dy."""
    from torch import nn

    from thinkdiff_torch.models.bridge import load_params
    from thinkdiff_torch.models.qdense import QDense
    from thinkdiff_torch.parallel.sharding import shard_params

    mesh = _mesh(inp)
    out = {}
    for quant in (False, "int8", "w8a8"):
        box = nn.Module()
        for name, (k, n, unit) in inp["layers"].items():
            layer = QDense(k, n, torch.float32, quant, device="cpu",
                           train_layout=True)
            layer.tp_unit = unit
            setattr(box, name, layer)
        load_params(box, inp["weights"][str(quant)])
        shard_params(box, mesh, mesh.coords(rank))
        for name in inp["layers"]:
            x = torch.from_numpy(inp["x"][name]).requires_grad_(True)
            y = getattr(box, name)(x)
            y.backward(torch.from_numpy(inp["dy"][name]))
            out[(str(quant), name)] = (y.detach().numpy(), x.grad.numpy())
    return out


def run_seeded_build(inp, rank):
    """A model built from its seed with the mesh set first (each rank
    draws every leaf and keeps its block): its frozen trees gathered, and
    the bytes the rank holds."""
    from thinkdiff_torch.models import aligner_clip, aligner_lvlm
    from thinkdiff_torch.models.bridge import params_of

    _mesh(inp)
    cls = {"lvlm": aligner_lvlm.MllamaT5EmbedDecoder,
           "clip": aligner_clip.BlipVisionT5Decoder}[inp["arch"]]
    model = cls(inp["cfg"], seed=inp["seed"], device="cpu")
    held = sum(t.numel() * t.element_size() for m in model.frozen.values()
               for t in [*m.parameters(), *m.buffers()])
    return {"trees": {k: params_of(m) for k, m in model.frozen.items()},
            "held": held}


def _result(res):
    """A GenerationResult's tokens and hidden states as numpy (f32)."""
    return {"tokens": res.output_token_ids,
            "prompt_ids": res.prompt_token_ids,
            "hidden": [h.float().numpy() for h in res.hidden_states],
            "prompt_hidden": [h.float().numpy()
                              for h in res.prompt_hidden_states]}


def run_engine(inp, rank):
    """The embedding engine on ``inp["mesh"]`` for each of ``inp["cases"]``
    (a tiny Qwen2-VL config, its JAX-layout tree, engine keywords and one
    call: generate or generate_many over the global requests): the whole
    result every rank returns, and the bytes of the weights and of a KV
    cache the rank holds."""
    from PIL import Image

    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models import qwen2_vl as tq
    from thinkdiff_torch.parallel.mesh import Mesh

    mesh = Mesh(*inp["mesh"])
    out = {}
    for name, case in inp["cases"].items():
        vis = case["cfg"].get("vision")
        cfg = tq.Qwen2VLConfig.tiny(**{
            **case["cfg"], "vision": tq.Qwen2VLVisionConfig(**vis)})
        eng = te.EmbedEngine(
            cfg, case["params"], StandInTokenizer(
                inp["specials"], word_lo=1, word_hi=201),
            device="cpu", mesh=mesh, **case["engine"])
        samples = {"answers": case["prompts"]}
        if case.get("images") is not None:
            samples["images"] = [Image.fromarray(a) for a in case["images"]]
        for attr, value in case.get("set", {}).items():
            setattr(eng, attr, value)
        res = getattr(eng, case["call"])(samples, **case["call_kw"])
        out[name] = _result(res)
        out[name]["held"] = sum(
            t.numel() * t.element_size() for m in (eng.vision, eng.lm)
            for t in [*m.parameters(), *m.buffers()])
        out[name]["kv"] = tuple(eng._new_caches(1, 8)[0][0].shape)
    return out


def run_qwen_seeded(inp, rank):
    """The embedding engine on ``inp["mesh"]`` built from ``init_draw``'s
    seeded draw (each rank drawing every leaf, keeping its blocks) and from
    the JAX-layout tree ``inp["tree"]`` (block by block): both towers
    gathered back (``params_of``), and the bytes the rank holds."""
    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.models import qwen2_vl as tq
    from thinkdiff_torch.models.bridge import params_of
    from thinkdiff_torch.parallel.mesh import Mesh

    cfg = tq.Qwen2VLConfig.tiny(**{
        **inp["cfg"], "vision": tq.Qwen2VLVisionConfig(**inp["cfg"]["vision"])})
    mesh = Mesh(*inp["mesh"])
    draw = tq.init_draw(cfg, torch.Generator().manual_seed(inp["seed"]))
    out = {}
    for name, params in (("seeded", {"vision": draw, "lm": draw}),
                         ("tree", inp["tree"])):
        eng = te.EmbedEngine(cfg, params, device="cpu", mesh=mesh)
        out[name] = {"vision": params_of(eng.vision), "lm": params_of(eng.lm),
                     "held": sum(t.numel() * t.element_size()
                                 for m in (eng.vision, eng.lm)
                                 for t in [*m.parameters(), *m.buffers()])}
    return out


def _sampler_module(kind, case, device="cpu"):
    from thinkdiff_torch.models.bridge import load_params

    if kind == "flux":
        from thinkdiff_torch.models.flux import FluxConfig, FluxTransformer

        cfg = FluxConfig.tiny(**case["cfg"])
        return cfg, load_params(FluxTransformer(cfg, device=device),
                                case["params"])
    from thinkdiff_torch.models.cogvideox import (
        CogVideoXConfig, CogVideoXTransformer)

    cfg = CogVideoXConfig.tiny(**case["cfg"])
    return cfg, load_params(CogVideoXTransformer(cfg, device=device),
                            case["params"])


def run_sampler(inp, rank):
    """FluxSampler or CogVideoXSampler on ``inp["mesh"]`` over the whole
    model (cut by the sampler): ``denoise`` on the given latents, and each
    leaf's block shape."""
    from thinkdiff_torch.engines.flux_sampler import FluxSampler
    from thinkdiff_torch.models.cogvideox import CogVideoXSampler
    from thinkdiff_torch.parallel.mesh import Mesh

    mesh = Mesh(*inp["mesh"])
    cfg, module = _sampler_module(inp["kind"], inp)
    a = {k: torch.from_numpy(v) for k, v in inp["args"].items()}
    if inp["kind"] == "flux":
        sampler = FluxSampler(cfg, module, device="cpu", mesh=mesh)
        lat = sampler.denoise(a["latents"], a["txt"], a["pooled"],
                              a["img_ids"], a["txt_ids"], inp["sigmas"],
                              inp["guidance"])
    else:
        sampler = CogVideoXSampler(cfg, module, device="cpu", mesh=mesh)
        lat = sampler.denoise(a["latents"], a["text"], inp["steps"])
    blocks = {k: tuple(t.shape) for k, t in
              [*module.named_parameters(), *module.named_buffers()]}
    return {"latents": lat.numpy(), "blocks": blocks}


MODES = {"trainer": run_trainer, "eval": run_eval,
         "save_result": run_save_result, "precompute": run_precompute,
         "sharded_trainer": run_sharded_trainer, "qdense": run_qdense,
         "seeded_build": run_seeded_build, "engine": run_engine,
         "sampler": run_sampler, "qwen_seeded": run_qwen_seeded}


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
