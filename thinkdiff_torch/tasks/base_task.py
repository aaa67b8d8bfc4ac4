"""Tasks: the loop bodies of the jobs (counterpart of
thinkdiff_tpu/tasks/base_task.py).

``train_epoch`` pulls collated batches, puts them on the device and calls
the trainer's step. As in the JAX task, each step's metrics are read one
step late: right after a step is queued its loss starts a non-blocking
copy into pinned memory behind an event, and that copy is read after the
next step is queued, so the host never waits for the step it has just
queued.

Over several ranks the step's loss is already the global one (the
trainer's all-reduce), the epoch's meters are summed over the ranks at its
end, evaluation reduces each batch's loss and accuracy counts over the
ranks, which run the same number of eval batches, and ``save_result``
merges the ranks' result files on rank 0.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from thinkdiff_torch.core.distributed import (
    all_reduce_min, all_reduce_sum, barrier, get_rank, get_world_size,
    is_main_process)
from thinkdiff_torch.core.logging import MetricLogger, SmoothedValue
from thinkdiff_torch.core.registry import registry

logger = logging.getLogger(__name__)


def setup_task(cfg, device="cuda"):
    """The task ``run.task`` names, whose models are built on ``device``."""
    name = cfg.run_cfg.task
    task_cls = registry.get_task_class(name)
    if task_cls is None:
        raise KeyError(f"Unknown task '{name}'")
    return task_cls.setup_task(cfg=cfg, device=device)


class _LateScalar:
    """A device scalar copied to the host without blocking; ``float()``
    waits for that copy only."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self._host.copy_(t.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach()

    def __float__(self) -> float:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return float(self._host)


class BaseTask:
    def __init__(self, device="cuda", **kwargs):
        self.device = device

    @classmethod
    def setup_task(cls, device="cuda", **kwargs):
        return cls(device=device)

    def build_model(self, cfg):
        model_cfg = cfg.model_cfg
        model_cls = registry.get_model_class(model_cfg.arch)
        if model_cls is None:
            raise KeyError(f"Unknown model arch '{model_cfg.arch}'")
        model = model_cls.from_config(model_cfg, device=self.device)
        model.load_checkpoint_from_config(model_cfg)
        return model

    def build_datasets(self, cfg) -> Dict[str, Any]:
        """{dataset_name: {split: DatasetBundle}} from the registry's
        builders; an ``evaluation_datasets`` section adds eval splits."""
        datasets = {}
        model_cfg = getattr(cfg, "model_cfg", None)
        for name, ds_cfg in cfg.datasets_cfg.items():
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"Unknown dataset builder '{name}'")
            # the reference declares collation knobs on the model section
            splits = builder_cls(ds_cfg, model_cfg=model_cfg).build_datasets()
            if "sample_ratio" in ds_cfg and "train" in splits:
                splits["train"].sample_ratio = float(ds_cfg["sample_ratio"])
            datasets[name] = splits
        eval_cfg = getattr(cfg, "evaluation_datasets_cfg", None) or {}
        for name, ds_cfg in eval_cfg.items():
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"Unknown eval dataset builder '{name}'")
            built = builder_cls(ds_cfg, model_cfg=model_cfg).build_datasets()
            datasets[name] = {"eval": built.get("eval", built.get("train"))}
        return datasets

    def inject_tokenizers(self, model, datasets):
        t5_tok = getattr(model, "t5_tokenizer", None)
        if t5_tok is None and hasattr(model, "get_t5_tokenizer"):
            t5_tok = model.get_t5_tokenizer()
        vlm_decode = (model.get_vlm_decode_fn()
                      if hasattr(model, "get_vlm_decode_fn") else None)
        for splits in datasets.values():
            for bundle in splits.values():
                bundle.set_tokenizers(t5_tok, vlm_decode)

    # -- the hot loop --------------------------------------------------------
    def train_epoch(self, epoch: int, trainer, state, data_loader,
                    iters_per_epoch: int, log_freq: int = 50,
                    accum_grad_iters: int = 1, seed: int = 42,
                    wandb_log: bool = False,
                    profile_dir: Optional[str] = None):
        """``iters_per_epoch`` micro-steps; returns (state, the epoch's
        averaged metrics as strings). Accumulation happens in the
        optimizer; wandb is logged once an optimizer step. With
        ``profile_dir``, epoch 0's iterations are traced by torch.profiler
        into ``profile_dir/trace_rank{rank}.json`` (a Chrome trace)."""
        prof = None
        if profile_dir and epoch == 0:
            prof = _start_profile(trainer.device)
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=50,
                                                    fmt="{value:.6f}"))
        metric_logger.add_meter("loss", SmoothedValue(window_size=50,
                                                      fmt="{value:.4f}"))
        header = f"Train: data epoch: [{epoch}]"
        rng = seed + get_rank()
        data_iter = iter(data_loader)
        inner = metric_logger.log_every(range(iters_per_epoch), log_freq,
                                        header)
        pending = None
        pending_i = 0

        def flush(metrics, i):
            loss, lr = float(metrics["loss"]), float(metrics["lr"])
            metric_logger.update(loss=loss, lr=lr)
            if wandb_log and (i + 1) % max(accum_grad_iters, 1) == 0:
                self._wandb_step(loss, lr)

        for i in inner:
            batch = trainer.prepare_batch(next(data_iter))
            state, metrics = trainer.train_step(state, batch, rng)
            late = {"loss": _LateScalar(metrics["loss"]), "lr": metrics["lr"]}
            if pending is not None:
                flush(pending, pending_i)
            pending, pending_i = late, i
        if pending is not None:
            flush(pending, pending_i)
        if prof is not None:
            _stop_profile(prof, profile_dir)
        metric_logger.synchronize_between_processes()
        logger.info("Averaged stats: %s", metric_logger.global_avg())
        stats = {k: "{:.6f}".format(m.global_avg)
                 for k, m in metric_logger.meters.items()}
        return state, stats

    @staticmethod
    def _wandb_step(loss: float, lr: float):
        if is_main_process():
            from thinkdiff_torch.core.logging import wandb_log

            wandb_log({"loss": loss, "lr": lr})

    def evaluation(self, trainer, state, data_loader,
                   max_batches: Optional[int] = None,
                   best_metric: str = "loss"):
        """An eval pass. ``agg_metrics`` (the runner keeps the checkpoint
        with the highest) is -mean(loss), or with ``best_metric:
        token_acc`` the token-weighted teacher-forced accuracy. Over
        several ranks each batch's loss is the token mean of the global
        batch and the accuracy counts are summed, so every rank returns
        the same metrics; before each batch the ranks agree to go on only
        while every one of them has a batch (one rank's loader may run
        out first), so their collectives stay in step."""
        losses = []
        correct = total = 0.0
        want_acc = best_metric == "token_acc"
        distributed = get_world_size() > 1
        data_iter = iter(data_loader)
        i = 0
        while max_batches is None or i < max_batches:
            batch = next(data_iter, None)
            if distributed and not all_reduce_min(batch is not None):
                break
            if batch is None:
                break
            i += 1
            batch = trainer.prepare_batch(batch)
            stats = trainer.eval_metrics_step(state, batch) if want_acc else None
            if stats is None:
                want_acc = False
                loss = trainer.eval_step(state, batch)
                stats = (loss, torch.zeros_like(loss),
                         trainer.model.label_count(batch))
            if distributed:
                stats = _global_eval_stats(*stats)
            loss, n_ok, n_tok = (float(x) for x in stats)
            losses.append(loss)
            correct += n_ok
            total += n_tok
        out = {"agg_metrics": -float(np.mean(losses)) if losses else 0.0,
               "loss": float(np.mean(losses)) if losses else 0.0}
        if want_acc and total:
            out["token_acc"] = correct / total
            out["agg_metrics"] = out["token_acc"]
        return out


def _global_eval_stats(loss, n_ok, n_tok):
    """(the global batch's token-mean loss, correct, tokens) from this
    rank's: one all-reduce of [loss x tokens, correct, tokens]."""
    n_tok = n_tok.float()
    t = torch.stack([loss.float() * n_tok, n_ok.float(), n_tok])
    all_reduce_sum(t)
    return t[0] / t[2].clamp(min=1.0), t[1], t[2]


def _start_profile(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> str:
    """Ends the trace and writes it as profile_dir/trace_rank{rank}.json."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{get_rank()}.json")
    prof.export_chrome_trace(path)
    logger.info("training trace of epoch 0 written to %s", path)
    return path


def save_result(result, result_dir: str, filename: str,
                remove_duplicate: str = "") -> str:
    """The ranks' results merged: each rank writes
    ``{filename}_rank{r}.json``; after a barrier rank 0 concatenates them
    in rank order (keeping the first item of each ``remove_duplicate``
    key) into ``{filename}.json``; a second barrier lets no rank read it
    early. Returns the merged file's path."""
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, f"{filename}_rank{get_rank()}.json"),
              "w") as f:
        json.dump(result, f)
    barrier()
    final_file = os.path.join(result_dir, f"{filename}.json")
    if is_main_process():
        merged = []
        for rank in range(get_world_size()):
            with open(os.path.join(result_dir,
                                   f"{filename}_rank{rank}.json")) as f:
                merged += json.load(f)
        if remove_duplicate:
            seen, deduped = set(), []
            for item in merged:
                key = item.get(remove_duplicate)
                if key not in seen:
                    seen.add(key)
                    deduped.append(item)
            merged = deduped
        with open(final_file, "w") as f:
            json.dump(merged, f)
        logger.info("result file saved to %s", final_file)
    barrier()
    return final_file


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    """Aligner pretraining (its evaluation is the base task's)."""
