"""Epoch training driver (counterpart of
thinkdiff_tpu/runners/runner_base.py): output directory, the Trainer on the
model's device, loaders from the dataset bundles, the epoch loop with
per-epoch evaluation and the best checkpoint, the final test-split
evaluation from the best, resume, and ``log.txt`` (one JSON object a
line).

Over several ranks (``run.mesh: {data, fsdp, model}`` covers the world;
fsdp and model shard the frozen towers by JAX's rules): rank 0 makes the
output directory before any rank writes under it and alone writes the
checkpoints and ``log.txt``; every (data, fsdp) coordinate reads its
slice of each split (its ``model`` peers read the same), every rank
resumes onto its own card and waits for the others after each epoch.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

from thinkdiff_torch.core.distributed import barrier, is_main_process
from thinkdiff_torch.core.registry import registry
from thinkdiff_torch.core.utils import append_json_line
from thinkdiff_torch.engines.checkpoint import CheckpointManager
from thinkdiff_torch.engines.trainer import Trainer
from thinkdiff_torch.parallel.mesh import (
    loader_rank, loader_world, mesh_from_config)

logger = logging.getLogger(__name__)


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets, job_id: Optional[str] = None):
        self.config = cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id or "job"

        run = cfg.run_cfg
        self.max_epoch = int(run.get("max_epoch", 1))
        self.iters_per_epoch = int(run.get("iters_per_epoch", 1000))
        self.log_freq = int(run.get("log_freq", 50))
        self.seed = int(run.get("seed", 42))
        self.accum_grad_iters = int(run.get("accum_grad_iters", 1))
        self.evaluate_only = bool(run.get("evaluate", False))
        self.resume_ckpt_path = run.get("resume_ckpt_path", None)
        self.train_splits = list(run.get("train_splits", ["train"]))
        self.valid_splits = list(run.get("valid_splits", []))
        self.test_splits = list(run.get("test_splits", []))

        root = registry.get_path("repo_root") or "."
        self.output_dir = os.path.join(root, str(run.get("output_dir",
                                                         "output")),
                                       self.job_id)
        self.result_dir = os.path.join(self.output_dir, "result")
        if is_main_process():
            os.makedirs(self.result_dir, exist_ok=True)
        barrier()

        self.mesh = mesh_from_config(run)
        self.trainer = Trainer(model, run, device=model.device,
                               mesh=self.mesh)
        self.ckpt = CheckpointManager(self.output_dir)
        self.start_epoch = 0
        self.state = None

    # -- data ---------------------------------------------------------------
    def train_loader(self, epoch: int):
        """The train bundles' loaders, a new one each epoch (seeded with the
        epoch); several datasets are mixed by their ``sample_ratio``."""
        loaders, ratios = [], []
        for splits in self.datasets.values():
            for split in self.train_splits:
                if split not in splits:
                    continue
                bundle = splits[split]
                batch = bundle.batch_size or int(
                    self.config.run_cfg.get("batch_size_train", 32))
                loaders.append(bundle.get_loader(
                    batch_size=batch, rank=loader_rank(),
                    world_size=loader_world(), seed=self.seed, epoch=epoch))
                ratios.append(float(getattr(bundle, "sample_ratio", 1.0) or 1.0))
        if not loaders:
            raise RuntimeError("No train split found in datasets")
        if len(loaders) == 1:
            return loaders[0]
        from thinkdiff_torch.data.pipeline import MultiIterLoader

        logger.info("Mixing %d train datasets with ratios %s",
                    len(loaders), ratios)
        return MultiIterLoader([iter(ld) for ld in loaders], ratios,
                               seed=self.seed + epoch)

    def _eval_loader(self, bundle, epoch):
        # use_dist_eval_sampler False: every process sees the whole set
        dist = bool(self.config.run_cfg.get("use_dist_eval_sampler", True))
        return bundle.get_loader(rank=loader_rank() if dist else 0,
                                 world_size=loader_world() if dist else 1,
                                 seed=self.seed, epoch=epoch)

    def _evaluate_split(self, split, bundle, epoch):
        run = self.config.run_cfg
        return self.task.evaluation(
            self.trainer, self.state, self._eval_loader(bundle, epoch),
            max_batches=run.get("max_eval_batches", None),
            best_metric=run.get("best_metric", "loss"))

    # -- training -----------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        start_time = time.time()
        best_agg = -1e18
        self.task.inject_tokenizers(self.model, self.datasets)
        self.state = self.trainer.init_state()
        if self.resume_ckpt_path:
            self._load_checkpoint(self.resume_ckpt_path)
        self.log_config()

        stats_all = {}
        run = self.config.run_cfg
        for epoch in range(self.start_epoch, self.max_epoch):
            if not self.evaluate_only:
                logger.info("Start training epoch %d", epoch)
                self.state, stats = self.task.train_epoch(
                    epoch, self.trainer, self.state, self.train_loader(epoch),
                    iters_per_epoch=self.iters_per_epoch,
                    log_freq=self.log_freq,
                    accum_grad_iters=self.accum_grad_iters, seed=self.seed,
                    wandb_log=bool(run.get("wandb_log", False)),
                    profile_dir=run.get("profile_dir", None))
                self.log_stats(stats, split_name="train", epoch=epoch)
                stats_all = stats
                if is_main_process():
                    self.ckpt.save(self.state, epoch,
                                   config=self.config.to_dict())
                    self.model.load_trainable(self.state["params"])

            for split in self.valid_splits:
                for splits in self.datasets.values():
                    if split not in splits:
                        continue
                    val = self._evaluate_split(split, splits[split], epoch)
                    self.log_stats(val, split_name=split, epoch=epoch)
                    # agg_metrics is the same on every rank
                    if val["agg_metrics"] > best_agg:
                        best_agg = val["agg_metrics"]
                        if is_main_process():
                            self.ckpt.save(self.state, epoch, is_best=True,
                                           config=self.config.to_dict())
            barrier()
            if self.evaluate_only:
                break

        # the test splits from the best checkpoint (evaluate-only: the
        # given checkpoint as it is)
        if self.test_splits:
            self.evaluate(cur_epoch="best", skip_reload=self.evaluate_only)
        logger.info("Training time %.1f s", time.time() - start_time)
        return stats_all

    def evaluate(self, cur_epoch="best", skip_reload: bool = False
                 ) -> Dict[str, Any]:
        """Every test split, after reloading the best checkpoint unless
        ``skip_reload``."""
        results: Dict[str, Any] = {}
        if not skip_reload and cur_epoch == "best":
            self._reload_best_model()
        for split in self.test_splits:
            for splits in self.datasets.values():
                if split not in splits:
                    continue
                val = self._evaluate_split(split, splits[split], 0)
                self.log_stats(val, split_name=split, epoch=cur_epoch)
                results[split] = val
        barrier()
        return results

    def _reload_best_model(self) -> bool:
        """checkpoint_best's trainable parameters into the live state (the
        optimizer state stays as it is)."""
        path = self.ckpt.path("best")
        if not os.path.exists(path):
            logger.warning("No best checkpoint found; evaluating current state")
            return False
        restored = self.ckpt.load(path, self.trainer.device)
        self.state = {**self.state, "params": restored["params"]}
        self.model.load_trainable(self.state["params"])
        logger.info("Reloaded best checkpoint for final evaluation")
        return True

    # -- checkpoint ---------------------------------------------------------
    def _load_checkpoint(self, path: str):
        """Every rank loads the checkpoint onto its own card; rank 0's
        state is then broadcast, so the replicas are equal."""
        restored = self.ckpt.load(path, self.trainer.device)
        self.state = self.trainer.sync_state(
            {k: restored[k] for k in ("params", "opt_state", "step")})
        self.start_epoch = restored["epoch"] + 1

    # -- logging ------------------------------------------------------------
    def log_config(self):
        if is_main_process():
            append_json_line(self.config.to_dict(),
                             os.path.join(self.output_dir, "log.txt"))

    def log_stats(self, stats: Dict[str, Any], split_name: str, epoch):
        if is_main_process():
            entry = {f"{split_name}_{k}": v for k, v in stats.items()}
            entry["epoch"] = epoch
            append_json_line(entry, os.path.join(self.output_dir, "log.txt"))


@registry.register_runner("runner_clip_t5")
class RunnerClipT5(RunnerBase):
    """The reference's runner_clip_t5 differed only in its collate plumbing,
    which the builders own here: the same runner under its name."""
