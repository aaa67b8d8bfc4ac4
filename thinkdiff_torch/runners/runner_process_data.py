"""One-pass data-processing driver (counterpart of
thinkdiff_tpu/runners/runner_process_data.py): runs the precompute task
over an indexed wids dataset and writes the embedding shards.

Over several ranks each rank reads its own indices of the dataset, serves
them with its own engine on its own card, and writes its own shard range,
from ``output_shard_path[2] + rank * 100000`` on, as the JAX processes
do; the ranks wait for each other at the end."""

from __future__ import annotations

import logging
from typing import Any, Dict

from thinkdiff_torch.core.distributed import barrier, get_rank, get_world_size
from thinkdiff_torch.core.registry import registry

logger = logging.getLogger(__name__)


@registry.register_runner("runner_process_data")
class RunnerProcessData:
    def __init__(self, cfg, task, model, datasets, job_id=None):
        self.config = cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        run = cfg.run_cfg
        self.output_shard_path = list(run.get("output_shard_path"))
        self.seed = int(run.get("seed", 42))
        self.log_freq = int(run.get("log_freq", 1))
        self.max_batches = run.get("max_batches", None)

    def train(self) -> Dict[str, Any]:
        """Exactly one pass over the first dataset's first split."""
        for splits in self.datasets.values():
            for bundle in splits.values():
                loader = bundle.get_loader(rank=get_rank(),
                                           world_size=get_world_size(),
                                           seed=self.seed, epoch=0)
                shard_path = list(self.output_shard_path)
                if get_world_size() > 1:
                    shard_path[2] = int(shard_path[2]) + get_rank() * 100000
                stats = self.task.process_epoch(
                    self.model, loader, shard_path,
                    log_freq=self.log_freq, max_batches=self.max_batches)
                barrier()
                return stats
        raise RuntimeError("No datasets to process")
