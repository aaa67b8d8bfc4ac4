"""Stage 2, the training CLI (the port's ``train.py``):

    python -m thinkdiff_torch.train --cfg-path cfg.yaml \\
        [--options run.seed=7 ...] [--job-id NAME] [--device cpu]

Builds the task, its datasets and model, and runs the runner the config
names; ``run.resume_ckpt_path`` resumes from a checkpoint. On N cards:

    python -m torch.distributed.run --nproc_per_node N \
        -m thinkdiff_torch.train --cfg-path cfg.yaml

(each rank trains on ``batch_size_train`` rows: the global batch is N x
that, and rank 0's job id names the one output directory).
"""

from __future__ import annotations

from thinkdiff_torch.scripts.common import bootstrap, build_runner, parse_args


def main(argv=None):
    args = parse_args("ThinkDiff training (PyTorch)", argv)
    cfg, task = bootstrap(args)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)

    from thinkdiff_torch.core.distributed import (
        broadcast_object, is_main_process)
    from thinkdiff_torch.core.utils import now

    # the clock may turn between the ranks' reads: rank 0's id for all
    job_id = broadcast_object(args.job_id or now())
    if cfg.run_cfg.get("wandb_log", False):
        from thinkdiff_torch.core.logging import init_wandb

        if is_main_process():
            init_wandb(cfg, job_id)
    runner = build_runner(cfg, task, model, datasets, job_id, "runner_base")
    runner.train()
    return runner


if __name__ == "__main__":
    main()
