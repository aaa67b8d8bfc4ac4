"""The CLIs' shared bootstrap (the port's ``scripts/common.py``): the
argument surface of the JAX package's scripts plus ``--device``, the
registry's imports, the seeds and the logger."""

from __future__ import annotations

import argparse
import random

import numpy as np


def parse_args(description: str, argv=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg-path", required=True, help="config YAML")
    parser.add_argument("--options", nargs="+", default=None,
                        help="overrides: a.b=c or 'a.b c' pairs")
    parser.add_argument("--job-id", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; needs a card) or cpu")
    return parser.parse_args(argv)


def setup_seeds(seed: int) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def bootstrap(args):
    """-> (cfg, task). The imports fill the port's registry; the launcher's
    world is joined (its rank's card made current) and the device resolved
    before anything is built, so ``cuda`` is rank r's card r, and a run
    without a card stops here unless it asks for the CPU."""
    import thinkdiff_torch.data.builders  # noqa: F401
    import thinkdiff_torch.data.processors  # noqa: F401
    import thinkdiff_torch.engines.embed_engine  # noqa: F401
    import thinkdiff_torch.models.aligner_clip  # noqa: F401
    import thinkdiff_torch.models.aligner_lvlm  # noqa: F401
    import thinkdiff_torch.runners  # noqa: F401
    from thinkdiff_torch import resolve_device
    from thinkdiff_torch.core.config import Config
    from thinkdiff_torch.core.distributed import get_rank, init_distributed_mode
    from thinkdiff_torch.core.logging import setup_logger
    from thinkdiff_torch.tasks import setup_task

    cfg = Config(args)
    init_distributed_mode(cfg.run_cfg, args.device)
    device = resolve_device(args.device)
    setup_seeds(int(cfg.run_cfg.get("seed", 42)) + get_rank())
    setup_logger()
    cfg.pretty_print()
    return cfg, setup_task(cfg, device=device)


def build_runner(cfg, task, model, datasets, job_id, default_runner: str):
    from thinkdiff_torch.core.registry import registry

    name = cfg.run_cfg.get("runner", default_runner)
    runner_cls = registry.get_runner_class(name)
    if runner_cls is None:
        raise KeyError(f"Unknown runner '{name}'")
    return runner_cls(cfg=cfg, task=task, model=model, datasets=datasets,
                      job_id=job_id)
