"""Process helpers of the port (counterpart of
thinkdiff_tpu/core/distributed.py): one process on one card, rank 0 of a
world of 1. The loaders take the rank and world size, so they keep their
shape when ``torch.distributed`` comes.
"""

from __future__ import annotations

import os


def init_distributed_mode(run_cfg=None) -> None:
    """Records rank 0 of 1 in ``run_cfg``. A launcher's world of more than
    one process is refused: the port runs one process on one card."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world}: the port runs one process on one card")
    if run_cfg is not None:
        run_cfg["rank"] = get_rank()
        run_cfg["world_size"] = get_world_size()
        run_cfg["distributed"] = False


def get_rank() -> int:
    return 0


def get_world_size() -> int:
    return 1


def is_main_process() -> bool:
    return get_rank() == 0
