"""Process helpers of the port (counterpart of
thinkdiff_tpu/core/distributed.py): one rank a process, one card a rank,
over ``torch.distributed``.

A launcher (``python -m torch.distributed.run``, i.e. torchrun) sets
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT. ``init_distributed_mode`` joins that world; rank r of W is
JAX process r of W: it reads what that process reads and holds a
replica of the trainable state. A world of one makes no process group.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Any, List, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed_mode(run_cfg=None, device="cuda") -> None:
    """Joins the launcher's world, the rank's card made current before
    anything touches it, and records ``rank``, ``world_size`` and
    ``distributed`` in ``run_cfg``.

    The backend: NCCL when every local rank has a card of its own; gloo on
    the CPU, and gloo when ranks share a card (NCCL refuses two ranks on
    one device; gloo's collectives take CUDA tensors, through the host, so
    the ranks still compute and launch their kernels on the card). A
    process group the caller made already is used as it is. A failure to
    join raises, as does ``cuda`` without a card: nothing carries on as
    rank 0 of 1 or on the CPU.
    """
    from thinkdiff_torch import resolve_device

    world = _env_int("WORLD_SIZE", 1)
    cuda = torch.device(device).type == "cuda"
    if cuda and torch.cuda.is_available():
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0)
                              % torch.cuda.device_count())
    resolve_device(device)   # no card: raise before joining the world
    if world > 1 and not is_dist_avail_and_initialized():
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        if not cuda:
            backend, kw = "gloo", {}
        elif torch.cuda.device_count() >= local_world:
            backend = "nccl"
            kw = {"device_id": torch.device("cuda", torch.cuda.current_device())}
        else:
            backend, kw = "gloo", {}
            logger.warning(
                "%d local ranks share %d card(s): gloo (NCCL refuses two "
                "ranks on one device); collectives go through the host",
                local_world, torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=_env_int("RANK", 0),
                                **kw)
    if run_cfg is not None:
        run_cfg["rank"] = get_rank()
        run_cfg["world_size"] = get_world_size()
        run_cfg["distributed"] = get_world_size() > 1
    logger.info("rank %d of %d (%s)", get_rank(), get_world_size(),
                dist.get_backend() if is_dist_avail_and_initialized()
                else "no process group")


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Runs ``func`` on rank 0 only."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)

    return wrapper


def barrier() -> None:
    """Waits for every rank (nothing without a process group)."""
    if is_dist_avail_and_initialized():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returned."""
    if get_world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_min(value: int) -> int:
    """The smallest of the ranks' ``value``s."""
    if get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values into every rank's ``tensors``, in place, as one
    flat buffer a dtype."""
    if get_world_size() == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if get_world_size() == 1:
        return obj
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src, device=comm_device())
    return box[0]


def comm_device() -> torch.device:
    """Where the process group's small tensors live: the current card for
    NCCL, the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
