"""Host-side metric smoothing and progress logging (counterpart of
thinkdiff_tpu/core/logging.py): ``SmoothedValue``, ``MetricLogger``,
``setup_logger`` and the optional wandb hooks. wandb is imported only when
a run asks for it (``run.wandb_log``); without it the run goes on.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque

import numpy as np

from thinkdiff_torch.core.distributed import (
    all_reduce_sum, comm_device, get_rank, get_world_size)


class SmoothedValue:
    """A series of values with window-smoothed and global averages."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """[count, total] summed over the ranks, in float64 on the process
        group's device (the window stays this rank's)."""
        if get_world_size() == 1:
            return
        import torch

        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=comm_device())
        all_reduce_sum(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


def _device_memory_mb() -> float:
    """MB the caching allocator holds in tensors on the current card; 0
    without one (a CPU run)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0.0
    return torch.cuda.memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = v.item()
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def global_avg(self):
        return self.delimiter.join(
            f"{n}: {m.global_avg:.4f}" for n, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        logger = logging.getLogger(__name__)
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    progress = f"[{i:{len(str(total))}d}/{total}]"
                    eta_s = f"eta: {eta}"
                else:
                    progress, eta_s = f"[{i}]", ""
                logger.info(self.delimiter.join(filter(None, [
                    header, progress, eta_s, str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                    f"mem: {_device_memory_mb():.0f}MB"])))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        logger.info("%s Total time: %s (%.4f s / it)", header,
                    datetime.timedelta(seconds=int(total_time)),
                    total_time / max(i, 1))


def setup_logger(level=None):
    """INFO on rank 0, WARN elsewhere."""
    if level is None:
        level = logging.INFO if get_rank() == 0 else logging.WARN
    logging.basicConfig(
        level=level, format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        force=True)


_wandb = None


def init_wandb(cfg, job_id: str):
    """Starts a wandb run if wandb is installed; returns it or None."""
    global _wandb
    try:
        import wandb
    except ImportError:
        logging.getLogger(__name__).warning(
            "wandb_log requested but wandb is not installed; "
            "continuing without it")
        return None
    run_cfg = cfg.run_cfg
    _wandb = wandb
    wandb.init(project=str(run_cfg.get("wandb_project_name", "thinkdiff")),
               name=str(run_cfg.get("job_name", job_id)),
               config=cfg.to_dict())
    return wandb.run


def wandb_log(metrics):
    """Logs ``metrics`` when a wandb run is active; otherwise nothing."""
    if _wandb is not None and getattr(_wandb, "run", None) is not None:
        _wandb.log(metrics)
