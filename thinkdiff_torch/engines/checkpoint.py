"""Training checkpoints of the port (counterpart of
thinkdiff_tpu/engines/checkpoint.py): ``checkpoint_{epoch|best}.pth``,
written with ``torch.save``, holding

  - ``model``: the trainable leaves on the CPU under their JAX paths
    (``projector/layer_0/kernel``, ``models/bridge.py``'s keys);
  - ``optimizer``: the AdamW count and moments (and the accumulation
    state when ``accum_grad_iters`` > 1), moments keyed the same way;
  - ``step`` and ``epoch``;

with the run's config beside it as ``checkpoint_{tag}.config.json``.
Only the trainable parameters are saved: the frozen tower comes from the
model's own weights.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import torch

from thinkdiff_torch.core.optim import tree_map
from thinkdiff_torch.models.bridge import flatten, unflatten

logger = logging.getLogger(__name__)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().clone()


def optimizer_state_dict(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The AdamW state with its trees flattened to JAX paths, on the CPU."""
    return {k: ({p: _cpu(t) for p, t in flatten(v).items()}
                if isinstance(v, dict) else v)
            for k, v in opt_state.items()}


def load_optimizer_state(sd: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: (tree_map(lambda t: t.to(device, copy=True), unflatten(v))
                if isinstance(v, dict) else v)
            for k, v in sd.items()}


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def path(self, tag) -> str:
        return os.path.join(self.output_dir, f"checkpoint_{tag}.pth")

    def save(self, state: Dict[str, Any], epoch: int,
             config: Optional[Dict] = None, is_best: bool = False) -> str:
        path = self.path("best" if is_best else epoch)
        payload = {
            "model": {p: _cpu(t) for p, t in flatten(state["params"]).items()},
            "optimizer": optimizer_state_dict(state["opt_state"]),
            "step": int(state["step"]),
            "epoch": int(epoch),
        }
        torch.save(payload, path)
        if config is not None:
            with open(path[: -len(".pth")] + ".config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)
        logger.info("Saved checkpoint to %s", path)
        return path

    @staticmethod
    def load(path: str, device) -> Dict[str, Any]:
        """-> {"params", "opt_state", "step", "epoch"}, the tensors on
        ``device``."""
        ck = torch.load(path, map_location="cpu", weights_only=True)
        out = {
            "params": tree_map(lambda t: t.to(device, copy=True),
                               unflatten(ck["model"])),
            "opt_state": load_optimizer_state(ck["optimizer"], device),
            "step": int(ck["step"]),
            "epoch": int(ck["epoch"]),
        }
        logger.info("Resumed checkpoint from %s (epoch %d)", path,
                    out["epoch"])
        return out
