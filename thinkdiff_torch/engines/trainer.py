"""The training engine for one card (counterpart of
thinkdiff_tpu/engines/trainer.py).

One step = loss -> gradient of the trainable tree -> AdamW update, eagerly.
The trainable parameters are f32 master copies; the model computes in its
dtype. There is no mesh: one card, data on its device. Unlike the JAX
step, which donates its state and returns a new one, ``train_step`` updates
the state's parameters and moments in place and returns the same dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from thinkdiff_torch import resolve_device
from thinkdiff_torch.core.optim import (
    global_norm, make_optimizer, tree_leaves, tree_map)


def _tree_like(template: Dict[str, Any], values) -> Dict[str, Any]:
    """The tree of ``template`` with its leaves, in tree_leaves order,
    replaced by ``values``."""
    it = iter(values)

    def rec(node):
        return {k: rec(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return rec(template)


class Trainer:
    def __init__(self, model, run_cfg: Dict[str, Any], device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.run_cfg = run_cfg
        self.tx, self.schedule = make_optimizer(run_cfg,
                                                model.trainable_params())
        self.frozen = model.frozen

    # -- state --------------------------------------------------------------
    def init_state(self) -> Dict[str, Any]:
        params = tree_map(lambda x: x.detach().to(self.device, torch.float32,
                                                  copy=True),
                          self.model.trainable_params())
        return {"params": params, "opt_state": self.tx.init(params),
                "step": 0}

    def prepare_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Host numpy -> tensors on the device (pinned, non-blocking copies
        to a card)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _generator(self, rng: Optional[int], step: int):
        if rng is None or not self.model.drop_rate:
            return None
        return torch.Generator(device=self.device).manual_seed(
            (int(rng) * 1_000_003 + step) % (1 << 63))

    # -- step ---------------------------------------------------------------
    def train_step(self, state, batch, rng: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One optimizer micro-step. ``rng`` seeds the input dropout (folded
        with the step). Metrics: loss and grad_norm as device scalars, lr
        (the schedule at this step) as a float."""
        params, step = state["params"], state["step"]
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = self.model.loss_fn(params, self.frozen, batch,
                                      self._generator(rng, step))
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _tree_like(params, grads)
        metrics = {"loss": loss.detach(), "lr": self.schedule(step),
                   "grad_norm": global_norm(grads)}
        self.tx.update(grads, state["opt_state"], params)
        state["step"] = step + 1
        return state, metrics

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, state, batch) -> torch.Tensor:
        return self.model.loss_fn(state["params"], self.frozen, batch, None)

    def eval_metrics_step(self, state, batch):
        """(loss, n_correct, n_tokens) from the model's eval_metrics_fn, or
        None when it has none."""
        fn = getattr(self.model, "eval_metrics_fn", None)
        if fn is None:
            return None
        return fn(state["params"], self.frozen, batch)
