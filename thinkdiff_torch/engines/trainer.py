"""The training engine (counterpart of thinkdiff_tpu/engines/trainer.py).

One step = loss -> gradient of the trainable tree -> AdamW update, eagerly.
The trainable parameters are f32 master copies; the model computes in its
dtype. Unlike the JAX step, which donates its state and returns a new one,
``train_step`` updates the state's parameters and moments in place and
returns the same dicts. Spans (``core/trace.py``): ``train.prepare_batch``,
and ``train.step`` around ``train.forward`` (the loss, chunked CE
included), ``train.backward``, ``train.allreduce`` (several ranks only)
and ``train.optimizer`` (AdamW and its clip).

Over several ranks (``core.distributed``) each rank holds a replica of the
state and its own slice of the global batch, and the step computes what
GSPMD computes over JAX's ``data`` axis: the gradient of the GLOBAL
token-mean loss. Each rank differentiates the sum of its token losses;
one all-reduce of a flat buffer (the gradients, that sum and the rank's
label count) gives the global sums, divided by the global count. Ranks
with unequal label counts (padding, packing) thus weigh each token alike,
where the mean of the ranks' mean-loss gradients would not. AdamW, its
clip and ``grad_norm`` read the reduced gradient, so every rank takes the
same update. A world of one runs the single-card step unchanged.

On a sharded mesh (``run.mesh`` with fsdp or model > 1) the frozen towers
hold each rank's blocks of JAX's placement (``parallel/sharding.py``;
a model built whole is cut here) and the trainable projector stays
replicated. The ``model`` peers of one (data, fsdp) coordinate read the
same batch and reduce inside the tower, so they end the backward with
the same gradient; the all-reduce stays one over the whole world, where
each (data, fsdp) coordinate's sums arrive M times, numerator and
denominator alike, so the global token mean is unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from thinkdiff_torch import resolve_device
from thinkdiff_torch.core.distributed import (
    all_reduce_sum, broadcast_tensors, get_world_size)
from thinkdiff_torch.core.optim import (
    global_norm, make_optimizer, tree_leaves, tree_map)
from thinkdiff_torch.core.trace import span
from thinkdiff_torch.parallel.mesh import current_mesh, set_mesh


def _tree_like(template: Dict[str, Any], values) -> Dict[str, Any]:
    """The tree of ``template`` with its leaves, in tree_leaves order,
    replaced by ``values``."""
    it = iter(values)

    def rec(node):
        return {k: rec(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return rec(template)


class Trainer:
    def __init__(self, model, run_cfg: Dict[str, Any], device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.run_cfg = run_cfg
        self.mesh = set_mesh(mesh) if mesh is not None else current_mesh()
        self.tx, self.schedule = make_optimizer(run_cfg,
                                                model.trainable_params())
        if self.mesh is not None and self.mesh.sharded:
            from thinkdiff_torch.core.distributed import get_rank
            from thinkdiff_torch.parallel.sharding import (
                is_sharded, shard_params)

            for tower in model.frozen.values():
                if not is_sharded(tower):
                    shard_params(tower, self.mesh,
                                 self.mesh.coords(get_rank()))
        self.frozen = model.frozen

    def frozen_bytes(self) -> int:
        """Bytes of this rank's frozen leaves (its blocks on a sharded
        mesh)."""
        return sum(t.numel() * t.element_size()
                   for tower in self.frozen.values()
                   for t in [*tower.parameters(), *tower.buffers()])

    # -- state --------------------------------------------------------------
    def init_state(self) -> Dict[str, Any]:
        params = tree_map(lambda x: x.detach().to(self.device, torch.float32,
                                                  copy=True),
                          self.model.trainable_params())
        return self.sync_state({"params": params,
                                "opt_state": self.tx.init(params),
                                "step": 0})

    @staticmethod
    def sync_state(state: Dict[str, Any]) -> Dict[str, Any]:
        """Rank 0's parameters and optimizer moments on every rank (after
        init and after a resume), in place: the replicas must start equal,
        as JAX's replicated ``device_put`` assumes."""
        trees = [state["params"]] + [v for v in state["opt_state"].values()
                                     if isinstance(v, dict)]
        broadcast_tensors([t for tree in trees for _, t in tree_leaves(tree)])
        return state

    def prepare_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Host numpy -> tensors on the device (pinned, non-blocking copies
        to a card)."""
        out = {}
        with span("train.prepare_batch"):
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
        with span("train.step", step=step):
            leaves = [p for _, p in tree_leaves(params)]
            distributed = get_world_size() > 1
            for p in leaves:
                p.requires_grad_(True)
            try:
                with span("train.forward"):
                    loss = self.model.loss_fn(params, self.frozen, batch,
                                              self._generator(rng, step))
                if distributed:
                    count = self.model.label_count(batch).float()
                    loss = loss * count  # this rank's sum of token losses
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            if distributed:
                with span("train.allreduce"):
                    grads, loss = _global_mean(grads, loss.detach(), count)
            grads = _tree_like(params, grads)
            metrics = {"loss": loss.detach(), "lr": self.schedule(step),
                       "grad_norm": global_norm(grads)}
            with span("train.optimizer"):
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


def _global_mean(grads, local_sum, count):
    """(the gradients, the loss) of the global token mean from this rank's
    gradients of its token-loss sum, that sum and its label count: one
    all-reduce of one flat f32 buffer. The loss stays on the device."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [local_sum.reshape(1).float(), count.reshape(1)])
    all_reduce_sum(flat)
    flat = flat[:-1] / flat[-1].clamp(min=1.0)
    parts = flat[:-1].split([g.numel() for g in grads])
    return ([p.view_as(g) for p, g in zip(parts, grads)], flat[-1])
