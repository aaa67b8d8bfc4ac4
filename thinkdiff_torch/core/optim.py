"""Learning-rate schedules and AdamW with optax's semantics (counterpart of
thinkdiff_tpu/core/optim.py).

The schedules are pure ``step -> lr`` functions. The optimizer is written
out rather than taken from ``torch.optim`` so that it follows optax's
``adamw`` step for step: the schedule is read at the update count BEFORE
the update (step 0 uses ``warmup_lr``), bias-corrected moments with eps
1e-8 outside the square root, weight decay decoupled, scaled by the
learning rate and masked by ``weight_decay_mask``'s parameter names. The
optional global-norm clip and ``accum_grad_iters`` accumulation follow
``optax.clip_by_global_norm`` and ``optax.MultiSteps``.

Parameters and optimizer state are trees (nested dicts) of tensors, as in
JAX; ``update`` writes the new parameters and moments in place.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

Tree = Dict[str, Any]


def tree_leaves(tree: Tree, prefix: str = ""):
    """[(path, tensor)] in sorted key order, paths joined by '/'."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_leaves(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def linear_warmup_cosine_schedule(init_lr: float, min_lr: float,
                                  warmup_lr: float, warmup_steps: int,
                                  total_steps: int) -> Callable[[int], float]:
    """Linear warmup (warmup_lr -> init_lr) then cosine decay to min_lr."""

    def schedule(step: int) -> float:
        step = float(step)
        decay_steps = max(total_steps, 1)
        cos = (init_lr - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * min(step, decay_steps) / decay_steps)) + min_lr
        if warmup_steps > 0 and step < warmup_steps:
            return warmup_lr + (init_lr - warmup_lr) * min(
                step / max(warmup_steps, 1), 1.0)
        return cos

    return schedule


def linear_warmup_step_schedule(init_lr: float, min_lr: float,
                                warmup_lr: float, warmup_steps: int,
                                steps_per_epoch: int,
                                decay_rate: float = 1.0) -> Callable[[int], float]:
    """Linear warmup then per-epoch step decay init_lr * decay_rate**epoch,
    floored at min_lr."""

    def schedule(step: int) -> float:
        step = float(step)
        if warmup_steps > 0 and step < warmup_steps:
            return warmup_lr + (init_lr - warmup_lr) * min(
                step / max(warmup_steps, 1), 1.0)
        epoch = math.floor(step / max(steps_per_epoch, 1))
        return max(init_lr * decay_rate ** epoch, min_lr)

    return schedule


def make_schedule_from_config(run_cfg: Dict[str, Any]) -> Callable[[int], float]:
    """The schedule a run config names (``lr_sched``), with the reference
    defaults; ``warmup_lr`` < 0 means init_lr."""
    name = run_cfg.get("lr_sched", "linear_warmup_cosine_lr")
    init_lr = float(run_cfg.get("init_lr", 1e-4))
    min_lr = float(run_cfg.get("min_lr", 0.0))
    warmup_lr = float(run_cfg.get("warmup_lr", -1))
    warmup_lr = warmup_lr if warmup_lr >= 0 else init_lr
    warmup_steps = int(run_cfg.get("warmup_steps", 0))
    iters = int(run_cfg.get("iters_per_epoch", 1000))
    if name == "linear_warmup_cosine_lr":
        return linear_warmup_cosine_schedule(
            init_lr, min_lr, warmup_lr, warmup_steps,
            int(run_cfg.get("max_epoch", 1)) * iters)
    if name == "linear_warmup_step_lr":
        return linear_warmup_step_schedule(
            init_lr, min_lr, warmup_lr, warmup_steps, iters,
            float(run_cfg.get("lr_decay_rate", 1.0)))
    raise KeyError(f"Unknown lr_sched '{name}'")


def weight_decay_mask(params: Tree) -> Tree:
    """True where weight decay applies: ndim >= 2 and no 'bias', 'norm',
    'ln', 'embedding' or 'scale' in the lower-cased parameter path."""

    def rec(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = rec(v, path + "/")
            else:
                name = path.lower()
                out[k] = v.ndim >= 2 and not any(
                    bad in name for bad in ("bias", "norm", "ln", "embedding",
                                            "scale"))
        return out

    return rec(params, "")


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().pow(2).sum() for _, g in tree_leaves(tree)))


class AdamW:
    """optax.adamw(schedule, b1=0.9, b2, eps=1e-8, weight_decay, mask),
    optionally after clip_by_global_norm and inside MultiSteps(k)."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 mask: Tree, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: float = None,
                 accum: int = 1):
        self.schedule, self.weight_decay, self.mask = schedule, weight_decay, mask
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm, self.accum = max_grad_norm, accum

    def init(self, params: Tree) -> Tree:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        state = {"count": 0, "mu": tree_map(zeros, params),
                 "nu": tree_map(zeros, params)}
        if self.accum > 1:
            state.update(mini_step=0, acc=tree_map(zeros, params))
        return state

    @torch.no_grad()
    def update(self, grads: Tree, state: Tree, params: Tree) -> None:
        """One micro-step: params and state are updated in place."""
        if self.accum > 1:
            k = state["mini_step"]
            for (_, a), (_, g) in zip(tree_leaves(state["acc"]),
                                      tree_leaves(grads)):
                a.add_((g.float() - a) / (k + 1))  # running mean
            if k + 1 < self.accum:
                state["mini_step"] = k + 1
                return
            grads = state["acc"]
        if self.max_grad_norm is not None:
            norm = global_norm(grads)
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            grads = tree_map(lambda g: g.float() * factor, grads)
        # MultiSteps stretches the schedule back to micro-step units
        lr = self.schedule(state["count"] * self.accum)
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        for (path, p), (_, g), (_, m), (_, v), (_, decay) in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                tree_leaves(self.mask)):
            g = g.float()
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if decay:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        state["count"] = count
        if self.accum > 1:
            state["mini_step"] = 0
            for _, a in tree_leaves(state["acc"]):
                a.zero_()


def make_optimizer(run_cfg: Dict[str, Any], params: Tree):
    """(AdamW, schedule) from a run config: weight decay 0.05 masked by
    ``weight_decay_mask``, b2 0.999, ``use_clip_grad_norm`` /
    ``max_grad_norm``, ``accum_grad_iters``. The schedule is in micro-step
    units, as the trainer's ``lr`` metric reads it."""
    schedule = make_schedule_from_config(run_cfg)
    clip = (float(run_cfg.get("max_grad_norm", 1.0))
            if run_cfg.get("use_clip_grad_norm", False) else None)
    tx = AdamW(schedule, float(run_cfg.get("weight_decay", 0.05)),
               weight_decay_mask(params), b2=float(run_cfg.get("beta2", 0.999)),
               max_grad_norm=clip,
               accum=int(run_cfg.get("accum_grad_iters", 1)))
    return tx, schedule
