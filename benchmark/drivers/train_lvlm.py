"""ThinkDiff-LVLM aligner training, as the training CLI runs it:
``Trainer.prepare_batch`` then ``Trainer.train_step`` on padded batches
of the training YAML, back to back.

Set-up builds the model from the configuration (``MllamaT5EmbedDecoder``),
loads the flan-t5 decoder made in HF's layout from the seed through the
port's converter and loader, the projector through its reference-checkpoint
converter, and builds one ``Trainer`` and its state. It then drives that
state through one pass over the traffic's pool of batches with the
window's own call: the first steps, which warm every batch shape the
window uses and which the reference follows. The window continues from
there, a whole pass over the pool at a time. After the window the same
state takes three steps more through the same call (the pool's next
batches), from a snapshot of its projector, moments and count.

``check`` judges both stretches of three steps against the plain float32
reference (``reference/t5_aligner.py``), which follows the first from
the seed's weights and the second from the snapshot: each step's loss,
each projector leaf's first gradient as AdamW got it (worked out from
its first moment before and after the step), by the gap of its norm and
by the norm of its difference, and each leaf's change over the three
steps. The second stretch judges the state the window's steps left."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.weights import flan_t5_aligner
from benchmark.work import t5_aligner as work

# the port's trainable tree and the reference checkpoint's keys
LEAVES = {("layer_0", "kernel"): "mm_projector.0.weight",
          ("layer_0", "bias"): "mm_projector.0.bias",
          ("layer_1", "kernel"): "mm_projector.2.weight",
          ("layer_1", "bias"): "mm_projector.2.bias",
          ("t5_norm", "weight"): "mm_projector.3.weight"}
B1 = 0.9
# the steps each check follows
CHECKED_STEPS = 3


def ref_layout(t: torch.Tensor) -> torch.Tensor:
    """A projector leaf in the reference checkpoint's layout: kernels (in,
    out) as Linear weights (out, in)."""
    return t.t() if t.ndim == 2 else t


def weight_seeds(seed: int):
    """(decoder, projector) seeds of a run seed."""
    s = np.random.SeedSequence(int(seed)).generate_state(4)
    return int(s[0]) << 32 | int(s[1]), int(s[2]) << 32 | int(s[3])


def gap(ours: dict, ref: dict, keep, of_difference=False) -> float:
    """The worst leaf's |norm(ours) - norm(ref)| (``of_difference``:
    norm(ours - ref)) over the larger of the leaf's reference norm and the
    median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = statistics.median(norms.values())
    top = ((lambda k: float((ours[k] - ref[k]).norm())) if of_difference
           else (lambda k: abs(float(ours[k].norm()) - norms[k])))
    return max(top(k) / max(norms[k], med) for k in keep)


class Driver:
    path = "train_step"

    def __init__(self, cell, config, traffic, seed, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = int(seed), device

    # -- set-up ---------------------------------------------------------------
    def model_cfg(self) -> dict:
        c = self.config
        t5 = {k: c["t5"][k] for k in (
            "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
            "num_decoder_layers", "num_heads",
            "relative_attention_num_buckets",
            "relative_attention_max_distance", "layer_norm_epsilon",
            "feed_forward_proj", "tie_word_embeddings")}
        t5.update(c.get("t5_layout", {}))
        return {**c["model"], "vlm_hidden_size": c["vlm_hidden_size"],
                "load_pretrained": False, "t5_config": t5}

    def setup(self):
        from thinkdiff_torch.engines.trainer import Trainer
        from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder
        from thinkdiff_torch.models.bridge import load_params
        from thinkdiff_torch.models.convert import convert_t5
        from thinkdiff_torch.models.t5 import fuse_t5_params
        from thinkdiff_torch.ops.quant import quantize_tree

        c, dev = self.config, self.device
        self.phases = ph = harness.Phases(dev)
        seed_t5, seed_p = weight_seeds(self.seed)
        model = MllamaT5EmbedDecoder(self.model_cfg(), seed=0, device=dev)
        ph.done("model")
        t5m = model.frozen["t5"]
        tree = convert_t5(weights.make(flan_t5_aligner.t5_spec(c["t5"]),
                                       seed_t5, dev))
        held = {k: v for k, v in tree.items() if hasattr(t5m, k)}
        qmode = model.cfg.get("quantize_frozen")
        if qmode:
            held = quantize_tree(held, min_size=0, w8a8=qmode == "int8_dyn")
        if t5m.cfg.fused_proj:
            held = fuse_t5_params(held)
        load_params(t5m, held)
        del tree, held
        ph.done("decoder weights")
        proj = weights.make(flan_t5_aligner.projector_spec(
            c["vlm_hidden_size"], c["t5"]["d_model"]), seed_p, dev,
            torch.float32)
        model.load_trainable(model.convert_reference_checkpoint(proj))
        del proj
        self.trainer = Trainer(model, dict(c["run"]), device=dev)
        self.state = self.trainer.init_state()
        ph.done("projector and trainer")
        self.pool = harness.traffic_module(self.traffic).make(
            self.traffic["params"], self.seed, c)
        ph.done("traffic")
        work_ = [self.batch_work(b) for b in self.pool]
        self.pass_work = {"steps": len(work_),
                          "samples": sum(w["samples"] for w in work_),
                          "ops": sum(w["ops"] for w in work_),
                          "calls": [c for w in work_ for c in w["calls"]]}

        # the first steps, through the window's call: every batch shape
        # the window uses, compiled and warm
        self.first = self.follow(self.pool, self.snapshot())
        ph.done("first pass")

    def snapshot(self) -> dict:
        """The projector, its AdamW moments (reference layout) and count."""
        params = self.state["params"]["projector"]
        opt = self.state["opt_state"]
        return {"count": int(opt["count"]),
                **{name: {k: ref_layout(tree[a][b]).clone()
                          for (a, b), k in LEAVES.items()}
                   for name, tree in (("params", params),
                                      ("mu", opt["mu"]["projector"]),
                                      ("nu", opt["nu"]["projector"]))}}

    def follow(self, batches, start: dict) -> dict:
        """Steps over ``batches`` through the window's call from the state
        ``start`` snapshots; of the first ``CHECKED_STEPS``: each loss, the
        first step's gradient as AdamW got it, and the change over them."""
        losses, out = [], {}
        for i, host in enumerate(batches):
            _, metrics = self.trainer.train_step(
                self.state, self.trainer.prepare_batch(host))
            if i < CHECKED_STEPS:
                losses.append(metrics["loss"])
            if i == 0:
                mu = self.snapshot()["mu"]
                out["grad"] = {k: (mu[k] - B1 * start["mu"][k]) / (1 - B1)
                               for k in mu}
            if i + 1 == CHECKED_STEPS:
                now = self.snapshot()["params"]
                out["change"] = {k: now[k] - start["params"][k] for k in now}
        out["losses"] = [float(x) for x in losses]
        return out

    def batch_work(self, b) -> dict:
        t5 = self.config["t5"]
        splits = b["embed_mask"].sum(1)
        labels = (b["labels"] != -100).sum(1)
        calls = work.step_calls(t5, b["labels"].shape[0], b["labels"].shape[1],
                                b["embeds"].shape[1])
        return {"samples": int(b["labels"].shape[0]),
                "ops": work.step_ops(t5, self.config["vlm_hidden_size"],
                                     labels, splits),
                "calls": [(c, 1) for c in calls]}

    # -- the window -----------------------------------------------------------
    def unit(self, i, spans):
        """One pass over the pool, step by step: every window trains on
        whole passes, so every seed's window does the same work."""
        for host in self.pool:
            with spans.span("prepare_batch"):
                batch = self.trainer.prepare_batch(host)
            with spans.span("train_step"):
                self.trainer.train_step(self.state, batch)
        return self.pass_work

    def window_metrics(self, units, seconds):
        return {"train_samples_per_s": sum(u["samples"] for u in units)
                / seconds}

    def after_window(self):
        self.after_start = self.snapshot()
        self.after = self.follow(self.pool[:CHECKED_STEPS], self.after_start)

    # -- correctness ----------------------------------------------------------
    def release(self):
        del self.trainer, self.state

    def check(self) -> dict:
        from benchmark.reference import t5_aligner as ref

        c, dev = self.config, self.device
        seed_t5, seed_p = weight_seeds(self.seed)
        t5_sd = weights.make(flan_t5_aligner.t5_spec(c["t5"]), seed_t5, dev)
        proj = weights.make(flan_t5_aligner.projector_spec(
            c["vlm_hidden_size"], c["t5"]["d_model"]), seed_p, dev,
            torch.float32)
        batches = self.pool[:CHECKED_STEPS]
        out = {"": ref.train(t5_sd, proj, c["t5"], c["run"], batches, dev)}
        del proj
        start = self.after_start
        out["after_"] = ref.train(t5_sd, start["params"], c["t5"], c["run"],
                                  batches, dev, start)
        lim, got = self.cell["limits"], {}
        self.left_out = []
        for prefix, ours in (("", self.first), ("after_", self.after)):
            r = out[prefix]
            norms = {k: float(g.norm()) for k, g in r["grad"].items()}
            med = statistics.median(norms.values())
            # leaves the reference's gradient leaves at rounding move by
            # round-off alone under Adam: left out of the change
            moving = [k for k in norms if norms[k] >= 1e-3 * med]
            self.left_out += [prefix + k for k in sorted(set(norms)
                                                         - set(moving))]
            loss_gap = max(abs(a - b) / abs(b)
                           for a, b in zip(ours["losses"], r["losses"]))
            for name, value in (
                    ("loss_gap", loss_gap),
                    ("grad_gap", gap(ours["grad"], r["grad"], list(norms))),
                    # first order in the gradient's error, where the norms'
                    # gaps are second order: the one the w8a8 control fails
                    ("grad_diff", gap(ours["grad"], r["grad"], list(norms),
                                      True)),
                    ("change_gap", gap(ours["change"], r["change"],
                                       moving))):
                got[prefix + name] = (value, lim[prefix + name])
        return got
