"""Plain float32 reference of ThinkDiff-LVLM's aligner training: the
projector (Linear, exact GELU, Linear, T5LayerNorm) into flan-t5's
decoder (causal self-attention with the shared relative-position bias and
no 1/sqrt(d) scaling, cross-attention to the projected tokens under the
embed mask, gated tanh-GELU FFN, RMS norms, untied lm_head), the token
mean of the cross entropy over labels other than -100, and AdamW with
optax's semantics under the linear-warmup cosine schedule.

It reads the published layouts (an HF T5 state dict's decoder side, the
``mm_projector`` state dict) and imports nothing of the program. Every
matrix product runs in float32 with TF32 off; each decoder block casts
its weights to float32 when it runs and is recomputed in the backward
(``torch.utils.checkpoint``), so the reference fits beside the weights at
the cell's batch."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PROJ_KEYS = ("mm_projector.0.weight", "mm_projector.0.bias",
             "mm_projector.2.weight", "mm_projector.2.bias",
             "mm_projector.3.weight")


def fp32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rel_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int,
                device) -> torch.Tensor:
    """T5's causal bucket of (key - query), in the float32 log arithmetic
    of the JAX package: max_exact + trunc(log(n / max_exact + 1e-6) /
    log(max_distance / max_exact) * (num_buckets - max_exact))."""
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    n = (-(mem - ctx).clamp(max=0)).to(torch.int32)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp(max=num_buckets - 1)
    return torch.where(n < max_exact, n, large).long()


def attention(q, k, v, bias=None, causal=False, key_mask=None):
    """(B, T, H, D) q and (B, S, H, D) k, v; T5's unscaled scores."""
    s = torch.einsum("bthd,bshd->bhts", q, k)
    if bias is not None:
        s = s + bias
    if causal:
        t, n = s.shape[-2:]
        s = s.masked_fill(torch.ones(t, n, dtype=torch.bool, device=s.device)
                          .triu(1), float("-inf"))
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :] == 0, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)


class Decoder:
    def __init__(self, sd: Dict[str, torch.Tensor], t5: dict):
        self.sd, self.t5 = sd, t5

    def w(self, key):
        return self.sd[key].float()

    def block(self, i: int, h, enc, bias, key_mask):
        t5, p = self.t5, f"decoder.block.{i}.layer."
        heads, dk = t5["num_heads"], t5["d_kv"]
        eps = t5["layer_norm_epsilon"]
        b, t, _ = h.shape
        split = lambda x: x.reshape(x.shape[0], x.shape[1], heads, dk)
        x = rms(h, self.w(p + "0.layer_norm.weight"), eps)
        a = p + "0.SelfAttention."
        out = attention(split(x @ self.w(a + "q.weight").t()),
                        split(x @ self.w(a + "k.weight").t()),
                        split(x @ self.w(a + "v.weight").t()), bias,
                        causal=True)
        h = h + out.reshape(b, t, -1) @ self.w(a + "o.weight").t()
        x = rms(h, self.w(p + "1.layer_norm.weight"), eps)
        a = p + "1.EncDecAttention."
        out = attention(split(x @ self.w(a + "q.weight").t()),
                        split(enc @ self.w(a + "k.weight").t()),
                        split(enc @ self.w(a + "v.weight").t()),
                        key_mask=key_mask)
        h = h + out.reshape(b, t, -1) @ self.w(a + "o.weight").t()
        x = rms(h, self.w(p + "2.layer_norm.weight"), eps)
        f = p + "2.DenseReluDense."
        g = F.gelu(x @ self.w(f + "wi_0.weight").t(), approximate="tanh")
        h = h + (g * (x @ self.w(f + "wi_1.weight").t())) @ \
            self.w(f + "wo.weight").t()
        return h

    def hidden(self, dec_ids, enc, key_mask):
        t5 = self.t5
        t = dec_ids.shape[1]
        buckets = rel_buckets(t, t, t5["relative_attention_num_buckets"],
                              t5["relative_attention_max_distance"],
                              dec_ids.device)
        table = self.w("decoder.block.0.layer.0.SelfAttention."
                       "relative_attention_bias.weight")
        bias = table[buckets].permute(2, 0, 1)[None]        # (1, H, T, T)
        h = self.w("shared.weight")[dec_ids]
        for i in range(t5["num_decoder_layers"]):
            h = checkpoint(self.block, i, h, enc, bias, key_mask,
                           use_reentrant=False)
        return rms(h, self.w("decoder.final_layer_norm.weight"),
                   t5["layer_norm_epsilon"])


def shift_right(labels):
    ids = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]], 1)
    return torch.where(ids == -100, torch.zeros_like(ids), ids)


def project(p: Dict[str, torch.Tensor], embeds):
    x = embeds @ p["mm_projector.0.weight"].t() + p["mm_projector.0.bias"]
    x = F.gelu(x)
    x = x @ p["mm_projector.2.weight"].t() + p["mm_projector.2.bias"]
    return rms(x, p["mm_projector.3.weight"])


def loss_fn(dec: Decoder, p, batch) -> torch.Tensor:
    labels = batch["labels"].long()
    enc = project(p, batch["embeds"].float())
    h = dec.hidden(shift_right(labels), enc, batch["embed_mask"])
    logits = h @ dec.w("lm_head.weight").t()
    logp = torch.log_softmax(logits, -1)
    valid = labels != -100
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp(min=1)


def schedule(run: dict, step: int) -> float:
    """linear_warmup_cosine_lr: warmup_lr -> init_lr over warmup_steps,
    then cosine to min_lr over max_epoch * iters_per_epoch steps."""
    init, low = float(run["init_lr"]), float(run["min_lr"])
    warm, n_warm = float(run["warmup_lr"]), int(run["warmup_steps"])
    total = max(int(run["max_epoch"]) * int(run["iters_per_epoch"]), 1)
    if n_warm > 0 and step < n_warm:
        return warm + (init - warm) * min(step / n_warm, 1.0)
    return (init - low) * 0.5 * (1 + math.cos(math.pi * min(step, total)
                                              / total)) + low


def train(t5_sd, proj_sd, t5: dict, run: dict, batches: List[dict],
          device, state: dict = None) -> dict:
    """``len(batches)`` AdamW steps from ``proj_sd`` (f32 copies), from
    fresh moments or from ``state``'s (``mu``, ``nu`` keyed as ``proj_sd``,
    and the update ``count``). Returns each step's loss, each leaf's first
    gradient and its change after the last step (float32 tensors on
    ``device``)."""
    fp32_matmuls()
    dec = Decoder(t5_sd, t5)
    p = {k: proj_sd[k].float().clone().to(device) for k in PROJ_KEYS}
    start = {k: v.clone() for k, v in p.items()}
    if state is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        count = 0
    else:
        m = {k: state["mu"][k].float().clone().to(device) for k in p}
        v2 = {k: state["nu"][k].float().clone().to(device) for k in p}
        count = int(state["count"])
    b1, b2, eps, wd = 0.9, float(run.get("beta2", 0.999)), 1e-8, \
        float(run["weight_decay"])
    losses, first = [], None
    for step, host in enumerate(batches):
        batch = {k: torch.as_tensor(np.asarray(x)).to(device)
                 for k, x in host.items()}
        for x in p.values():
            x.requires_grad_(True)
        loss = loss_fn(dec, p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        grads = dict(zip(p, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr, c = schedule(run, count + step), count + step + 1
        with torch.no_grad():
            for k in p:
                p[k].requires_grad_(False)
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[k] / (1 - b1 ** c)) / (torch.sqrt(v2[k] / (1 - b2 ** c))
                                              + eps)
                if p[k].ndim >= 2:
                    u = u + wd * p[k]
                p[k].sub_(lr * u)
    return {"losses": losses, "grad": first,
            "change": {k: p[k] - start[k] for k in p}}
