"""The work of one FLUX.1 transformer forward (one Euler step; FLUX.1-dev
is guidance-distilled, so a step is one forward) over ``b`` rows of
``img`` latent tokens and ``txt`` condition tokens.

``step_ops``: the products the forward requires: every projection on
each stream's tokens (double blocks: q, k, v, out and the two MLP layers
per stream; single blocks: q, k, v, the MLP and the output projection over
the joint sequence), the modulations and embedders once a row, the
embedders of the inputs and the output projection, and the joint
attention (Q K^T and P V) at its full length. Elementwise work is left
out.

``step_calls``: the kernel calls a forward makes: one joint attention a
block (B, H, T, T, D), and the per-head RMSNorm of q and k (two calls a
stream in a double block, two in a single block)."""

from __future__ import annotations

from typing import List

from benchmark.work import attention, rmsnorm


def step_ops(tr: dict, b: int, img: int, txt: int) -> float:
    d = tr["num_attention_heads"] * tr["attention_head_dim"]
    mlp = int(d * tr["mlp_ratio"])
    n2, n1 = tr["num_layers"], tr["num_single_layers"]
    t = img + txt
    per_token_double = 2 * (4 * d * d + 2 * d * mlp)      # one stream
    per_token_single = 2 * (3 * d * d + d * mlp + (d + mlp) * d)
    attn = 4 * d * t * t                                 # heads x head size
    ops = n2 * (per_token_double * t + attn) + n1 * (per_token_single * t
                                                     + attn)
    ops *= b
    # per row: modulations (6d twice a double block, 3d a single one), the
    # time / guidance / pooled embedders, the final norm's modulation
    per_row = (n2 * 2 * 2 * d * 6 * d + n1 * 2 * d * 3 * d
               + 2 * (256 * d + d * d) * (2 if tr["guidance_embeds"] else 1)
               + 2 * (tr["pooled_projection_dim"] * d + d * d)
               + 2 * d * 2 * d)
    per_token_io = (2 * img * tr["in_channels"] * d * 2
                    + 2 * txt * tr["joint_attention_dim"] * d)
    return ops + b * (per_row + per_token_io)


def step_calls(tr: dict, b: int, img: int, txt: int) -> List[dict]:
    h, hd = tr["num_attention_heads"], tr["attention_head_dim"]
    n2, n1 = tr["num_layers"], tr["num_single_layers"]
    t = img + txt
    att = attention.forward(b, h, t, t, hd)
    return ([att] * (n2 + n1)
            + [rmsnorm.forward(b * img * h, hd)] * (2 * n2)
            + [rmsnorm.forward(b * txt * h, hd)] * (2 * n2)
            + [rmsnorm.forward(b * t * h, hd)] * (2 * n1))
