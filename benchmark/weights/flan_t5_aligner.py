"""ThinkDiff-LVLM's aligner in its published layouts: flan-t5's decoder
side of an HF ``T5ForConditionalGeneration`` state dict (``shared``,
``decoder.block.<i>.layer.<j>...``, ``lm_head``; no encoder: the VLM's
states take its place) and the reference's ``mm_projector`` state dict
(Linear, GELU, Linear, T5LayerNorm).

Initialization (the configuration's ``assumed``): HF's T5 scheme, each
product of about unit scale: q N(0, (d_model d_kv)^-1/2), k and v
N(0, d_model^-1/2), o N(0, (heads d_kv)^-1/2), wi_0 and wi_1
N(0, d_model^-1/2), wo N(0, d_ff^-1/2); the embedding and the relative
bias N(0, 1); the lm_head N(0, d_model^-1/2); every norm weight
U(0.5, 1.5), so a norm that dropped its weight would show. The projector:
kernels N(0, fan_in^-1/2), biases 0, the T5LayerNorm weight (a copy of
the encoder's final norm in the real model) U(0.5, 1.5)."""

from __future__ import annotations

from typing import List, Tuple


def t5_spec(t5: dict) -> List[Tuple]:
    d, dk, h, dff = t5["d_model"], t5["d_kv"], t5["num_heads"], t5["d_ff"]
    inner, v = h * dk, t5["vocab_size"]
    norm = ("uniform", 0.5, 1.5)
    spec = [("shared.weight", (v, d), ("normal", 1.0)),
            ("decoder.block.0.layer.0.SelfAttention.relative_attention_bias"
             ".weight", (t5["relative_attention_num_buckets"], h),
             ("normal", 1.0))]
    for i in range(t5["num_decoder_layers"]):
        b = f"decoder.block.{i}.layer."
        for j, att in ((0, "SelfAttention"), (1, "EncDecAttention")):
            spec += [(f"{b}{j}.{att}.q.weight", (inner, d),
                      ("normal", (d * dk) ** -0.5)),
                     (f"{b}{j}.{att}.k.weight", (inner, d),
                      ("normal", d ** -0.5)),
                     (f"{b}{j}.{att}.v.weight", (inner, d),
                      ("normal", d ** -0.5)),
                     (f"{b}{j}.{att}.o.weight", (d, inner),
                      ("normal", inner ** -0.5)),
                     (f"{b}{j}.layer_norm.weight", (d,), norm)]
        spec += [(f"{b}2.DenseReluDense.wi_0.weight", (dff, d),
                  ("normal", d ** -0.5)),
                 (f"{b}2.DenseReluDense.wi_1.weight", (dff, d),
                  ("normal", d ** -0.5)),
                 (f"{b}2.DenseReluDense.wo.weight", (d, dff),
                  ("normal", dff ** -0.5)),
                 (f"{b}2.layer_norm.weight", (d,), norm)]
    spec += [("decoder.final_layer_norm.weight", (d,), norm),
             ("lm_head.weight", (v, d), ("normal", d ** -0.5))]
    return spec


def projector_spec(vlm_hidden: int, d: int) -> List[Tuple]:
    return [("mm_projector.0.weight", (d, vlm_hidden),
             ("normal", vlm_hidden ** -0.5)),
            ("mm_projector.0.bias", (d,), ("zeros",)),
            ("mm_projector.2.weight", (d, d), ("normal", d ** -0.5)),
            ("mm_projector.2.bias", (d,), ("zeros",)),
            ("mm_projector.3.weight", (d,), ("uniform", 0.5, 1.5))]
