"""FLUX.1-dev's rendering stack in its published layouts: the diffusers
``FluxTransformer2DModel`` state dict, CLIP-L's HF ``CLIPTextModel``
(``text_model.*``) and the decoder of the FLUX ``AutoencoderKL``
(``decoder.*``).

Initialization (the configuration's ``assumed``): every projection,
convolution and embedding N(0, 0.02) (HF's initializer range), CLIP's
position embedding N(0, 0.01), biases N(0, 0.01), LayerNorm and GroupNorm
weights U(0.5, 1.5) with biases N(0, 0.01), FLUX's q/k RMSNorm weights
U(0.5, 1.5): a norm or bias that dropped its parameter would show."""

from __future__ import annotations

from typing import List, Tuple

W, B, NORM = ("normal", 0.02), ("normal", 0.01), ("uniform", 0.5, 1.5)


def _linear(key: str, n_out: int, n_in: int) -> List[Tuple]:
    return [(f"{key}.weight", (n_out, n_in), W), (f"{key}.bias", (n_out,), B)]


def transformer_spec(tr: dict, mlp_ratio: float) -> List[Tuple]:
    d = tr["num_attention_heads"] * tr["attention_head_dim"]
    hd, mlp = tr["attention_head_dim"], int(d * mlp_ratio)
    spec = (_linear("x_embedder", d, tr["in_channels"])
            + _linear("context_embedder", d, tr["joint_attention_dim"]))
    embedders = ["timestep_embedder"] + (
        ["guidance_embedder"] if tr["guidance_embeds"] else [])
    for e in embedders:
        spec += (_linear(f"time_text_embed.{e}.linear_1", d, 256)
                 + _linear(f"time_text_embed.{e}.linear_2", d, d))
    spec += (_linear("time_text_embed.text_embedder.linear_1", d,
                     tr["pooled_projection_dim"])
             + _linear("time_text_embed.text_embedder.linear_2", d, d))
    for i in range(tr["num_layers"]):
        b = f"transformer_blocks.{i}."
        spec += _linear(b + "norm1.linear", 6 * d, d)
        spec += _linear(b + "norm1_context.linear", 6 * d, d)
        for p in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                  "add_v_proj", "to_out.0", "to_add_out"):
            spec += _linear(b + "attn." + p, d, d)
        for p in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            spec.append((f"{b}attn.{p}.weight", (hd,), NORM))
        for ff in ("ff", "ff_context"):
            spec += (_linear(f"{b}{ff}.net.0.proj", mlp, d)
                     + _linear(f"{b}{ff}.net.2", d, mlp))
    for i in range(tr["num_single_layers"]):
        b = f"single_transformer_blocks.{i}."
        spec += _linear(b + "norm.linear", 3 * d, d)
        for p in ("to_q", "to_k", "to_v"):
            spec += _linear(b + "attn." + p, d, d)
        for p in ("norm_q", "norm_k"):
            spec.append((f"{b}attn.{p}.weight", (hd,), NORM))
        spec += _linear(b + "proj_mlp", mlp, d)
        spec += _linear(b + "proj_out", d, d + mlp)
    spec += (_linear("norm_out.linear", 2 * d, d)
             + _linear("proj_out", tr["in_channels"], d))
    return spec


def clip_spec(te: dict) -> List[Tuple]:
    d, f = te["hidden_size"], te["intermediate_size"]
    p = "text_model."
    spec = [(p + "embeddings.token_embedding.weight",
             (te["vocab_size"], d), W),
            (p + "embeddings.position_embedding.weight",
             (te["max_position_embeddings"], d), ("normal", 0.01))]
    for i in range(te["num_hidden_layers"]):
        b = f"{p}encoder.layers.{i}."
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec += _linear(b + "self_attn." + q, d, d)
        spec += _linear(b + "mlp.fc1", f, d) + _linear(b + "mlp.fc2", d, f)
        for n in ("layer_norm1", "layer_norm2"):
            spec += [(f"{b}{n}.weight", (d,), NORM), (f"{b}{n}.bias", (d,), B)]
    spec += [(p + "final_layer_norm.weight", (d,), NORM),
             (p + "final_layer_norm.bias", (d,), B)]
    return spec


def _conv(key: str, n_out: int, n_in: int, k: int) -> List[Tuple]:
    return [(f"{key}.weight", (n_out, n_in, k, k), W),
            (f"{key}.bias", (n_out,), B)]


def _norm(key: str, ch: int) -> List[Tuple]:
    return [(f"{key}.weight", (ch,), NORM), (f"{key}.bias", (ch,), B)]


def _resnet(key: str, n_in: int, n_out: int) -> List[Tuple]:
    spec = (_norm(key + ".norm1", n_in) + _conv(key + ".conv1", n_out, n_in, 3)
            + _norm(key + ".norm2", n_out)
            + _conv(key + ".conv2", n_out, n_out, 3))
    if n_in != n_out:
        spec += _conv(key + ".conv_shortcut", n_out, n_in, 1)
    return spec


def vae_decoder_spec(vae: dict) -> List[Tuple]:
    chs = list(vae["block_out_channels"])
    top, p = chs[-1], "decoder."
    spec = _conv(p + "conv_in", top, vae["latent_channels"], 3)
    spec += _resnet(p + "mid_block.resnets.0", top, top)
    a = p + "mid_block.attentions.0."
    spec += _norm(a + "group_norm", top)
    for q in ("to_q", "to_k", "to_v", "to_out.0"):
        spec += _linear(a + q, top, top)
    spec += _resnet(p + "mid_block.resnets.1", top, top)
    ch_in = top
    for bi, ch in enumerate(reversed(chs)):
        for li in range(vae["layers_per_block"] + 1):
            spec += _resnet(f"{p}up_blocks.{bi}.resnets.{li}", ch_in, ch)
            ch_in = ch
        if bi < len(chs) - 1:
            spec += _conv(f"{p}up_blocks.{bi}.upsamplers.0.conv", ch, ch, 3)
    spec += _norm(p + "conv_norm_out", chs[0]) + _conv(p + "conv_out", 3,
                                                       chs[0], 3)
    return spec
