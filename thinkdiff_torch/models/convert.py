"""Checkpoint converters: HF state dicts -> JAX-layout parameter trees (the
port's copy of thinkdiff_tpu/models/convert.py).

A converter is a name map plus transposes: HF's (out, in) linear weights
become (in, out) kernels, BLIP-2's fused qkv is split, the patch
convolution becomes HWIO. The tree then goes into a module through
``models/bridge.load_params``, key for key. Leaves stay numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from thinkdiff_torch.models.bridge import unflatten


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """A state dict of torch tensors (or arrays) as numpy arrays."""
    out = {}
    for k, v in state_dict.items():
        try:
            out[k] = v.detach().cpu().numpy()
        except AttributeError:
            out[k] = np.asarray(v)
    return out


def _putter(flat: Dict[str, np.ndarray], dtype):
    def put(name, arr, transpose=False):
        if transpose:
            arr = arr.T
        if dtype is not None:
            arr = arr.astype(dtype)
        flat[name] = arr
    return put


def _n_blocks(sd, pattern: str) -> int:
    n = 0
    for k in sd:
        m = re.match(pattern, k)
        if m:
            n = max(n, int(m.group(1)) + 1)
    return n


def convert_t5(sd: Dict[str, np.ndarray], dtype=None) -> Dict[str, Any]:
    """HF ``T5ForConditionalGeneration`` state dict -> the T5 tree.

    HF's layers map to ours: an encoder block's layer.0 is self_attn and
    layer.1 the ffn; a decoder block's layer.0 self_attn, layer.1
    cross_attn and layer.2 the ffn. Dense weights transpose (out, in) ->
    (in, out). A side the state dict does not hold (``T5EncoderModel``, as
    FLUX ships T5 in ``text_encoder_2``, has no decoder) is left out."""
    flat: Dict[str, np.ndarray] = {}
    put = _putter(flat, dtype)
    put("shared/embedding", sd["shared.weight"])
    if "lm_head.weight" in sd:
        put("lm_head/kernel", sd["lm_head.weight"], transpose=True)
    for side in ("encoder", "decoder"):
        if f"{side}.final_layer_norm.weight" not in sd:
            continue
        put(f"{side}/final_norm/weight", sd[f"{side}.final_layer_norm.weight"])
        put(f"{side}/rel_bias/rel_embedding", sd[
            f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
        for i in range(_n_blocks(sd, rf"{side}\.block\.(\d+)\.")):
            hb, ob = f"{side}.block.{i}.layer.", f"{side}/block_{i}"
            for p in ("q", "k", "v", "o"):
                put(f"{ob}/self_attn/{p}/kernel",
                    sd[f"{hb}0.SelfAttention.{p}.weight"], transpose=True)
            put(f"{ob}/self_attn_norm/weight", sd[f"{hb}0.layer_norm.weight"])
            ffn_idx = 1
            if side == "decoder":
                for p in ("q", "k", "v", "o"):
                    put(f"{ob}/cross_attn/{p}/kernel",
                        sd[f"{hb}1.EncDecAttention.{p}.weight"], transpose=True)
                put(f"{ob}/cross_attn_norm/weight",
                    sd[f"{hb}1.layer_norm.weight"])
                ffn_idx = 2
            ffn = f"{hb}{ffn_idx}.DenseReluDense."
            if f"{ffn}wi_0.weight" in sd:
                for p in ("wi_0", "wi_1"):
                    put(f"{ob}/ffn/{p}/kernel", sd[f"{ffn}{p}.weight"],
                        transpose=True)
            else:
                put(f"{ob}/ffn/wi/kernel", sd[f"{ffn}wi.weight"], transpose=True)
            put(f"{ob}/ffn/wo/kernel", sd[f"{ffn}wo.weight"], transpose=True)
            put(f"{ob}/ffn_norm/weight", sd[f"{hb}{ffn_idx}.layer_norm.weight"])
    return unflatten(flat)


def convert_clip_vit(sd: Dict[str, np.ndarray], prefix: str = "vision_model.",
                     dtype=None) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` / ``Blip2VisionModel`` state dict -> the ViT
    tree: CLIP's separate q/k/v, pre- and post-norm and position
    ``nn.Embedding``; BLIP-2's fused qkv (split in three, zero biases where
    it has none), projection, no pre-norm and a (1, N, D) position
    parameter. The patch convolution's (D, C, P, P) weight becomes HWIO."""
    flat: Dict[str, np.ndarray] = {}
    put = _putter(flat, dtype)
    g = lambda k: sd[prefix + k]
    has = lambda k: (prefix + k) in sd

    emb = "embeddings."
    put("cls_token", g(emb + "class_embedding").reshape(1, 1, -1))
    if has(emb + "position_embedding.weight"):  # CLIP: nn.Embedding
        pos = g(emb + "position_embedding.weight")[None]
    else:  # BLIP-2: a (1, N, D) parameter
        pos = g(emb + "position_embedding")
        if pos.ndim == 2:
            pos = pos[None]
    put("pos_embed", pos)
    put("patch_embed/kernel",
        g(emb + "patch_embedding.weight").transpose(2, 3, 1, 0))
    if has(emb + "patch_embedding.bias"):
        put("patch_embed/bias", g(emb + "patch_embedding.bias"))
    if has("pre_layrnorm.weight"):  # CLIP's spelling
        put("pre_norm/scale", g("pre_layrnorm.weight"))
        put("pre_norm/bias", g("pre_layrnorm.bias"))
    if has("post_layernorm.weight"):
        put("post_norm/scale", g("post_layernorm.weight"))
        put("post_norm/bias", g("post_layernorm.bias"))

    projections = ("q_proj", "k_proj", "v_proj")
    for i in range(_n_blocks(sd, rf"{re.escape(prefix)}encoder\.layers\.(\d+)\.")):
        hb, ob = f"encoder.layers.{i}.", f"block_{i}"
        if has(hb + "self_attn.qkv.weight"):  # BLIP-2's fused qkv
            qkv_w = g(hb + "self_attn.qkv.weight")
            d = qkv_w.shape[0] // 3
            qkv_b = (g(hb + "self_attn.qkv.bias") if has(hb + "self_attn.qkv.bias")
                     else np.zeros((3 * d,), dtype=qkv_w.dtype))
            for j, p in enumerate(projections):
                put(f"{ob}/attn/{p}/kernel", qkv_w[j * d:(j + 1) * d],
                    transpose=True)
                put(f"{ob}/attn/{p}/bias", qkv_b[j * d:(j + 1) * d])
            put(f"{ob}/attn/out_proj/kernel",
                g(hb + "self_attn.projection.weight"), transpose=True)
            put(f"{ob}/attn/out_proj/bias", g(hb + "self_attn.projection.bias"))
        else:
            for p in projections + ("out_proj",):
                put(f"{ob}/attn/{p}/kernel", g(hb + f"self_attn.{p}.weight"),
                    transpose=True)
                put(f"{ob}/attn/{p}/bias", g(hb + f"self_attn.{p}.bias"))
        for n in ("1", "2"):
            put(f"{ob}/norm{n}/scale", g(hb + f"layer_norm{n}.weight"))
            put(f"{ob}/norm{n}/bias", g(hb + f"layer_norm{n}.bias"))
        for n in ("1", "2"):
            put(f"{ob}/mlp_fc{n}/kernel", g(hb + f"mlp.fc{n}.weight"),
                transpose=True)
            put(f"{ob}/mlp_fc{n}/bias", g(hb + f"mlp.fc{n}.bias"))
    return unflatten(flat)
