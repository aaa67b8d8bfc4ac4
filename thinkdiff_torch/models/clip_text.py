"""CLIP-L text encoder with its pooled output (counterpart of
thinkdiff_tpu/models/clip_text.py).

FLUX needs only the pooled CLIP embedding of the text prompt, an empty
string at ThinkDiff inference. Numerics of HF ``CLIPTextModel``: causal
attention (the flash forward, ops/flash_attention, #1), quick_gelu MLP,
final layer norm, pooled = the hidden state at the first EOS token.

Parameter names are the JAX tree's (flat per layer: ``layer_3_q/kernel``
is ``layer_3_q.kernel`` here), so models/bridge.py loads a JAX tree key for
key; ``convert_clip_text`` makes that tree from an HF state dict.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.qwen2_vl import Embed, LayerNorm, _param
from thinkdiff_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: Any = torch.float32

    @classmethod
    def clip_l(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
                    num_layers=2, num_heads=4, max_positions=16,
                    eos_token_id=99)
        base.update(kw)
        return cls(**base)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden_size, cfg.dtype
        dense = lambda i, o: QDense(i, o, dt, False, True, device)
        self.token_embedding = Embed(cfg.vocab_size, d, dt, device)
        self.position_embedding = _param((cfg.max_positions, d), dt, device)
        for i in range(cfg.num_layers):
            for n in ("norm1", "norm2"):
                self.add_module(f"layer_{i}_{n}", LayerNorm(
                    d, cfg.layer_norm_eps, dt, device))
            for n in ("q", "k", "v", "out"):
                self.add_module(f"layer_{i}_{n}", dense(d, d))
            self.add_module(f"layer_{i}_fc1", dense(d, cfg.intermediate_size))
            self.add_module(f"layer_{i}_fc2", dense(cfg.intermediate_size, d))
        self.final_norm = LayerNorm(d, cfg.layer_norm_eps, dt, device)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids (B, T) -> (last hidden (B, T, D), pooled (B, D))."""
        cfg = self.cfg
        b, t = input_ids.shape
        h, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        x = self.token_embedding(input_ids) + self.position_embedding[None, :t]
        for i in range(cfg.num_layers):
            layer = lambda n: getattr(self, f"layer_{i}_{n}")
            y = layer("norm1")(x)
            q, k, v = (layer(n)(y).reshape(b, t, h, hd).transpose(1, 2)
                       for n in ("q", "k", "v"))
            attn = flash_attention(q, k, v, None, None, True, hd ** -0.5)
            x = x + layer("out")(attn.transpose(1, 2).reshape(b, t, -1))
            y = layer("fc1")(layer("norm2")(x))
            y = y * torch.sigmoid(1.702 * y)  # quick_gelu
            x = x + layer("fc2")(y)
        x = self.final_norm(x)
        # pooled: the hidden state at the first EOS (HF: argmax over == eos);
        # a row without one takes its last position
        eos = (input_ids == cfg.eos_token_id).int()
        idx = torch.where(eos.sum(dim=1) > 0, eos.argmax(dim=1),
                          torch.full_like(eos[:, 0], t - 1))
        return x, x[torch.arange(b, device=x.device), idx]


def convert_clip_text(sd: Dict[str, np.ndarray], prefix: str = "text_model.",
                      dtype=None) -> Dict[str, Any]:
    """An HF ``CLIPTextModel`` state dict (numpy) -> the JAX parameter tree
    (linear weights transposed to (in, out))."""
    from thinkdiff_torch.models.bridge import unflatten

    flat: Dict[str, np.ndarray] = {}
    g = lambda k: sd[prefix + k]

    def put(name, arr, transpose=False):
        if transpose:
            arr = arr.T
        if dtype is not None:
            arr = arr.astype(dtype)
        flat[name] = arr

    put("token_embedding/embedding", g("embeddings.token_embedding.weight"))
    put("position_embedding", g("embeddings.position_embedding.weight"))
    put("final_norm/scale", g("final_layer_norm.weight"))
    put("final_norm/bias", g("final_layer_norm.bias"))
    n = 1 + max((int(m.group(1)) for k in sd if (m := re.match(
        rf"{re.escape(prefix)}encoder\.layers\.(\d+)\.", k))), default=-1)
    for i in range(n):
        hb, nm = f"encoder.layers.{i}.", f"layer_{i}"
        for hf, ours in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                         ("self_attn.v_proj", "v"),
                         ("self_attn.out_proj", "out"), ("mlp.fc1", "fc1"),
                         ("mlp.fc2", "fc2")):
            put(f"{nm}_{ours}/kernel", g(hb + f"{hf}.weight"), True)
            put(f"{nm}_{ours}/bias", g(hb + f"{hf}.bias"))
        for hf, ours in (("layer_norm1", "norm1"), ("layer_norm2", "norm2")):
            put(f"{nm}_{ours}/scale", g(hb + f"{hf}.weight"))
            put(f"{nm}_{ours}/bias", g(hb + f"{hf}.bias"))
    return unflatten(flat)
