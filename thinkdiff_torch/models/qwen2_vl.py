"""Qwen2-VL in PyTorch: dynamic-resolution vision tower + M-RoPE GQA decoder
(counterpart of thinkdiff_tpu/models/qwen2_vl.py).

Module and parameter names are the JAX tree's (``block_3/qkv/kernel`` is
``block_3.qkv.kernel`` here), so models/bridge.py loads a JAX parameter
tree key for key. The decoder exposes the final-RMSNorm hidden states (the
``model.norm`` tap the embedding engine returns) for prefill and decode.

Attention: the vision tower and the one-shot prefill run the flash kernel
(ops/flash_attention); decode steps attend over the dense KV cache
(ops/decode_attention), which they update in place.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.models.qdense import QDense, concat_dense_params
from thinkdiff_torch.ops.decode_attention import decode_attention, update_kv_cache
from thinkdiff_torch.ops.flash_attention import flash_attention
from thinkdiff_torch.ops.norms import layernorm, rmsnorm
from thinkdiff_torch.ops.rope import apply_rope, mrope_cos_sin

NEG_INF = -1e30

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 1536          # LM hidden (merger output)
    num_heads: int = 16
    quant_int8: Any = False          # False | True/"int8" | "w8a8" (QDense modes)
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: float = 4.0
    dtype: Any = torch.float32

    @property
    def head_dim(self):
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self):
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Sequence[int] = (16, 24, 24)
    tie_word_embeddings: bool = True
    quant_int8: Any = False
    # q|k|v -> one 'qkv' kernel, gate|up -> 'gate_up' (fuse_qwen2_params)
    fused_proj: bool = False
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    dtype: Any = torch.float32
    vision: Qwen2VLVisionConfig = dataclasses.field(
        default_factory=Qwen2VLVisionConfig)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def qwen2_vl_2b(cls, vision_quant: Any = False, **kw):
        base = dict(dtype=torch.bfloat16)
        base["vision"] = Qwen2VLVisionConfig(
            dtype=torch.bfloat16, quant_int8=vision_quant)
        base.update(kw)
        return cls(**base)

    @classmethod
    def qwen2_vl_7b(cls, vision_quant: Any = False, **kw):
        base = dict(
            hidden_size=3584, intermediate_size=18944, num_layers=28,
            num_heads=28, num_kv_heads=4, tie_word_embeddings=False,
            dtype=torch.bfloat16,
            vision=Qwen2VLVisionConfig(hidden_size=3584, dtype=torch.bfloat16,
                                       quant_int8=vision_quant),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw):
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2,
            mrope_section=(2, 3, 3), tie_word_embeddings=False,
            image_token_id=250, video_token_id=251, vision_start_token_id=249,
            vision=Qwen2VLVisionConfig(
                depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                patch_size=4, spatial_merge_size=2, temporal_patch_size=2,
            ),
        )
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# Host-side position helpers (numpy; identical to the JAX package's)
# ---------------------------------------------------------------------------

def vision_rot_pos_emb(grid_thw: np.ndarray, merge: int) -> np.ndarray:
    """(h, w) rotary position ids per patch, in the merge-window sequence
    order HF uses (Qwen2VLVisionTransformer.rot_pos_emb)."""
    pos_list = []
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // merge, merge, w // merge, merge)
        hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // merge, merge, w // merge, merge)
        wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
        pos = np.stack([hpos, wpos], axis=-1)  # (h*w, 2)
        pos_list.append(np.tile(pos, (int(t), 1)))
    return np.concatenate(pos_list, axis=0)


def vision_cos_sin(pos_hw: np.ndarray, head_dim: int, theta: float = 10000.0):
    """cos/sin (seq, head_dim//2): h-freqs then w-freqs concatenated."""
    dim = head_dim // 4  # per-axis rotary dim
    inv = 1.0 / (theta ** (np.arange(0, dim, dtype=np.float64) / dim))
    h_freqs = pos_hw[:, 0:1].astype(np.float64) * inv[None]
    w_freqs = pos_hw[:, 1:2].astype(np.float64) * inv[None]
    freqs = np.concatenate([h_freqs, w_freqs], axis=-1)  # (seq, head_dim/2)
    return (np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32))


def get_mrope_position_ids(
    input_ids: np.ndarray, grid_thw_per_image: Sequence[Sequence[int]],
    image_token_id: int, merge: int = 2, attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute (3, T) t/h/w positions for ONE sequence.

    Text tokens advance all three dims together. Each vision span (run of
    image_token_id) gets t = t_start (constant per image), h/w = merged-grid
    coordinates; the next text token resumes at max(prev)+1.
    Returns (position_ids (3, T), mrope_position_delta (scalar)).
    """
    ids = np.asarray(input_ids)
    T = len(ids)
    pos = np.zeros((3, T), np.int64)
    img_iter = iter(grid_thw_per_image)
    next_pos = 0
    i = 0
    while i < T:
        if ids[i] == image_token_id:
            t, h, w = next(img_iter)
            lh, lw = h // merge, w // merge
            n = int(t) * lh * lw
            t_idx = np.repeat(np.arange(int(t)), lh * lw)
            h_idx = np.tile(np.repeat(np.arange(lh), lw), int(t))
            w_idx = np.tile(np.tile(np.arange(lw), lh), int(t))
            pos[0, i: i + n] = next_pos + t_idx
            pos[1, i: i + n] = next_pos + h_idx
            pos[2, i: i + n] = next_pos + w_idx
            next_pos = int(pos[:, i: i + n].max()) + 1
            i += n
        else:
            pos[:, i] = next_pos
            next_pos += 1
            i += 1
    delta = next_pos - T
    return pos, np.int64(delta)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class LayerNorm(nn.Module):
    """LayerNorm with ``scale``/``bias`` in the model dtype, math in f32."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), dtype, device, 1.0)
        self.bias = _param((dim,), dtype, device, 0.0)

    def forward(self, x):
        return layernorm(x, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm with an f32 ``weight`` cast to the model dtype (JAX RMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), torch.float32, device, 1.0)

    def forward(self, x):
        return rmsnorm(x.to(self.dtype), self.weight.to(self.dtype), self.eps)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

class VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen2VLVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        qd = lambda i, o: QDense(i, o, cfg.dtype, cfg.quant_int8, True, device)
        self.norm1 = LayerNorm(d, 1e-6, cfg.dtype, device)
        self.qkv = qd(d, 3 * d)
        self.proj = qd(d, d)
        self.norm2 = LayerNorm(d, 1e-6, cfg.dtype, device)
        self.fc1 = qd(d, int(d * cfg.mlp_ratio))
        self.fc2 = qd(int(d * cfg.mlp_ratio), d)

    def forward(self, x, cos, sin, attn_bias=None):
        """x: (B, S, d); cos/sin: (S, hd/2) shared across the batch;
        attn_bias optional (S, S)."""
        cfg = self.cfg
        b, seq, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(self.norm1(x)).reshape(b, seq, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, hd)
        # rope before the head transpose, on (B, S, H, hd)
        q, k = apply_rope(q, k, cos[:, None], sin[:, None])
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_bias[None, None] if attn_bias is not None else None,
            None, False, hd ** -0.5)
        out = out.transpose(1, 2).reshape(b, seq, d)
        x = x + self.proj(out)
        y = self.fc1(self.norm2(x))
        y = y * torch.sigmoid(1.702 * y)  # quick_gelu
        return x + self.fc2(y)


class Qwen2VisionTower(nn.Module):
    def __init__(self, cfg: Qwen2VLVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, m2 = cfg.embed_dim, cfg.spatial_merge_size ** 2
        self.patch_embed = QDense(cfg.patch_dim, e, cfg.dtype, cfg.quant_int8,
                                  False, device)
        self.blocks: List[VisionBlock] = []
        for i in range(cfg.depth):
            blk = VisionBlock(cfg, device)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.ln_q = LayerNorm(e, 1e-6, cfg.dtype, device)
        self.mlp_0 = QDense(e * m2, e * m2, cfg.dtype, cfg.quant_int8, True,
                            device)
        self.mlp_2 = QDense(e * m2, cfg.hidden_size, cfg.dtype,
                            cfg.quant_int8, True, device)

    def forward(self, patches, cos, sin, attn_bias=None):
        """patches: (B, S, patch_dim) — B same-grid images — or (S, patch_dim).
        cos/sin (S, hd/2). Returns merged tokens (B, S // merge^2, hidden)
        (2-D for a 2-D input)."""
        cfg = self.cfg
        squeeze = patches.dim() == 2
        if squeeze:
            patches = patches[None]
        x = self.patch_embed(patches.to(cfg.dtype))
        for blk in self.blocks:
            x = blk(x, cos, sin, attn_bias)
        x = self.ln_q(x)
        b, seq, _ = x.shape
        m2 = cfg.spatial_merge_size ** 2
        x = x.reshape(b, seq // m2, cfg.embed_dim * m2)
        x = self.mlp_2(F.gelu(self.mlp_0(x)))
        return x[0] if squeeze else x


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2VLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, D = cfg.head_dim, cfg.hidden_size
        qd = lambda i, o, bias: QDense(i, o, cfg.dtype, cfg.quant_int8, bias,
                                       device)
        self.q_sz, self.kv_sz = cfg.num_heads * hd, cfg.num_kv_heads * hd
        if cfg.fused_proj:
            self.qkv = qd(D, self.q_sz + 2 * self.kv_sz, True)
        else:
            self.q_proj = qd(D, self.q_sz, True)
            self.k_proj = qd(D, self.kv_sz, True)
            self.v_proj = qd(D, self.kv_sz, True)
        self.o_proj = qd(self.q_sz, D, False)

    def forward(self, x, cos, sin, mask=None, cache: Optional[Cache] = None,
                cache_len=None):
        """x: (B, T, D); cos/sin: (B, T, hd/2) M-RoPE tables.

        No cache: causal self attention, with ``mask`` (B, T) as a key
        padding bias. Cache (k, v) of shape (B, Hkv, S, hd) and no
        ``cache_len``: one-shot prefill into the empty cache — the same
        causal flash attention, then the T entries are written at positions
        0..T-1. Cache and ``cache_len`` (B,): decode — the T new entries
        are written at cache_len (in place) and attend the valid prefix.
        Returns (out, cache)."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        if cfg.fused_proj:
            q, k, v = self.qkv(x).split(
                [self.q_sz, self.kv_sz, self.kv_sz], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        k = k.reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
        q, k = apply_rope(q, k, cos[:, None], sin[:, None])

        if cache is None or cache_len is None:
            bias = None
            if mask is not None:
                bias = (1.0 - mask.float())[:, None, None, :] * NEG_INF
            out = flash_attention(q, k, v, bias, None, True, hd ** -0.5)
            if cache is not None:
                cache[0][:, :, :t] = k
                cache[1][:, :, :t] = v
        else:
            k_cache, v_cache, _ = update_kv_cache(cache[0], cache[1], k, v,
                                                  cache_len)
            out = decode_attention(q, k_cache, v_cache, cache_len + t)
        out = out.transpose(1, 2).reshape(b, t, cfg.num_heads * hd)
        return self.o_proj(out), cache


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2VLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, I = cfg.hidden_size, cfg.intermediate_size
        qd = lambda i, o: QDense(i, o, cfg.dtype, cfg.quant_int8, False, device)
        self.input_norm = RMSNorm(D, cfg.rms_norm_eps, cfg.dtype, device)
        self.self_attn = Qwen2Attention(cfg, device)
        self.post_attn_norm = RMSNorm(D, cfg.rms_norm_eps, cfg.dtype, device)
        if cfg.fused_proj:
            self.gate_up = qd(D, 2 * I)
        else:
            self.gate_proj = qd(D, I)
            self.up_proj = qd(D, I)
        self.down_proj = qd(I, D)

    def forward(self, x, cos, sin, mask=None, cache=None, cache_len=None):
        h, cache = self.self_attn(self.input_norm(x), cos, sin, mask, cache,
                                  cache_len)
        x = x + h
        y = self.post_attn_norm(x)
        if self.cfg.fused_proj:
            gate, up = self.gate_up(y).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(y), self.up_proj(y)
        return x + self.down_proj(F.silu(gate) * up), cache


class Qwen2Decoder(nn.Module):
    def __init__(self, cfg: Qwen2VLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers: List[Qwen2Block] = []
        for i in range(cfg.num_layers):
            layer = Qwen2Block(cfg, device)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)

    def forward(self, input_embeds, position_ids, mask=None, caches=None,
                cache_len=None):
        """input_embeds (B, T, D); position_ids (3, B, T). Returns
        (norm_hidden, caches): the 'model.norm' tap the engine exports."""
        cfg = self.cfg
        cos, sin = mrope_cos_sin(position_ids, cfg.head_dim,
                                 list(cfg.mrope_section), cfg.rope_theta)
        x = input_embeds.to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x, _ = layer(x, cos, sin, mask,
                         caches[i] if caches is not None else None, cache_len)
        return self.norm(x), caches


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, dtype, device=None):
        super().__init__()
        self.embedding = _param((num, dim), dtype, device)

    def forward(self, ids):
        return F.embedding(ids, self.embedding)

    def attend(self, x):
        return torch.matmul(x.to(self.embedding.dtype), self.embedding.t())


class Qwen2VLModel(nn.Module):
    """Embedding + decoder + lm_head (the vision tower runs separately)."""

    def __init__(self, cfg: Qwen2VLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                                  device)
        self.decoder = Qwen2Decoder(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size, cfg.dtype,
                                  cfg.quant_int8, False, device)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def logits(self, hidden):
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.attend(hidden)
        return self.lm_head(hidden)

    def forward(self, input_ids=None, input_embeds=None, position_ids=None,
                mask=None, caches=None, cache_len=None, image_embeds=None,
                image_mask=None, compute_logits=True):
        """image_embeds (B, T, D) replace the embeddings where image_mask
        (B, T) is 1. Returns (logits or None, hidden, caches)."""
        if input_embeds is None:
            input_embeds = self.embed(input_ids)
        if image_embeds is not None:
            input_embeds = torch.where(
                image_mask[..., None] > 0,
                image_embeds.to(input_embeds.dtype), input_embeds)
        hidden, caches = self.decoder(input_embeds, position_ids, mask,
                                      caches, cache_len)
        logits = self.logits(hidden) if compute_logits else None
        return logits, hidden, caches


# ---------------------------------------------------------------------------
# Parameter trees (JAX layout, numpy or torch leaves)
# ---------------------------------------------------------------------------

def fuse_qwen2_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Unfused decoder tree -> the ``fused_proj=True`` layout: self_attn
    {q_proj, k_proj, v_proj} -> qkv (concat order q|k|v), {gate_proj,
    up_proj} -> gate_up. Accepts the {vision, lm} tree or the lm subtree;
    fp kernels, biases and quantized triplets all concatenate."""

    def rec(node, name=""):
        if not isinstance(node, dict):
            return node
        keys = set(node.keys())
        if name == "self_attn" and {"q_proj", "k_proj", "v_proj"} <= keys:
            fused = {"qkv": concat_dense_params(
                [node["q_proj"], node["k_proj"], node["v_proj"]])}
            rest = {k: rec(v, k) for k, v in node.items()
                    if k not in ("q_proj", "k_proj", "v_proj")}
            return {**fused, **rest}
        if {"gate_proj", "up_proj"} <= keys:
            fused = {"gate_up": concat_dense_params(
                [node["gate_proj"], node["up_proj"]])}
            rest = {k: rec(v, k) for k, v in node.items()
                    if k not in ("gate_proj", "up_proj")}
            return {**fused, **rest}
        return {k: rec(v, k) for k, v in node.items()}

    return rec(params)


def convert_qwen2_vl(sd: Dict[str, np.ndarray], dtype=None) -> Dict[str, Any]:
    """HF Qwen2VLForConditionalGeneration state dict (numpy) -> the JAX-layout
    parameter tree {vision, lm} (kernels (in, out)). Handles both key
    layouts: ``model.visual./model.language_model.`` and ``visual./model.``."""
    from thinkdiff_torch.models.bridge import unflatten

    def norm_key(k: str) -> str:
        return k.replace("model.visual.", "visual.").replace(
            "model.language_model.", "model.")

    sd = {norm_key(k): v for k, v in sd.items()}
    flat: Dict[str, np.ndarray] = {}

    def put(name, arr, transpose=False):
        if transpose:
            arr = arr.T
        if dtype is not None:
            arr = arr.astype(dtype)
        flat[name] = arr

    pe = sd["visual.patch_embed.proj.weight"]  # (E, C, T, P, P)
    put("vision/patch_embed/kernel", pe.reshape(pe.shape[0], -1).T)
    n_vblocks = 1 + max(
        (int(m.group(1)) for k in sd
         if (m := re.match(r"visual\.blocks\.(\d+)\.", k))), default=-1)
    for i in range(n_vblocks):
        hb, ob = f"visual.blocks.{i}.", f"vision/block_{i}"
        for nm in ("norm1", "norm2"):
            put(f"{ob}/{nm}/scale", sd[hb + nm + ".weight"])
            put(f"{ob}/{nm}/bias", sd[hb + nm + ".bias"])
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            put(f"{ob}/{ours}/kernel", sd[hb + theirs + ".weight"],
                transpose=True)
            put(f"{ob}/{ours}/bias", sd[hb + theirs + ".bias"])
    put("vision/ln_q/scale", sd["visual.merger.ln_q.weight"])
    put("vision/ln_q/bias", sd["visual.merger.ln_q.bias"])
    for ours, theirs in (("mlp_0", "mlp.0"), ("mlp_2", "mlp.2")):
        put(f"vision/{ours}/kernel", sd[f"visual.merger.{theirs}.weight"],
            transpose=True)
        put(f"vision/{ours}/bias", sd[f"visual.merger.{theirs}.bias"])

    put("lm/embed_tokens/embedding", sd["model.embed_tokens.weight"])
    if "lm_head.weight" in sd:
        put("lm/lm_head/kernel", sd["lm_head.weight"], transpose=True)
    put("lm/decoder/norm/weight", sd["model.norm.weight"])
    n_layers = 1 + max(
        (int(m.group(1)) for k in sd
         if (m := re.match(r"model\.layers\.(\d+)\.", k))), default=-1)
    for i in range(n_layers):
        hb, ob = f"model.layers.{i}.", f"lm/decoder/layer_{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            put(f"{ob}/self_attn/{p}/kernel",
                sd[hb + f"self_attn.{p}.weight"], transpose=True)
            put(f"{ob}/self_attn/{p}/bias", sd[hb + f"self_attn.{p}.bias"])
        put(f"{ob}/self_attn/o_proj/kernel",
            sd[hb + "self_attn.o_proj.weight"], transpose=True)
        for p in ("gate_proj", "up_proj", "down_proj"):
            put(f"{ob}/{p}/kernel", sd[hb + f"mlp.{p}.weight"], transpose=True)
        put(f"{ob}/input_norm/weight", sd[hb + "input_layernorm.weight"])
        put(f"{ob}/post_attn_norm/weight",
            sd[hb + "post_attention_layernorm.weight"])
    return unflatten(flat)


def init_params(cfg: Qwen2VLConfig, generator: torch.Generator, device=None,
                std: float = 0.02) -> Dict[str, Any]:
    """Random unfused float parameters in the JAX layout, made on ``device``
    from ``generator``: kernels and embeddings N(0, std) (HF's
    initializer_range), norm scales 1, biases 0."""
    from thinkdiff_torch.models.bridge import tree_of

    def fp(c):
        return dataclasses.replace(c, quant_int8=False, fused_proj=False)

    shapes = {
        "vision": Qwen2VisionTower(dataclasses.replace(
            cfg.vision, quant_int8=False), device="meta"),
        "lm": Qwen2VLModel(fp(cfg), device="meta"),
    }

    def make(name: str, meta: torch.Tensor) -> torch.Tensor:
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "embedding"):
            out = torch.empty(meta.shape, dtype=torch.float32, device=device)
            out.normal_(0.0, std, generator=generator)
            return out.to(meta.dtype)
        fill = 0.0 if leaf == "bias" else 1.0
        return torch.full(meta.shape, fill, dtype=meta.dtype, device=device)

    return {k: tree_of(m, make) for k, m in shapes.items()}
