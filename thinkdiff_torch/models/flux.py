"""FLUX.1 MMDiT transformer in PyTorch (counterpart of
thinkdiff_tpu/models/flux.py).

The denoising backbone of ThinkDiff inference: it is conditioned on
*external* prompt embeds (the aligned VLM tokens) in place of T5-encoder
output, the ``txt`` argument. FLUX.1-dev: 19 double-stream (img/txt) MMDiT
blocks and 38 single-stream blocks, hidden 3072 = 24 heads x 128,
AdaLayerNorm-Zero modulation from the (timestep + guidance + pooled CLIP)
embedding, joint attention with interleaved-pair RoPE over the (id, y, x)
axes [16, 56, 56], per-head RMS q/k norm, packed 2x2 latent patches (64
channels).

Module and parameter names are the JAX tree's (``double_3/img_q/kernel`` is
``double_3.img_q.kernel`` here), so models/bridge.py loads a JAX parameter
tree key for key; ``convert_flux`` makes that tree from a diffusers
``FluxTransformer2DModel`` state dict. Every block projection is a QDense
(float, weight-only int8 or w8a8, ``FluxConfig.quant_int8``); the
time/text embedders are plain dense layers, as in JAX.

Kernels on this path: the joint attention and nothing else goes through
the flash forward (ops/flash_attention, #1), the per-head q/k norm through
RMSNorm (ops/norms, #3). Both run in the (B, S, H, D) layout the
projections produce: the norm before the head transpose (its rows are the
same), and the flash kernel reads the joint q/k/v as head-transposed views
of that memory and writes its output as such a view, so neither side
copies.

Spans (``core/trace.py``) mark the eager elementwise work of each block:
``flux.norm_mod`` (each LayerNorm + modulation), ``flux.rope`` (the
stream concats and RoPE, between the q/k norm and the flash call) and
``flux.residual`` (each gated residual add, its projection computed
before the span opens). The rest of a step (the projections, #1, #3,
GELU / SiLU, the single blocks' concat) is ``flux.step``'s self time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.core.trace import span
from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.ops.flash_attention import flash_attention
from thinkdiff_torch.ops.norms import layernorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """The JAX ``FluxConfig`` without its flash-attention tile fields
    (``attn_block_q``, ``attn_block_k``, ``_FULL_K_LIMIT``, ``attn_blocks``):
    those size the Pallas kernel's tiles for a TPU's 16 MB of scoped VMEM.
    The port's flash wrapper picks its own tiles from the call's shapes
    (ops/flash_attention ``flash_fwd_tiles``)."""

    in_channels: int = 64
    hidden_size: int = 3072
    num_heads: int = 24
    num_double_layers: int = 19
    num_single_layers: int = 38
    mlp_ratio: float = 4.0
    joint_attention_dim: int = 4096   # T5 / aligned-token width
    pooled_projection_dim: int = 768  # CLIP-L pooled
    axes_dims_rope: Sequence[int] = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embeds: bool = True      # dev True, schnell False
    dtype: Any = torch.float32
    quant_int8: Any = False           # False | True/"int8" | "w8a8" (QDense)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def flux_dev(cls, **kw):
        return cls(**{**dict(dtype=torch.bfloat16), **kw})

    @classmethod
    def tiny(cls, **kw):
        base = dict(
            in_channels=16, hidden_size=64, num_heads=4,
            num_double_layers=2, num_single_layers=2,
            joint_attention_dim=32, pooled_projection_dim=24,
            axes_dims_rope=(4, 6, 6), guidance_embeds=True,
        )
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs, diffusers use_real_unbind_dim=-1) and timesteps
# ---------------------------------------------------------------------------

def flux_rope_cos_sin(ids: torch.Tensor, axes_dims: Sequence[int],
                      theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (S, n_axes) -> f32 cos/sin (S, head_dim), each angle repeated for
    its pair."""
    cos_parts, sin_parts = [], []
    for i, dim in enumerate(axes_dims):
        omega = 1.0 / (theta ** (torch.arange(
            0, dim, 2, dtype=torch.float32, device=ids.device) / dim))
        angles = ids[:, i:i + 1].float() * omega[None]  # (S, dim/2)
        cos_parts.append(torch.cos(angles).repeat_interleave(2, dim=-1))
        sin_parts.append(torch.sin(angles).repeat_interleave(2, dim=-1))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation of x's last axis in f32, cast back to x's dtype.
    x (..., S, D) with cos/sin (S, D), as in JAX; any layout whose last axis
    is D with cos/sin broadcast to it (the blocks pass (S, 1, D) for x in
    (B, S, H, D))."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip: bool = True) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0), f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _layernorm(x):
    """flax LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6):
    statistics and normalization in f32, cast back to x's dtype."""
    return layernorm(x, None, None, 1e-6)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _dense(cfg: FluxConfig, in_dim: int, features: int, device) -> QDense:
    return QDense(in_dim, features, cfg.dtype, cfg.quant_int8, True, device)


class MLPEmbedder(nn.Module):
    """Linear -> silu -> Linear (diffusers TimestepEmbedding / text_embedder);
    plain dense layers in every quantization mode, as in JAX."""

    def __init__(self, in_dim: int, hidden: int, dtype, device=None):
        super().__init__()
        self.linear_1 = QDense(in_dim, hidden, dtype, False, True, device)
        self.linear_2 = QDense(hidden, hidden, dtype, False, True, device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class QKNorm(nn.Module):
    """RMS norm of q and k over the head dim; the f32 scales are cast to
    the model dtype first, as JAX's ``QKNorm`` does."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.q_scale = nn.Parameter(torch.ones(dim, device=device),
                                    requires_grad=False)
        self.k_scale = nn.Parameter(torch.ones(dim, device=device),
                                    requires_grad=False)

    def forward(self, q, k):
        return (rmsnorm(q.to(self.dtype), self.q_scale.to(self.dtype)),
                rmsnorm(k.to(self.dtype), self.k_scale.to(self.dtype)))


def _attention(q, k, v, head_dim: int) -> torch.Tensor:
    """Unmasked joint attention of (B, T, H, D) q, k, v through their
    head-transposed views; the output's (B, T, H * D) reshape is free on
    the card (the kernel writes (B, T, H, D) memory)."""
    b, t, h, d = q.shape
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), None, None, False,
                          head_dim ** -0.5)
    return out.transpose(1, 2).reshape(b, t, h * d)


class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        mlp = int(d * cfg.mlp_ratio)
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", _dense(cfg, d, 6 * d, device))
            for p in ("q", "k", "v", "proj"):
                self.add_module(f"{s}_{p}", _dense(cfg, d, d, device))
            self.add_module(f"{s}_qknorm", QKNorm(hd, cfg.dtype, device))
            self.add_module(f"{s}_mlp1", _dense(cfg, d, mlp, device))
            self.add_module(f"{s}_mlp2", _dense(cfg, mlp, d, device))

    def _qkv(self, x, s):
        b, n, _ = x.shape
        h, hd = self.cfg.num_heads, self.cfg.head_dim
        q, k, v = (getattr(self, f"{s}_{p}")(x).reshape(b, n, h, hd)
                   for p in ("q", "k", "v"))
        q, k = getattr(self, f"{s}_qknorm")(q, k)
        return q, k, v

    def forward(self, img, txt, temb, cos, sin):
        mod = F.silu(temb)
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = \
            self.img_mod(mod).chunk(6, dim=-1)
        t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = \
            self.txt_mod(mod).chunk(6, dim=-1)
        with span("flux.norm_mod"):
            img_n = modulate(_layernorm(img), i_shift1, i_scale1)
        with span("flux.norm_mod"):
            txt_n = modulate(_layernorm(txt), t_shift1, t_scale1)
        st = txt.shape[1]
        iq, ik, iv = self._qkv(img_n, "img")
        tq, tk, tv = self._qkv(txt_n, "txt")
        # the joint sequence is [txt; img] (diffusers' order)
        cs = (cos[:, None], sin[:, None])
        with span("flux.rope"):
            q = apply_rope_interleaved(torch.cat([tq, iq], 1), *cs)
            k = apply_rope_interleaved(torch.cat([tk, ik], 1), *cs)
            v = torch.cat([tv, iv], 1)
        out = _attention(q, k, v, self.cfg.head_dim)
        txt_attn, img_attn = out[:, :st], out[:, st:]

        o = self.img_proj(img_attn)
        with span("flux.residual"):
            img = img + i_gate1[:, None] * o
        o = self.txt_proj(txt_attn)
        with span("flux.residual"):
            txt = txt + t_gate1[:, None] * o
        with span("flux.norm_mod"):
            img_m = modulate(_layernorm(img), i_shift2, i_scale2)
        img_m = F.gelu(self.img_mlp1(img_m), approximate="tanh")
        o = self.img_mlp2(img_m)
        with span("flux.residual"):
            img = img + i_gate2[:, None] * o
        with span("flux.norm_mod"):
            txt_m = modulate(_layernorm(txt), t_shift2, t_scale2)
        txt_m = F.gelu(self.txt_mlp1(txt_m), approximate="tanh")
        o = self.txt_mlp2(txt_m)
        with span("flux.residual"):
            txt = txt + t_gate2[:, None] * o
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        mlp = int(d * cfg.mlp_ratio)
        self.mod = _dense(cfg, d, 3 * d, device)
        self.q = _dense(cfg, d, d, device)
        self.k = _dense(cfg, d, d, device)
        self.v = _dense(cfg, d, d, device)
        self.qknorm = QKNorm(cfg.head_dim, cfg.dtype, device)
        self.mlp = _dense(cfg, d, mlp, device)
        self.proj_out = _dense(cfg, d + mlp, d, device)

    def forward(self, x, temb, cos, sin):
        cfg = self.cfg
        shift, scale, gate = self.mod(F.silu(temb)).chunk(3, dim=-1)
        with span("flux.norm_mod"):
            xn = modulate(_layernorm(x), shift, scale)
        b, s, _ = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        q, k = self.qknorm(self.q(xn).reshape(b, s, h, hd),
                           self.k(xn).reshape(b, s, h, hd))
        cs = (cos[:, None], sin[:, None])
        with span("flux.rope"):
            q = apply_rope_interleaved(q, *cs)
            k = apply_rope_interleaved(k, *cs)
        attn = _attention(q, k, self.v(xn).reshape(b, s, h, hd), hd)
        mlp = F.gelu(self.mlp(xn), approximate="tanh")
        out = self.proj_out(torch.cat([attn, mlp], dim=-1))
        with span("flux.residual"):
            return x + gate[:, None] * out


class FluxTransformer(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.x_embedder = _dense(cfg, cfg.in_channels, d, device)
        self.context_embedder = _dense(cfg, cfg.joint_attention_dim, d, device)
        self.timestep_embedder = MLPEmbedder(256, d, cfg.dtype, device)
        if cfg.guidance_embeds:
            self.guidance_embedder = MLPEmbedder(256, d, cfg.dtype, device)
        self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, d,
                                         cfg.dtype, device)
        self.double_blocks = []
        for i in range(cfg.num_double_layers):
            blk = DoubleBlock(cfg, device)
            self.add_module(f"double_{i}", blk)
            self.double_blocks.append(blk)
        self.single_blocks = []
        for i in range(cfg.num_single_layers):
            blk = SingleBlock(cfg, device)
            self.add_module(f"single_{i}", blk)
            self.single_blocks.append(blk)
        self.norm_out = _dense(cfg, d, 2 * d, device)
        self.proj_out = _dense(cfg, d, cfg.in_channels, device)

    def forward(self, img, txt, pooled, timestep, img_ids, txt_ids,
                guidance=None):
        """img: (B, S_img, in_channels) packed latents; txt: (B, S_txt,
        joint_dim) external prompt embeds; pooled: (B, pooled_dim);
        timestep (B,) in [0, 1]; ids: (S, 3). Returns the velocity
        prediction (B, S_img, in_channels) in the model dtype."""
        cfg = self.cfg
        img = self.x_embedder(img.to(cfg.dtype))
        txt = self.context_embedder(txt.to(cfg.dtype))
        temb = self.timestep_embedder(
            timestep_embedding(timestep * 1000.0, 256).to(cfg.dtype))
        if cfg.guidance_embeds:
            g = (guidance if guidance is not None
                 else torch.ones_like(timestep) * 3.5)
            temb = temb + self.guidance_embedder(
                timestep_embedding(g * 1000.0, 256).to(cfg.dtype))
        temb = temb + self.text_embedder(pooled.to(cfg.dtype))

        ids = torch.cat([txt_ids, img_ids], dim=0)  # (S_txt + S_img, 3)
        cos, sin = flux_rope_cos_sin(ids, cfg.axes_dims_rope, cfg.rope_theta)
        for blk in self.double_blocks:
            img, txt = blk(img, txt, temb, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for blk in self.single_blocks:
            x = blk(x, temb, cos, sin)
        img = x[:, txt.shape[1]:]

        # the final AdaLayerNormContinuous: (scale, shift) in this order
        scale, shift = self.norm_out(F.silu(temb)).chunk(2, dim=-1)
        img = _layernorm(img) * (1.0 + scale[:, None]) + shift[:, None]
        return self.proj_out(img)


# ---------------------------------------------------------------------------
# Latent packing and ids
# ---------------------------------------------------------------------------

def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2*W/2, 4C) 2x2 patch packing."""
    b, hgt, wdt, c = latents.shape
    x = latents.reshape(b, hgt // 2, 2, wdt // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, H/2, W/2, C, 2, 2)
    return x.reshape(b, (hgt // 2) * (wdt // 2), c * 4)


def unpack_latents(packed: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """(B, H/2*W/2, 4C) -> (B, H, W, C)."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, height // 2, width // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, height, width, c)


def make_img_ids(height: int, width: int) -> np.ndarray:
    """(H/2*W/2, 3) ids: (0, y, x) over the packed grid."""
    h2, w2 = height // 2, width // 2
    ids = np.zeros((h2, w2, 3), np.float32)
    ids[..., 1] = np.arange(h2)[:, None]
    ids[..., 2] = np.arange(w2)[None, :]
    return ids.reshape(-1, 3)


# ---------------------------------------------------------------------------
# diffusers weight conversion (FluxTransformer2DModel key layout)
# ---------------------------------------------------------------------------

def convert_flux(sd: Dict[str, np.ndarray], dtype=None) -> Dict[str, Any]:
    """A diffusers ``FluxTransformer2DModel`` state dict (numpy) -> the JAX
    parameter tree: linear weights transposed to (in, out); leaves cast to
    the numpy ``dtype`` when one is given."""
    from thinkdiff_torch.models.bridge import unflatten

    flat: Dict[str, np.ndarray] = {}

    def put(name, key, transpose=True):
        arr = sd[key]
        if transpose and arr.ndim == 2:
            arr = arr.T
        if dtype is not None:
            arr = arr.astype(dtype)
        flat[name] = arr

    def put_linear(name, key):
        put(f"{name}/kernel", key + ".weight")
        if key + ".bias" in sd:
            put(f"{name}/bias", key + ".bias", transpose=False)

    put_linear("x_embedder", "x_embedder")
    put_linear("context_embedder", "context_embedder")
    tte = "time_text_embed."
    for emb in ("timestep_embedder", "guidance_embedder", "text_embedder"):
        # FLUX.1-schnell has no guidance embedder
        if emb != "guidance_embedder" or f"{tte}{emb}.linear_1.weight" in sd:
            put_linear(f"{emb}/linear_1", f"{tte}{emb}.linear_1")
            put_linear(f"{emb}/linear_2", f"{tte}{emb}.linear_2")

    def count(prefix):
        return 1 + max((int(k.split(".")[1]) for k in sd
                        if k.startswith(prefix)), default=-1)

    for i in range(count("transformer_blocks.")):
        hb, ob = f"transformer_blocks.{i}.", f"double_{i}"
        for ours, theirs in (
                ("img_mod", "norm1.linear"),
                ("txt_mod", "norm1_context.linear"),
                ("img_q", "attn.to_q"), ("img_k", "attn.to_k"),
                ("img_v", "attn.to_v"), ("txt_q", "attn.add_q_proj"),
                ("txt_k", "attn.add_k_proj"), ("txt_v", "attn.add_v_proj"),
                ("img_proj", "attn.to_out.0"), ("txt_proj", "attn.to_add_out"),
                ("img_mlp1", "ff.net.0.proj"), ("img_mlp2", "ff.net.2"),
                ("txt_mlp1", "ff_context.net.0.proj"),
                ("txt_mlp2", "ff_context.net.2")):
            put_linear(f"{ob}/{ours}", hb + theirs)
        for ours, theirs in (("img_qknorm/q_scale", "attn.norm_q"),
                             ("img_qknorm/k_scale", "attn.norm_k"),
                             ("txt_qknorm/q_scale", "attn.norm_added_q"),
                             ("txt_qknorm/k_scale", "attn.norm_added_k")):
            put(f"{ob}/{ours}", hb + theirs + ".weight", False)

    for i in range(count("single_transformer_blocks.")):
        hb, ob = f"single_transformer_blocks.{i}.", f"single_{i}"
        for ours, theirs in (("mod", "norm.linear"), ("q", "attn.to_q"),
                             ("k", "attn.to_k"), ("v", "attn.to_v"),
                             ("mlp", "proj_mlp"), ("proj_out", "proj_out")):
            put_linear(f"{ob}/{ours}", hb + theirs)
        put(f"{ob}/qknorm/q_scale", hb + "attn.norm_q.weight", False)
        put(f"{ob}/qknorm/k_scale", hb + "attn.norm_k.weight", False)

    put_linear("norm_out", "norm_out.linear")
    put_linear("proj_out", "proj_out")
    return unflatten(flat)
