"""CLIP-style vision transformer (counterpart of thinkdiff_tpu/models/vit.py):
HF ``Blip2VisionModel``, the frozen image encoder of ThinkDiff-CLIP
(``Salesforce/blip2-flan-t5-xxl``'s ViT-g: 39 blocks, width 1408, 16 heads
of 88), and ``CLIPVisionModel``.

Config flags carry the differences: BLIP-2 has no pre-norm, the exact erf
GELU and LayerNorm eps 1e-6; CLIP-L has a pre-norm, quick_gelu and eps
1e-5. Without a relative position bias the attention is the flash forward
(#1, ``ops/flash_attention.py``) on head-transposed views of the q/k/v
projections; with one (EVA's decomposed bias, which no active config sets)
it is the dense f32 softmax the JAX module takes there. The patch
embedding stays ``F.conv2d`` and the LayerNorms plain PyTorch, as JAX
leaves both to XLA.

Public layouts are the JAX ones: ``pixel_values`` NHWC (B, H, W, 3), and the
parameter tree keeps the flax names (``block_0.attn.q_proj.kernel`` (in,
out), ``norm1.scale``, ``patch_embed.kernel`` HWIO), so
``models/bridge.py`` loads a JAX tree key for key (the dense layers are
``QDense``, the LayerNorms the port's flax-named ``LayerNorm``). Every
weight is frozen: the aligner runs the tower under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.qwen2_vl import LayerNorm, _param
from thinkdiff_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_layers: int = 39
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    hidden_act: str = "gelu"          # "gelu" | "quick_gelu"
    layer_norm_eps: float = 1e-6
    use_pre_norm: bool = False        # CLIP True, BLIP-2 False
    patch_bias: bool = True
    # EVA's decomposed relative position bias: a table per block
    # (use_rel_pos_bias) or one shared by all (use_shared_rel_pos_bias)
    use_rel_pos_bias: bool = False
    use_shared_rel_pos_bias: bool = False
    dtype: Any = torch.float32

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    def act_fn(self, x: torch.Tensor) -> torch.Tensor:
        if self.hidden_act == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)

    @classmethod
    def blip2_vision(cls, **kw):
        """Blip2VisionConfig's defaults (blip2-flan-t5-xxl's tower)."""
        return cls(**kw)

    @classmethod
    def clip_vit_l(cls, **kw):
        base = dict(hidden_size=1024, intermediate_size=4096, num_layers=24,
                    num_heads=16, patch_size=14, hidden_act="quick_gelu",
                    layer_norm_eps=1e-5, use_pre_norm=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def eva_vit_g(cls, **kw):
        """EVA-CLIP-g's geometry (patch 14, width 1408, depth 39, MLP ratio
        4.3637)."""
        base = dict(hidden_size=1408, intermediate_size=int(1408 * 4.3637),
                    num_layers=39, num_heads=16, patch_size=14,
                    hidden_act="gelu", use_pre_norm=False)
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw):
        base = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                    num_heads=4, image_size=28, patch_size=14)
        base.update(kw)
        return cls(**base)


def rel_pos_index(grid_h: int, grid_w: int):
    """(N, N) int64 index into the (2H-1)(2W-1)+3 bias table, N = HW + 1:
    patch pairs index by their 2-D offset, and the three extra rows are
    cls->token, token->cls and cls->cls. Returns (index, table rows)."""
    coords = np.stack(np.meshgrid(np.arange(grid_h), np.arange(grid_w),
                                  indexing="ij"))          # (2, H, W)
    flat = coords.reshape(2, -1)                            # (2, HW)
    rel = flat[:, :, None] - flat[:, None, :]               # (2, HW, HW)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += grid_h - 1
    rel[:, :, 1] += grid_w - 1
    rel[:, :, 0] *= 2 * grid_w - 1
    n_dist = (2 * grid_h - 1) * (2 * grid_w - 1) + 3
    idx = np.zeros((grid_h * grid_w + 1,) * 2, np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = n_dist - 3
    idx[0:, 0] = n_dist - 2
    idx[0, 0] = n_dist - 1
    return idx, n_dist


class RelativePositionBias(nn.Module):
    """The bias table and its gather: a (heads, N, N) additive bias."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        g = cfg.image_size // cfg.patch_size
        idx, n_dist = rel_pos_index(g, g)
        self._idx = torch.from_numpy(idx)  # static geometry, not a weight
        self.relative_position_bias_table = _param(
            (n_dist, cfg.num_heads), cfg.dtype, device)

    def forward(self) -> torch.Tensor:
        table = self.relative_position_bias_table
        n = self._idx.shape[0]
        bias = table[self._idx.to(table.device).reshape(-1)]
        return bias.reshape(n, n, -1).permute(2, 0, 1)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, QDense(d, d, cfg.dtype, False, True, device))

    def forward(self, x: torch.Tensor,
                rel_pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, d = x.shape
        hd = d // cfg.num_heads
        # (B, H, T, hd) views of the (B, T, d) projections: no copy
        heads = lambda y: y.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        q, k, v = (heads(p(x)) for p in (self.q_proj, self.k_proj,
                                          self.v_proj))
        if rel_pos_bias is not None:
            # the dense f32 softmax of the JAX module (EVA's short sequences)
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                  k.float()) * hd ** -0.5
            p = torch.softmax(scores + rel_pos_bias[None].float(), dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(x.dtype)
        else:
            out = flash_attention(q, k, v, None, None, False, hd ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ln = lambda: LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                               device)
        if cfg.use_rel_pos_bias:
            self.rel_pos_bias = RelativePositionBias(cfg, device)
        self.norm1 = ln()
        self.attn = ViTAttention(cfg, device)
        self.norm2 = ln()
        self.mlp_fc1 = QDense(cfg.hidden_size, cfg.intermediate_size,
                              cfg.dtype, False, True, device)
        self.mlp_fc2 = QDense(cfg.intermediate_size, cfg.hidden_size,
                              cfg.dtype, False, True, device)

    def forward(self, x, rel_pos_bias=None):
        if self.cfg.use_rel_pos_bias:
            rel_pos_bias = self.rel_pos_bias()
        x = x + self.attn(self.norm1(x), rel_pos_bias)
        return x + self.mlp_fc2(self.cfg.act_fn(self.mlp_fc1(self.norm2(x))))


class PatchEmbed(nn.Module):
    """flax ``nn.Conv`` with a (P, P) VALID window and stride P: ``kernel``
    HWIO (P, P, 3, D), transposed to OIHW for ``F.conv2d``."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.patch = p
        self.kernel = _param((p, p, 3, cfg.hidden_size), cfg.dtype, device)
        self.bias = (_param((cfg.hidden_size,), cfg.dtype, device)
                     if cfg.patch_bias else None)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/P * W/P, D), patches in row-major order."""
        x = pixel_values.to(self.kernel.dtype).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg, device)
        self.cls_token = _param((1, 1, d), cfg.dtype, device)
        self.pos_embed = _param((1, cfg.num_positions, d), cfg.dtype, device)
        if cfg.use_pre_norm:
            self.pre_norm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, device)
        if cfg.use_shared_rel_pos_bias:
            self.rel_pos_bias = RelativePositionBias(cfg, device)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", ViTBlock(cfg, device))
        self.post_norm = LayerNorm(d, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 3), normalized -> (B, 1 + H/P * W/P,
        hidden): the post-norm last hidden states (HF's
        ``last_hidden_state``)."""
        cfg = self.cfg
        x = self.patch_embed(pixel_values)
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, 1, cfg.hidden_size), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]]
        if cfg.use_pre_norm:
            x = self.pre_norm(x)
        shared = self.rel_pos_bias() if cfg.use_shared_rel_pos_bias else None
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, shared)
        return self.post_norm(x)


@torch.no_grad()
def init_vit_(vit: VisionTransformer, generator: torch.Generator,
              std: float = 0.02) -> None:
    """Seeded random weights in place on the module's device: kernels,
    tokens and position embeddings N(0, std), biases 0, LayerNorm scales 1,
    bias tables N(0, std)."""
    for name, p in vit.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)


def vision_downsample(tokens: torch.Tensor, factor: int) -> torch.Tensor:
    """The CLS-preserving spatial pool of the patch grid: keep token 0,
    reshape the rest to (g, g) and resize bilinearly to (g/f, g/f) with
    antialiasing, as ``jax.image.resize(..., "bilinear")`` does when it
    shrinks (the default ``antialias=False`` of ``F.interpolate`` is not
    that function). In f32, the result in the tokens' dtype."""
    b, t, d = tokens.shape
    g = int(round((t - 1) ** 0.5))
    if g * g != t - 1:
        raise ValueError(f"vision_downsample: non-square grid {t - 1}")
    new_g = g // factor
    grid = tokens[:, 1:].float().reshape(b, g, g, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(new_g, new_g), mode="bilinear",
                         align_corners=False, antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(b, new_g * new_g, d)
    return torch.cat([tokens[:, :1], grid.to(tokens.dtype)], dim=1)
