"""CogVideoX-5b video diffusion transformer and its v-prediction DDIM
sampler in PyTorch (counterpart of thinkdiff_tpu/models/cogvideox.py).

ThinkDiff-CLIP composes its conditions (the first 65 projected vision
tokens, then T5 text embeds, within a 226-token budget) into CogVideoX-5b
for image + text -> video. The model: a joint [text; video] sequence, 42
blocks of width 3072 = 48 heads x 64; each block's "LayerNormZero" is ONE
shared affine LayerNorm with a 6-way modulation from the timestep
embedding, chunked video first; q/k LayerNorm over the head dim (eps 1e-6)
before a 3D RoPE over the (t, y, x) patch grid of the video tokens only;
gelu-tanh FFN; an affine ``norm_final``, an AdaLayerNorm head (shift
first) and the patch unprojection; v-prediction.

Module and parameter names are the JAX tree's (``block_3/to_q/kernel`` is
``block_3.to_q.kernel`` here), so models/bridge.py loads a JAX tree key for
key; ``convert_cogvideox`` makes that tree from a diffusers
``CogVideoXTransformer3DModel`` state dict. Every projection is a QDense
(float, weight-only int8 or w8a8, ``quant_int8``), cuBLAS in bf16, as JAX
leaves them to XLA; the LayerNorms are plain PyTorch in f32 (ops/norms
``layernorm``), as in JAX.

Kernel on this path: the joint attention goes through the flash forward
(ops/flash_attention, #1): at the 49-frame 480x720 operating point B1 H48
T17776 D64, unmasked. q and k are the (B, S, H, D) concatenations of the
text rows and the rotated video rows, v the projection itself; the kernel
reads their head-transposed views and writes its output as such a view.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch import resolve_device
from thinkdiff_torch.models.flux import (
    MLPEmbedder, apply_rope_interleaved, modulate, timestep_embedding)
from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.qwen2_vl import LayerNorm
from thinkdiff_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    """The JAX ``CogVideoXConfig`` without its flash-attention tile fields
    (``attn_block_q``, ``attn_block_k``): those size the Pallas kernel's
    tiles for a TPU's VMEM. The port's flash wrapper picks its own tiles
    from the call's shapes (ops/flash_attention ``flash_fwd_tiles``)."""

    in_channels: int = 16
    hidden_size: int = 3072          # 5b; 2b = 1920
    num_heads: int = 48              # 5b; 2b = 30
    num_layers: int = 42             # 5b; 2b = 30
    text_dim: int = 4096             # T5-xxl
    patch_size: int = 2
    time_embed_dim: int = 512
    mlp_ratio: float = 4.0
    rope_theta: float = 10000.0
    max_text_len: int = 226
    dtype: Any = torch.float32
    quant_int8: Any = False          # False | True/"int8" | "w8a8" (QDense)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def cogvideox_5b(cls, **kw):
        return cls(**{**dict(dtype=torch.bfloat16), **kw})

    @classmethod
    def tiny(cls, **kw):
        base = dict(in_channels=4, hidden_size=64, num_heads=4, num_layers=2,
                    text_dim=32, patch_size=2, time_embed_dim=32,
                    max_text_len=8)
        base.update(kw)
        return cls(**base)


@functools.lru_cache(maxsize=8)
def _video_rope_tables(t: int, h: int, w: int, head_dim: int,
                       theta: float) -> Tuple[np.ndarray, np.ndarray]:
    dims = [head_dim // 4, (head_dim - head_dim // 4) // 2,
            (head_dim - head_dim // 4) // 2]
    dims = [d - d % 2 for d in dims]  # even
    dims[0] += head_dim - sum(dims)
    grids = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                        indexing="ij")
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(dims):
        omega = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = grids[axis].reshape(-1, 1).astype(np.float64) * omega[None]
        cos_parts.append(np.repeat(np.cos(ang), 2, axis=-1))
        sin_parts.append(np.repeat(np.sin(ang), 2, axis=-1))
    return (np.concatenate(cos_parts, -1).astype(np.float32),
            np.concatenate(sin_parts, -1).astype(np.float32))


def video_rope_cos_sin(t: int, h: int, w: int, head_dim: int, theta: float,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rope tables over the (t, y, x) patch grid -> f32 (t*h*w,
    head_dim) cos and sin: the head dim split D/4 (time) and the rest in two
    even halves (y, x), each angle repeated for its pair; computed in
    float64 and rounded once, as in JAX."""
    cos, sin = _video_rope_tables(t, h, w, head_dim, float(theta))
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def _dense(cfg: CogVideoXConfig, in_dim: int, features: int, device) -> QDense:
    return QDense(in_dim, features, cfg.dtype, cfg.quant_int8, True, device)


def _attention(q, k, v, head_dim: int) -> torch.Tensor:
    """Unmasked joint attention of (B, T, H, D) q, k, v through their
    head-transposed views -> (B, T, H * D)."""
    b, t, h, d = q.shape
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), None, None, False,
                          head_dim ** -0.5)
    return out.transpose(1, 2).reshape(b, t, h * d)


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd, te = cfg.hidden_size, cfg.head_dim, cfg.time_embed_dim
        for i in (1, 2):
            self.add_module(f"norm{i}_ln", LayerNorm(d, 1e-5, cfg.dtype, device))
            self.add_module(f"norm{i}_mod", _dense(cfg, te, 6 * d, device))
        for p in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(p, _dense(cfg, d, d, device))
        self.norm_q = LayerNorm(hd, 1e-6, cfg.dtype, device)
        self.norm_k = LayerNorm(hd, 1e-6, cfg.dtype, device)
        self.ff1 = _dense(cfg, d, int(d * cfg.mlp_ratio), device)
        self.ff2 = _dense(cfg, int(d * cfg.mlp_ratio), d, device)

    def _modulated(self, i, txt, vid, temb):
        """The shared LayerNorm of both streams, each modulated by its
        chunks (video first): (joint [txt; vid], video gate, text gate)."""
        vs, vc, vg, ts, tc, tg = getattr(self, f"norm{i}_mod")(
            F.silu(temb)).chunk(6, dim=-1)
        ln = getattr(self, f"norm{i}_ln")
        return (torch.cat([modulate(ln(txt), ts, tc),
                           modulate(ln(vid), vs, vc)], dim=1), vg, tg)

    def forward(self, txt, vid, temb, cos, sin):
        cfg = self.cfg
        h, hd = cfg.num_heads, cfg.head_dim
        st = txt.shape[1]
        x, vg1, tg1 = self._modulated(1, txt, vid, temb)
        b, s, _ = x.shape
        q, k, v = (getattr(self, p)(x).reshape(b, s, h, hd)
                   for p in ("to_q", "to_k", "to_v"))
        # qk-norm over the head dim BEFORE rope; rope on the video rows only
        # (the text rows are position-free)
        q, k = self.norm_q(q), self.norm_k(k)
        cs = (cos[:, None], sin[:, None])
        q = torch.cat([q[:, :st], apply_rope_interleaved(q[:, st:], *cs)], 1)
        k = torch.cat([k[:, :st], apply_rope_interleaved(k[:, st:], *cs)], 1)
        attn = self.to_out(_attention(q, k, v, hd))
        txt = txt + tg1[:, None] * attn[:, :st]
        vid = vid + vg1[:, None] * attn[:, st:]

        y, vg2, tg2 = self._modulated(2, txt, vid, temb)
        y = self.ff2(F.gelu(self.ff1(y), approximate="tanh"))
        txt = txt + tg2[:, None] * y[:, :st]
        vid = vid + vg2[:, None] * y[:, st:]
        return txt, vid


class CogVideoXTransformer(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = _dense(cfg, p * p * cfg.in_channels, d, device)
        self.text_embed = _dense(cfg, cfg.text_dim, d, device)
        self.time_embed = MLPEmbedder(d, cfg.time_embed_dim, cfg.dtype, device)
        self.blocks = []
        for i in range(cfg.num_layers):
            blk = CogVideoXBlock(cfg, device)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.norm_final = LayerNorm(d, 1e-5, cfg.dtype, device)
        self.norm_out_mod = _dense(cfg, cfg.time_embed_dim, 2 * d, device)
        self.norm_out_ln = LayerNorm(d, 1e-5, cfg.dtype, device)
        self.proj_out = _dense(cfg, d, p * p * cfg.in_channels, device)

    def forward(self, latents, text_embeds, timestep):
        """latents (B, T, H, W, C) latent frames; text_embeds (B, S,
        text_dim); timestep (B,) integers. Returns the v-prediction with the
        latents' shape, in the model dtype."""
        cfg = self.cfg
        b, t, hgt, wdt, c = latents.shape
        p = cfg.patch_size
        hp, wp = hgt // p, wdt // p
        x = latents.reshape(b, t, hp, p, wp, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        vid = self.patch_embed(x.reshape(b, t * hp * wp, p * p * c)
                               .to(cfg.dtype))
        txt = self.text_embed(text_embeds.to(cfg.dtype))
        # timestep frequencies at the hidden size, then hidden -> 512
        temb = self.time_embed(timestep_embedding(
            timestep.float(), cfg.hidden_size).to(cfg.dtype))
        cos, sin = video_rope_cos_sin(t, hp, wp, cfg.head_dim, cfg.rope_theta,
                                      latents.device)
        for blk in self.blocks:
            txt, vid = blk(txt, vid, temb, cos, sin)

        # norm_final is the affine LayerNorm of the joint sequence: per token,
        # so the video rows the head reads are normalized alone
        vid = self.norm_final(vid)
        shift, scale = self.norm_out_mod(F.silu(temb)).chunk(2, dim=-1)
        vid = modulate(self.norm_out_ln(vid), shift, scale)
        # feature order (ph, pw, c); convert_cogvideox permutes diffusers'
        # (c, ph, pw) proj_out into it
        out = self.proj_out(vid).reshape(b, t, hp, wp, p, p, c)
        return out.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hgt, wdt, c)


# ---------------------------------------------------------------------------
# v-prediction DDIM sampler with dynamic classifier-free guidance
# ---------------------------------------------------------------------------

def cosine_betas(num_train_steps: int = 1000, s: float = 0.008) -> np.ndarray:
    steps = np.arange(num_train_steps + 1, dtype=np.float64)
    f = np.cos((steps / num_train_steps + s) / (1 + s) * math.pi / 2) ** 2
    alphas_bar = f / f[0]
    betas = 1 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0, 0.999)


class CogVideoXSampler:
    """DDIM over v-prediction (CogVideoXDDIMScheduler semantics) with the
    pipeline's dynamic cfg: the guidance ramps with a cosine over the steps.
    Each step runs the transformer twice, on the condition and then on
    zeros of its shape (the unconditional branch), as JAX does.

    The trajectory is carried in f32; the guided velocity is formed in f32
    from the model's two outputs (their difference in the model dtype, as
    JAX promotes it), and the DDIM coefficients are f32 scalars. JAX's
    ``mesh`` argument is dropped: the 5.3 B model fits one 80 GB card
    whole. The sampler runs on its device (``device="cuda"`` by default,
    raising without a card; ``device="cpu"`` runs the kernels' plain
    versions)."""

    def __init__(self, cfg: CogVideoXConfig, transformer: CogVideoXTransformer,
                 num_train_steps: int = 1000, device="cuda"):
        """``transformer``: the module holding its weights, on ``device``
        (JAX passes the parameter tree; ``bridge.load_params`` loads such a
        tree into a module)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.transformer = transformer
        self.alphas_bar = np.cumprod(1.0 - cosine_betas(num_train_steps))
        self.num_train_steps = num_train_steps

    def schedule(self, num_steps: int, guidance: float,
                 use_dynamic_cfg: bool = True):
        """[(timestep, alpha_bar_t, alpha_bar_prev, g)] of each step, the
        three last as f32 scalars, as JAX passes them to its jitted step."""
        step_idx = np.linspace(self.num_train_steps - 1, 0,
                               num_steps).astype(int)
        out = []
        for i, t_cur in enumerate(step_idx):
            t_prev = step_idx[i + 1] if i + 1 < len(step_idx) else -1
            g = guidance
            if use_dynamic_cfg:
                g = 1 + (guidance - 1) * (
                    1 - math.cos(math.pi * (num_steps - i) / num_steps)) / 2
            a_prev = self.alphas_bar[t_prev] if t_prev >= 0 else 1.0
            out.append((int(t_cur), np.float32(self.alphas_bar[t_cur]),
                        np.float32(a_prev), np.float32(g)))
        return out

    @torch.no_grad()
    def denoise(self, latents, text_embeds, num_steps: int = 50,
                guidance: float = 6.0,
                use_dynamic_cfg: bool = True) -> torch.Tensor:
        """``num_steps`` DDIM steps from ``latents`` (B, T, H, W, C) on
        ``text_embeds`` (B, S, text_dim): JAX's ``sample`` loop after its
        noise draw. Returns the final latents (f32)."""
        dev = self.device
        lat = torch.as_tensor(latents, device=dev).float()
        cond = torch.as_tensor(text_embeds, device=dev)
        null = torch.zeros_like(cond)
        b = lat.shape[0]
        one = np.float32(1.0)
        for t_cur, a_t, a_prev, g in self.schedule(num_steps, guidance,
                                                   use_dynamic_cfg):
            ts = torch.full((b,), t_cur, dtype=torch.int32, device=dev)
            v_cond = self.transformer(lat, cond, ts)
            v_uncond = self.transformer(lat, null, ts)
            v = v_uncond.float() + float(g) * (v_cond - v_uncond).float()
            # v-prediction -> x0 and eps -> the DDIM update, in f32
            sa, s1a = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
            x0 = sa * lat - s1a * v
            eps = sa * v + s1a * lat
            lat = (float(np.sqrt(a_prev)) * x0
                   + float(np.sqrt(one - a_prev)) * eps)
        return lat

    def noise(self, batch: int, frames: int, height: int, width: int,
              seed: int) -> torch.Tensor:
        """The initial latents (batch, frames, height, width, C), f32: a
        normal draw of a ``torch.Generator`` seeded with ``seed`` on the
        sampler's device. It cannot equal JAX's ``jax.random.normal`` draw,
        so the same seed gives another video than the JAX sampler; parity
        is held on explicit latents (``denoise``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((batch, frames, height, width, self.cfg.in_channels),
                           generator=gen, dtype=torch.float32,
                           device=self.device)

    def sample(self, text_embeds, frames: int = 4, height: int = 32,
               width: int = 32, num_steps: int = 50, guidance: float = 6.0,
               use_dynamic_cfg: bool = True, seed: int = 0) -> torch.Tensor:
        """``noise``'s draw for ``seed`` through ``denoise``: the final f32
        latents (B, frames, height, width, C)."""
        lat = self.noise(text_embeds.shape[0], frames, height, width, seed)
        return self.denoise(lat, text_embeds, num_steps, guidance,
                            use_dynamic_cfg)


# ---------------------------------------------------------------------------
# diffusers weight conversion (CogVideoXTransformer3DModel key layout)
# ---------------------------------------------------------------------------

def convert_cogvideox(sd: Dict[str, np.ndarray],
                      dtype: Optional[Any] = None) -> Dict[str, Any]:
    """A diffusers ``CogVideoXTransformer3DModel`` state dict (numpy) -> the
    JAX parameter tree: linear weights transposed to (in, out); the 5b's
    Conv2d ``patch_embed.proj`` (D, C, p, p) as a dense over (p, p,
    C)-flattened patches; ``proj_out``'s (C, p, p) feature order permuted
    to (p, p, C); leaves cast to the numpy ``dtype`` when one is given."""
    import re

    from thinkdiff_torch.models.bridge import unflatten

    flat: Dict[str, np.ndarray] = {}

    def cast(a):
        return a.astype(dtype) if dtype is not None else a

    def put_linear(name, key):
        arr = sd[key + ".weight"]
        flat[name + "/kernel"] = cast(arr.T if arr.ndim == 2 else arr)
        if key + ".bias" in sd:
            flat[name + "/bias"] = cast(sd[key + ".bias"])

    def put_ln(name, key):
        flat[name + "/scale"] = cast(sd[key + ".weight"])
        flat[name + "/bias"] = cast(sd[key + ".bias"])

    pw = sd["patch_embed.proj.weight"]
    if pw.ndim == 4:  # Conv2d (D, C, ph, pw) -> (ph*pw*C, D) dense kernel
        dd, cc, p1, p2 = pw.shape
        flat["patch_embed/kernel"] = cast(
            pw.transpose(2, 3, 1, 0).reshape(p1 * p2 * cc, dd))
        flat["patch_embed/bias"] = cast(sd["patch_embed.proj.bias"])
        patch, cout = p1, cc
    else:  # the 1.5 family's Linear, as JAX takes it
        put_linear("patch_embed", "patch_embed.proj")
        patch, cout = None, None
    put_linear("text_embed", "patch_embed.text_proj")
    put_linear("time_embed/linear_1", "time_embedding.linear_1")
    put_linear("time_embed/linear_2", "time_embedding.linear_2")
    n = 1 + max((int(m.group(1)) for k in sd
                 if (m := re.match(r"transformer_blocks\.(\d+)\.", k))),
                default=-1)
    for i in range(n):
        hb, ob = f"transformer_blocks.{i}.", f"block_{i}"
        put_linear(f"{ob}/norm1_mod", hb + "norm1.linear")
        put_linear(f"{ob}/norm2_mod", hb + "norm2.linear")
        put_ln(f"{ob}/norm1_ln", hb + "norm1.norm")
        put_ln(f"{ob}/norm2_ln", hb + "norm2.norm")
        for p in ("to_q", "to_k", "to_v"):
            put_linear(f"{ob}/{p}", hb + f"attn1.{p}")
        put_linear(f"{ob}/to_out", hb + "attn1.to_out.0")
        put_ln(f"{ob}/norm_q", hb + "attn1.norm_q")
        put_ln(f"{ob}/norm_k", hb + "attn1.norm_k")
        put_linear(f"{ob}/ff1", hb + "ff.net.0.proj")
        put_linear(f"{ob}/ff2", hb + "ff.net.2")
    put_ln("norm_final", "norm_final")
    put_linear("norm_out_mod", "norm_out.linear")
    put_ln("norm_out_ln", "norm_out.norm")
    put_linear("proj_out", "proj_out")
    if patch is not None:  # (D, C*p*p in (C, p, p) order) -> (D, p*p*C)
        k = flat["proj_out/kernel"]
        flat["proj_out/kernel"] = k.reshape(
            k.shape[0], cout, patch, patch).transpose(0, 2, 3, 1).reshape(
            k.shape[0], patch * patch * cout)
        flat["proj_out/bias"] = flat["proj_out/bias"].reshape(
            cout, patch, patch).transpose(1, 2, 0).reshape(-1)
    return unflatten(flat)
