"""FLUX AutoencoderKL decoder, latents -> RGB (counterpart of
thinkdiff_tpu/models/flux_vae.py).

FLUX VAE: 16 latent channels, block_out_channels (128, 256, 512, 512), 2
layers a block + 1 more in each decoder up-block, a mid block with one
attention, GroupNorm(32) + silu, scaling_factor 0.3611, shift_factor
0.1159.

Convolutions, group norms and the mid block's attention are plain PyTorch,
as JAX leaves them to XLA: no TPU kernel stands behind them. The public
functions take and return NHWC, as in JAX. Inside, activations stay NCHW
views of NHWC memory (PyTorch's channels_last), the layout its
convolutions take without a copy, and each conv kernel is kept as the JAX
(kh, kw, in, out) parameter over (out, kh, kw, in) memory, so that its
(out, in, kh, kw) view is channels_last too. Group norms compute in f32
and cast back, as flax's ``GroupNorm`` does at dtype bf16.

On a mesh (JAX's rules, parallel/sharding.py) the conv kernels, whose
first dimension is kh (1 or 3), stay whole on every rank (a kernel the
rules do split is gathered where it runs); the mid block's attention
projections take their ``fsdp`` blocks (and ``to_out`` its ``model``
rows), gathered or summed by the QDense.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.qwen2_vl import _param
from thinkdiff_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    dtype: Any = torch.float32

    @classmethod
    def flux(cls, **kw):
        return cls(**{**dict(dtype=torch.bfloat16), **kw})

    @classmethod
    def tiny(cls, **kw):
        base = dict(latent_channels=4, block_out_channels=(8, 16),
                    layers_per_block=1, norm_num_groups=4)
        base.update(kw)
        return cls(**base)


class Conv(nn.Module):
    """flax ``nn.Conv`` at stride 1 with padding (k - 1) / 2 on NCHW input."""

    def __init__(self, in_ch: int, out_ch: int, k: int, dtype, device=None):
        super().__init__()
        storage = torch.empty(out_ch, k, k, in_ch, dtype=dtype, device=device)
        self.kernel = nn.Parameter(storage.permute(1, 2, 3, 0),
                                   requires_grad=False)
        self.bias = _param((out_ch,), dtype, device, 0.0)
        self.pad = k // 2

    def forward(self, x):
        # a kernel the rules split over fsdp (kh divisible by it) is
        # gathered; otherwise it is the channels-last view as stored
        kernel = col.leaf_gathered(self, "kernel")
        return F.conv2d(x, kernel.permute(3, 2, 0, 1), self.bias,
                        padding=self.pad)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, ch: int, dtype, device=None):
        super().__init__()
        self.groups = groups
        self.scale = _param((ch,), dtype, device, 1.0)
        self.bias = _param((ch,), dtype, device, 0.0)

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.scale.float(),
                            self.bias.float(), 1e-6).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, dtype,
                 device=None):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, dtype, device)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype, device)
        self.norm2 = GroupNorm(groups, out_ch, dtype, device)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype, device)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, dtype, device)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the h * w positions, its scores and
    softmax in f32 (at a 1024² image: 16,384 positions, a 1 GiB score
    matrix)."""

    def __init__(self, ch: int, groups: int, dtype, device=None):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, dtype, device)
        for n in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(n, QDense(ch, ch, dtype, False, True, device))

    def forward(self, x):
        b, c, hgt, wdt = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hgt * wdt, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q.float(), k.float())
                             / math.sqrt(c), dim=-1)
        h = torch.einsum("bqk,bkc->bqc", attn, v.float()).to(x.dtype)
        h = self.to_out(h).reshape(b, hgt, wdt, c).permute(0, 3, 1, 2)
        return x + h


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        chs, g, dt = list(cfg.block_out_channels), cfg.norm_num_groups, cfg.dtype
        top = chs[-1]
        self.conv_in = Conv(cfg.latent_channels, top, 3, dt, device)
        self.mid_res_0 = ResnetBlock(top, top, g, dt, device)
        self.mid_attn = AttnBlock(top, g, dt, device)
        self.mid_res_1 = ResnetBlock(top, top, g, dt, device)
        self.up = []  # (resnets, upsampling conv or None) per up block
        ch_in = top
        for bi, ch in enumerate(reversed(chs)):
            res = []
            for li in range(cfg.layers_per_block + 1):
                blk = ResnetBlock(ch_in, ch, g, dt, device)
                self.add_module(f"up_{bi}_res_{li}", blk)
                res.append(blk)
                ch_in = ch
            conv = None
            if bi < len(chs) - 1:
                conv = Conv(ch, ch, 3, dt, device)
                self.add_module(f"up_{bi}_conv", conv)
            self.up.append((res, conv))
        self.conv_norm_out = GroupNorm(g, chs[0], dt, device)
        self.conv_out = Conv(chs[0], 3, 3, dt, device)

    def forward(self, z):
        """z: (B, h, w, latent_channels) latents already unscaled
        (z / scale + shift, as the sampler does). Returns (B, 8h, 8w, 3)
        in about [-1, 1], NHWC."""
        x = self.conv_in(z.to(self.cfg.dtype).permute(0, 3, 1, 2))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        for res, conv in self.up:
            for blk in res:
                x = blk(x)
            if conv is not None:
                # flax's jax.image.resize(..., "nearest") at exactly 2x
                x = conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).contiguous()


def convert_vae_decoder(sd: Dict[str, np.ndarray], dtype=None):
    """The decoder subtree of a diffusers ``AutoencoderKL`` state dict
    (numpy) -> the JAX parameter tree: conv weights (O, I, H, W) ->
    (H, W, I, O), linear weights transposed to (in, out)."""
    from thinkdiff_torch.models.bridge import unflatten

    flat: Dict[str, np.ndarray] = {}

    def put(name, key, conv=False):
        arr = sd[key]
        if conv and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        if dtype is not None:
            arr = arr.astype(dtype)
        flat[name] = arr

    def put_conv(name, key):
        put(f"{name}/kernel", key + ".weight", conv=True)
        put(f"{name}/bias", key + ".bias")

    def put_norm(name, key):
        put(f"{name}/scale", key + ".weight")
        put(f"{name}/bias", key + ".bias")

    def put_res(name, key):
        put_norm(f"{name}/norm1", key + ".norm1")
        put_conv(f"{name}/conv1", key + ".conv1")
        put_norm(f"{name}/norm2", key + ".norm2")
        put_conv(f"{name}/conv2", key + ".conv2")
        if key + ".conv_shortcut.weight" in sd:
            put_conv(f"{name}/conv_shortcut", key + ".conv_shortcut")

    p = "decoder."
    put_conv("conv_in", p + "conv_in")
    put_res("mid_res_0", p + "mid_block.resnets.0")
    put_res("mid_res_1", p + "mid_block.resnets.1")
    a = p + "mid_block.attentions.0"
    put_norm("mid_attn/group_norm", a + ".group_norm")
    for src, dst in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                     ("to_out.0", "to_out")):
        put(f"mid_attn/{dst}/kernel", f"{a}.{src}.weight")
        put(f"mid_attn/{dst}/bias", f"{a}.{src}.bias")
    n_up = 1 + max((int(m.group(1)) for k in sd
                    if (m := re.match(r"decoder\.up_blocks\.(\d+)\.", k))),
                   default=-1)
    for bi in range(n_up):
        ub = f"{p}up_blocks.{bi}."
        li = 0
        while f"{ub}resnets.{li}.norm1.weight" in sd:
            put_res(f"up_{bi}_res_{li}", f"{ub}resnets.{li}")
            li += 1
        if f"{ub}upsamplers.0.conv.weight" in sd:
            put_conv(f"up_{bi}_conv", f"{ub}upsamplers.0.conv")
    put_norm("conv_norm_out", p + "conv_norm_out")
    put_conv("conv_out", p + "conv_out")
    return unflatten(flat)
