"""CogVideoX 3D causal VAE, decoder path (latents -> video frames), in
PyTorch (counterpart of thinkdiff_tpu/models/cogvideox_vae.py).

  conv_in (causal 3D) -> mid block (2 spatial-norm resnets) -> 4 up blocks
  (layers_per_block + 1 resnets and a nearest 2x upsample; the first
  log2(temporal_compression) blocks also upsample time) -> spatial-norm out
  -> silu -> conv_out (3 channels)

  - causal 3D conv: time padded on the LEFT with kt - 1 copies of the first
    frame (frame t never sees the future), space padded with zeros;
  - SpatialNorm3D: group-normed features modulated by 1x1x1 causal convs of
    the nearest-resized latents, the first frame resized on its own when the
    frame counts are 2n + 1 against n + 1;
  - temporal upsampling keeps the first frame single: T -> 2T - 1, so 13
    latent frames decode to 49.

Convolutions and group norms are plain PyTorch (cuDNN on the card), as JAX
leaves them to XLA: no TPU kernel stands behind them. The public functions
take and return channels-last arrays (B, T, H, W, C), as in JAX, and the
activations stay that way: each convolution reads an NCDHW view of that
memory (channels_last_3d, the layout cuDNN takes without a copy) with its
kernel kept as the JAX (kt, kh, kw, in, out) parameter over (out, kt, kh,
kw, in) memory. Group norms take their statistics in f32 and cast back, as
flax's ``GroupNorm`` does.

``decode_latents`` keeps JAX's ``tile="auto"`` rule, its clamped tile
starts and its linear-ramp blend exactly: the rule decides the output (the
blend changes pixels), not only the memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from thinkdiff_torch.models.qwen2_vl import _param


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    dtype: Any = torch.float32

    @classmethod
    def cogvideox_5b(cls, **kw):
        return cls(scaling_factor=0.7, dtype=kw.pop("dtype", torch.bfloat16),
                   **kw)

    @classmethod
    def tiny(cls, **kw):
        return cls(latent_channels=4, block_out_channels=(8, 16),
                   layers_per_block=1, norm_num_groups=4,
                   temporal_compression_ratio=2, **kw)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) memory as the (B, C, T, H, W) view convs take."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCDHW result back to (B, T, H, W, C), copying only when its
    memory is not channels-last."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


class CausalConv3d(nn.Module):
    """3D conv, causal in time (left first-frame pad), SAME in space, on
    (B, T, H, W, C). Parameters ``conv.kernel`` (kt, kh, kw, in, out) and
    ``conv.bias``, as flax names them."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Sequence[int] = (3, 3, 3), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv = nn.Module()
        kt, kh, kw = kernel
        storage = torch.empty(out_ch, kt, kh, kw, in_ch, dtype=dtype,
                              device=device)
        self.conv.kernel = nn.Parameter(storage.permute(1, 2, 3, 4, 0),
                                        requires_grad=False)
        self.conv.bias = _param((out_ch,), dtype, device, 0.0)
        self.kt, self.pad = kt, ((kh - 1) // 2, (kw - 1) // 2)

    def forward(self, x):
        if self.kt > 1:
            b, _, h, w, c = x.shape
            x = torch.cat([x[:, :1].expand(b, self.kt - 1, h, w, c), x], 1)
        y = F.conv3d(_ncdhw(x), self.conv.kernel.permute(4, 3, 0, 1, 2),
                     self.conv.bias, padding=(0, *self.pad))
        return _ndhwc(y)


def _resize_nearest(z: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """(B, Tz, Hz, Wz, C) -> (B, t, h, w, C), nearest (index i * Tz // t)."""
    _, tz, hz, wz, _ = z.shape
    idx = lambda n, nz: torch.arange(n, device=z.device) * nz // n
    return z[:, idx(t, tz)][:, :, idx(h, hz)][:, :, :, idx(w, wz)]


class GroupNorm(nn.Module):
    """flax ``GroupNorm(epsilon=1e-6)`` on (B, T, H, W, C): statistics over
    (T, H, W, C / groups) in f32, cast back to the input's dtype."""

    def __init__(self, groups: int, ch: int, dtype, device=None):
        super().__init__()
        self.groups = groups
        self.scale = _param((ch,), dtype, device, 1.0)
        self.bias = _param((ch,), dtype, device, 0.0)

    def forward(self, x):
        y = F.group_norm(_ncdhw(x).float(), self.groups, self.scale.float(),
                         self.bias.float(), 1e-6)
        return _ndhwc(y.to(x.dtype))


class SpatialNorm3D(nn.Module):
    """GroupNorm(f) modulated by 1x1x1 causal convs of the resized latents
    (diffusers CogVideoXSpatialNorm3D)."""

    def __init__(self, ch: int, zq_ch: int, groups: int, dtype, device=None):
        super().__init__()
        self.norm_layer = GroupNorm(groups, ch, dtype, device)
        self.conv_y = CausalConv3d(zq_ch, ch, (1, 1, 1), dtype, device)
        self.conv_b = CausalConv3d(zq_ch, ch, (1, 1, 1), dtype, device)

    def forward(self, f, zq):
        _, t, h, w, _ = f.shape
        tz = zq.shape[1]
        if t % 2 == 1 and tz % 2 == 1 and t != tz:
            zq = torch.cat([_resize_nearest(zq[:, :1], 1, h, w),
                            _resize_nearest(zq[:, 1:], t - 1, h, w)], 1)
        else:
            zq = _resize_nearest(zq, t, h, w)
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, zq_ch: int, groups: int,
                 dtype, device=None):
        super().__init__()
        self.norm1 = SpatialNorm3D(in_ch, zq_ch, groups, dtype, device)
        self.conv1 = CausalConv3d(in_ch, out_ch, (3, 3, 3), dtype, device)
        self.norm2 = SpatialNorm3D(out_ch, zq_ch, groups, dtype, device)
        self.conv2 = CausalConv3d(out_ch, out_ch, (3, 3, 3), dtype, device)
        self.conv_shortcut = (CausalConv3d(in_ch, out_ch, (1, 1, 1), dtype,
                                           device)
                              if in_ch != out_ch else None)

    def forward(self, x, zq):
        h = self.conv1(F.silu(self.norm1(x, zq)))
        h = self.conv2(F.silu(self.norm2(h, zq)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _repeat2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, 2, axis=dim)``: each index twice, in one copy."""
    shape = list(x.shape)
    y = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], 2, *shape[dim + 1:])
    shape[dim] *= 2
    return y.reshape(shape)


class Upsample3D(nn.Module):
    """Nearest 2x in space (and 2x in time keeping the first frame single
    when ``compress_time``), then a per-frame 3x3 conv (diffusers
    CogVideoXUpsample3D). Parameters ``conv.kernel`` (3, 3, in, out) and
    ``conv.bias``."""

    def __init__(self, ch: int, compress_time: bool, dtype, device=None):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Module()
        storage = torch.empty(ch, 3, 3, ch, dtype=dtype, device=device)
        self.conv.kernel = nn.Parameter(storage.permute(1, 2, 3, 0),
                                        requires_grad=False)
        self.conv.bias = _param((ch,), dtype, device, 0.0)

    def forward(self, x):
        space = lambda y: _repeat2(_repeat2(y, 2), 3)
        if self.compress_time and x.shape[1] > 1:
            x = torch.cat([space(x[:, :1]), space(_repeat2(x[:, 1:], 1))], 1)
        else:
            x = space(x)
        b, t, h, w, c = x.shape
        y = F.conv2d(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                     self.conv.kernel.permute(3, 2, 0, 1), self.conv.bias,
                     padding=1)
        return y.permute(0, 2, 3, 1).contiguous().reshape(b, t, h, w, -1)


class CogVideoXVAEDecoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, g, zc = cfg.dtype, cfg.norm_num_groups, cfg.latent_channels
        channels = list(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(zc, channels[0], (3, 3, 3), dt, device)
        self.mid_res_0 = ResnetBlock3D(channels[0], channels[0], zc, g, dt,
                                       device)
        self.mid_res_1 = ResnetBlock3D(channels[0], channels[0], zc, g, dt,
                                       device)
        temporal_levels = int(np.log2(cfg.temporal_compression_ratio))
        self.up = []  # (resnets, upsample or None) per up block
        ch_in = channels[0]
        for bi, ch in enumerate(channels):
            res = []
            for ri in range(cfg.layers_per_block + 1):
                blk = ResnetBlock3D(ch_in, ch, zc, g, dt, device)
                self.add_module(f"up_{bi}_res_{ri}", blk)
                res.append(blk)
                ch_in = ch
            up = None
            if bi < len(channels) - 1:
                up = Upsample3D(ch, bi < temporal_levels, dt, device)
                self.add_module(f"up_{bi}_upsample", up)
            self.up.append((res, up))
        self.norm_out = SpatialNorm3D(channels[-1], zc, g, dt, device)
        self.conv_out = CausalConv3d(channels[-1], cfg.out_channels,
                                     (3, 3, 3), dt, device)

    def forward(self, z):
        """z (B, T_lat, H_lat, W_lat, C_lat), latents already divided by the
        scaling factor -> (B, T, H, W, 3) in about [-1, 1], in the model
        dtype."""
        zq = z.to(self.cfg.dtype)
        h = self.mid_res_1(self.mid_res_0(self.conv_in(zq), zq), zq)
        for res, up in self.up:
            for blk in res:
                h = blk(h, zq)
            if up is not None:
                h = up(h)
        return self.conv_out(F.silu(self.norm_out(h, zq)))


def _to_uint8(video: torch.Tensor) -> torch.Tensor:
    return ((torch.clamp(video.float(), -1, 1) + 1) * 127.5).to(torch.uint8)


@torch.no_grad()
def decode_latents(decoder: CogVideoXVAEDecoder, latents,
                   scaling_factor: Optional[float] = None,
                   tile: Any = "auto", tile_overlap: int = 8) -> torch.Tensor:
    """(B, T_lat, H_lat, W_lat, C) latents -> uint8 frames (B, T, H, W, 3)
    on the decoder's device.

    ``tile``: None decodes in one pass; (th, tw) decodes in latent-space
    spatial tiles; "auto" (the default) tiles at (32, 48) when the top
    block's activation, T * 8H * 8W * C0 * 2 bytes, would pass 2 GiB (JAX's
    rule: at 13 x 60 x 90 latents, 9 tiles)."""
    dev = decoder.conv_in.conv.bias.device
    sf = scaling_factor or decoder.cfg.scaling_factor
    z = torch.as_tensor(latents, device=dev).float() / sf
    if tile == "auto":
        tile = auto_tile(decoder.cfg, z.shape)
    if tile is None:
        return _to_uint8(decoder(z))
    return _decode_tiled(decoder, z, tile, tile_overlap)


def auto_tile(cfg: CogVideoXVAEConfig, latent_shape) -> Optional[tuple]:
    """JAX's ``tile="auto"`` rule: (32, 48) latent tiles when the top
    block's activation, T_out x 8H x 8W x C0 x 2 bytes, would pass 2 GiB
    (set for a 16 GiB chip, kept because the blend changes the output),
    else None (one pass)."""
    _, t, h, w, _ = latent_shape
    t_out = (t - 1) * cfg.temporal_compression_ratio + 1
    up = 2 ** (len(cfg.block_out_channels) - 1)
    top = t_out * (up * h) * (up * w) * cfg.block_out_channels[0] * 2
    return (32, 48) if top > 2 * 2 ** 30 else None


def tile_starts(total: int, t: int, overlap: int):
    """Tile starts along an axis: stride t - overlap, the last start clamped
    to total - t so every tile has the same shape."""
    if total <= t:
        return [0]
    stride = max(t - overlap, 1)
    out = list(range(0, total - t, stride)) + [total - t]
    return sorted(set(min(st, total - t) for st in out))


def _tile_weights(th, tw, s, overlap, y0, x0, hl, wl) -> np.ndarray:
    """JAX's per-pixel blend weights of one tile, (th*s, tw*s) f32: a linear
    ramp over the overlap on each side that has a neighbour."""
    oh, ow, ov = th * s, tw * s, overlap * s
    wy, wx = np.ones(oh, np.float32), np.ones(ow, np.float32)
    ramp = (np.arange(ov, dtype=np.float32) + 1.0) / (ov + 1.0)
    if y0 > 0:
        wy[:ov] = ramp
    if y0 + th < hl:
        wy[-ov:] = ramp[::-1]
    if x0 > 0:
        wx[:ov] = ramp
    if x0 + tw < wl:
        wx[-ov:] = ramp[::-1]
    return wy[:, None] * wx[None, :]


def _decode_tiled(decoder, z, tile, overlap) -> torch.Tensor:
    """Overlapping spatial tiles of one shape (starts clamped), each decoded
    whole in time, blended on an f32 canvas on the device with JAX's ramp
    weights: the same sums in the same order as JAX's host canvas."""
    b, _, hl, wl, _ = z.shape
    th, tw = min(tile[0], hl), min(tile[1], wl)
    s = 2 ** (len(decoder.cfg.block_out_channels) - 1)
    canvas = wsum = None
    for y0 in tile_starts(hl, th, overlap):
        for x0 in tile_starts(wl, tw, overlap):
            out = decoder(z[:, :, y0:y0 + th, x0:x0 + tw]).float()
            if canvas is None:
                canvas = torch.zeros((b, out.shape[1], hl * s, wl * s,
                                      out.shape[-1]), device=z.device)
                wsum = torch.zeros((1, 1, hl * s, wl * s, 1), device=z.device)
            w = torch.from_numpy(_tile_weights(th, tw, s, overlap, y0, x0, hl,
                                               wl)).to(z.device)[None, None,
                                                                 :, :, None]
            ys, xs = slice(y0 * s, (y0 + th) * s), slice(x0 * s, (x0 + tw) * s)
            canvas[:, :, ys, xs] += out * w
            wsum[:, :, ys, xs] += w
    return _to_uint8(canvas / torch.clamp(wsum, min=1e-8))


# ----------------------------- converter ------------------------------------


def convert_cogvideox_vae(sd: Dict[str, np.ndarray],
                          dtype=None) -> Dict[str, Any]:
    """A diffusers ``AutoencoderKLCogVideoX`` state dict (``decoder.*``
    keys, numpy) -> the JAX decoder tree: conv weights (O, I, kt, kh, kw) ->
    (kt, kh, kw, I, O), the upsamplers' (O, I, kh, kw) -> (kh, kw, I, O)."""
    def get(k):
        v = np.asarray(sd[k])
        return v.astype(dtype) if dtype is not None else v

    def causal(prefix):
        return {"conv": {"kernel": np.ascontiguousarray(np.transpose(
            get(f"{prefix}.conv.weight"), (2, 3, 4, 1, 0))),
            "bias": get(f"{prefix}.conv.bias")}}

    def spatial_norm(prefix):
        return {"norm_layer": {"scale": get(f"{prefix}.norm_layer.weight"),
                               "bias": get(f"{prefix}.norm_layer.bias")},
                "conv_y": causal(f"{prefix}.conv_y"),
                "conv_b": causal(f"{prefix}.conv_b")}

    def resnet(prefix):
        p = {"norm1": spatial_norm(f"{prefix}.norm1"),
             "conv1": causal(f"{prefix}.conv1"),
             "norm2": spatial_norm(f"{prefix}.norm2"),
             "conv2": causal(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.conv.weight" in sd:
            p["conv_shortcut"] = causal(f"{prefix}.conv_shortcut")
        return p

    params: Dict[str, Any] = {"conv_in": causal("decoder.conv_in")}
    for i in range(2):
        params[f"mid_res_{i}"] = resnet(f"decoder.mid_block.resnets.{i}")
    bi = 0
    while f"decoder.up_blocks.{bi}.resnets.0.conv1.conv.weight" in sd:
        ri = 0
        while f"decoder.up_blocks.{bi}.resnets.{ri}.conv1.conv.weight" in sd:
            params[f"up_{bi}_res_{ri}"] = resnet(
                f"decoder.up_blocks.{bi}.resnets.{ri}")
            ri += 1
        up_key = f"decoder.up_blocks.{bi}.upsamplers.0.conv"
        if f"{up_key}.weight" in sd:
            params[f"up_{bi}_upsample"] = {"conv": {
                "kernel": np.ascontiguousarray(np.transpose(
                    get(f"{up_key}.weight"), (2, 3, 1, 0))),
                "bias": get(f"{up_key}.bias")}}
        bi += 1
    params["norm_out"] = spatial_norm("decoder.norm_out")
    params["conv_out"] = causal("decoder.conv_out")
    return params
