"""Plain float32 reference of ThinkDiff-LVLM rendering with FLUX.1-dev:
CLIP-L's pooled embedding of the prompt, FLUX's flow-match Euler sampler
with dynamic shifting over the MMDiT transformer (AdaLayerNorm-Zero
modulation, joint attention of [text; image] with interleaved-pair RoPE
over the (id, y, x) axes and a per-head RMS q/k norm, single-stream
blocks with the parallel MLP, guidance and pooled-text embedders), and the
FLUX VAE decoder.

It reads the published layouts (diffusers' ``FluxTransformer2DModel``,
HF's ``CLIPTextModel``, the ``AutoencoderKL`` decoder) and imports nothing
of the program. Each block casts its weights to float32 when it runs;
attention runs a few heads at a time; every product goes through
``Products`` (float32 with TF32 off, or the fp8 control)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Products

HEADS_AT_ONCE = 6


def fp32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, eps=1e-6):
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


def rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def softmax_attention(pr: Products, q, k, v, scale, causal=False):
    """(B, H, T, D) q, k, v, a few heads at a time."""
    outs = []
    for h0 in range(0, q.shape[1], HEADS_AT_ONCE):
        sl = slice(h0, h0 + HEADS_AT_ONCE)
        s = pr.matmul(q[:, sl], k[:, sl].transpose(-1, -2)) * scale
        if causal:
            t = s.shape[-1]
            s = s.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                         device=s.device).triu(1),
                              float("-inf"))
        outs.append(pr.matmul(torch.softmax(s, -1), v[:, sl]))
    return torch.cat(outs, 1)


# -- schedule, ids, RoPE, timesteps -----------------------------------------

def sigmas(num_steps: int, image_seq_len: int) -> np.ndarray:
    """FlowMatchEulerDiscrete with FLUX's dynamic shifting (base 256 ->
    0.5, 4096 -> 1.15), float64, then float32 with a final 0."""
    s = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    m = (1.15 - 0.5) / (4096 - 256)
    mu = image_seq_len * m + (0.5 - m * 256)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def img_ids(lat_h: int, lat_w: int, device) -> torch.Tensor:
    ys = torch.arange(lat_h // 2, device=device, dtype=torch.float32)
    xs = torch.arange(lat_w // 2, device=device, dtype=torch.float32)
    ids = torch.zeros(lat_h // 2, lat_w // 2, 3, device=device)
    ids[..., 1] = ys[:, None]
    ids[..., 2] = xs[None, :]
    return ids.reshape(-1, 3)


def rope(ids, axes, theta):
    cos, sin = [], []
    for i, dim in enumerate(axes):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, device=ids.device,
                                             dtype=torch.float32) / dim)
        ang = ids[:, i:i + 1].float() * omega[None]
        cos.append(torch.cos(ang).repeat_interleave(2, -1))
        sin.append(torch.sin(ang).repeat_interleave(2, -1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x, cos, sin):
    """x (B, H, T, D): interleaved pairs (x0, x1) -> (x0 c - x1 s, x1 c +
    x0 s)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-x2, x1], -1).reshape(x.shape)
    return x * cos + rot * sin


def timestep_embedding(t, dim=256, max_period=10000.0):
    """diffusers Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


# -- the transformer ----------------------------------------------------------

class Transformer:
    def __init__(self, sd: Dict[str, torch.Tensor], tr: dict,
                 mlp_ratio: float, theta: float, pr: Products):
        self.sd, self.tr, self.pr, self.theta = sd, tr, pr, theta
        self.heads = tr["num_attention_heads"]
        self.hd = tr["attention_head_dim"]

    def lin(self, x, key):
        return self.pr.linear(x, self.sd[key + ".weight"],
                              self.sd.get(key + ".bias"))

    def embed(self, key, x):
        return self.lin(F.silu(self.lin(x, key + ".linear_1")),
                        key + ".linear_2")

    def heads_of(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.heads, self.hd).transpose(1, 2)

    def qkv(self, x, p, names, norms):
        q, k, v = (self.heads_of(self.lin(x, p + n)) for n in names)
        return (rms(q, self.sd[p + norms[0] + ".weight"]),
                rms(k, self.sd[p + norms[1] + ".weight"]), v)

    def attend(self, q, k, v, cos, sin):
        out = softmax_attention(self.pr, apply_rope(q, cos, sin),
                                apply_rope(k, cos, sin), v, self.hd ** -0.5)
        b, h, t, d = out.shape
        return out.transpose(1, 2).reshape(b, t, h * d)

    def double(self, i, img, txt, temb, cos, sin):
        p = f"transformer_blocks.{i}."
        mod = F.silu(temb)
        ish1, isc1, ig1, ish2, isc2, ig2 = \
            self.lin(mod, p + "norm1.linear")[:, None].chunk(6, -1)
        tsh1, tsc1, tg1, tsh2, tsc2, tg2 = \
            self.lin(mod, p + "norm1_context.linear")[:, None].chunk(6, -1)
        img_n = layer_norm(img) * (1 + isc1) + ish1
        txt_n = layer_norm(txt) * (1 + tsc1) + tsh1
        iq, ik, iv = self.qkv(img_n, p + "attn.", ("to_q", "to_k", "to_v"),
                              ("norm_q", "norm_k"))
        tq, tk, tv = self.qkv(txt_n, p + "attn.", ("add_q_proj", "add_k_proj",
                                                   "add_v_proj"),
                              ("norm_added_q", "norm_added_k"))
        st = txt.shape[1]
        out = self.attend(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                          torch.cat([tv, iv], 2), cos, sin)
        img = img + ig1 * self.lin(out[:, st:], p + "attn.to_out.0")
        txt = txt + tg1 * self.lin(out[:, :st], p + "attn.to_add_out")
        for x_name in ("img", "txt"):
            x = img if x_name == "img" else txt
            sh, sc, g = (ish2, isc2, ig2) if x_name == "img" else \
                (tsh2, tsc2, tg2)
            ff = p + ("ff" if x_name == "img" else "ff_context")
            y = layer_norm(x) * (1 + sc) + sh
            y = F.gelu(self.lin(y, ff + ".net.0.proj"), approximate="tanh")
            x = x + g * self.lin(y, ff + ".net.2")
            if x_name == "img":
                img = x
            else:
                txt = x
        return img, txt

    def single(self, i, x, temb, cos, sin):
        p = f"single_transformer_blocks.{i}."
        sh, sc, g = self.lin(F.silu(temb), p + "norm.linear")[:, None].chunk(
            3, -1)
        xn = layer_norm(x) * (1 + sc) + sh
        q, k, v = self.qkv(xn, p + "attn.", ("to_q", "to_k", "to_v"),
                           ("norm_q", "norm_k"))
        attn = self.attend(q, k, v, cos, sin)
        mlp = F.gelu(self.lin(xn, p + "proj_mlp"), approximate="tanh")
        return x + g * self.lin(torch.cat([attn, mlp], -1), p + "proj_out")

    @torch.no_grad()
    def __call__(self, img, txt, pooled, t, guidance, ids):
        tr = self.tr
        img = self.lin(img.float(), "x_embedder")
        txt = self.lin(txt.float(), "context_embedder")
        tte = "time_text_embed."
        temb = self.embed(tte + "timestep_embedder",
                          timestep_embedding(t * 1000.0))
        if tr["guidance_embeds"]:
            temb = temb + self.embed(tte + "guidance_embedder",
                                     timestep_embedding(guidance * 1000.0))
        temb = temb + self.embed(tte + "text_embedder", pooled.float())
        cos, sin = rope(ids, tr["axes_dims_rope"], self.theta)
        for i in range(tr["num_layers"]):
            img, txt = self.double(i, img, txt, temb, cos, sin)
        x = torch.cat([txt, img], 1)
        for i in range(tr["num_single_layers"]):
            x = self.single(i, x, temb, cos, sin)
        img = x[:, txt.shape[1]:]
        scale, shift = self.lin(F.silu(temb), "norm_out.linear")[:, None]\
            .chunk(2, -1)
        return self.lin(layer_norm(img) * (1 + scale) + shift, "proj_out")


def denoise(model: Transformer, latents, txt, pooled, lat_h, lat_w,
            num_steps: int, guidance: float):
    """The Euler trajectory in float32 from ``latents`` (B, S_img, C)."""
    dev = latents.device
    ids = torch.cat([torch.zeros(txt.shape[1], 3, device=dev),
                     img_ids(lat_h, lat_w, dev)], 0)
    sig = sigmas(num_steps, latents.shape[1])
    b = latents.shape[0]
    g = torch.full((b,), guidance, dtype=torch.float32, device=dev)
    x = latents.float()
    for i in range(num_steps):
        t = torch.full((b,), float(sig[i]), dtype=torch.float32, device=dev)
        v = model(x, txt, pooled, t, g, ids)
        x = x + float(sig[i + 1] - sig[i]) * v
    return x


def unpack(packed, lat_h, lat_w):
    """(B, h/2 * w/2, 4C) 2x2 patches -> (B, C, h, w)."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, lat_h // 2, lat_w // 2, c, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, lat_h, lat_w)


# -- CLIP-L's pooled embedding ------------------------------------------------

@torch.no_grad()
def clip_pooled(sd, te: dict, ids: torch.Tensor, pr: Products):
    p = "text_model."
    g = lambda k: sd[p + k].float()
    b, t = ids.shape
    heads = te["num_attention_heads"]
    hd = te["hidden_size"] // heads
    eps = te["layer_norm_eps"]
    ln = lambda x, n: F.layer_norm(x, x.shape[-1:], g(n + ".weight"),
                                   g(n + ".bias"), eps)
    lin = lambda x, n: pr.linear(x, sd[p + n + ".weight"],
                                 sd[p + n + ".bias"])
    x = g("embeddings.token_embedding.weight")[ids] + \
        g("embeddings.position_embedding.weight")[None, :t]
    for i in range(te["num_hidden_layers"]):
        a = f"encoder.layers.{i}."
        y = ln(x, a + "layer_norm1")
        q, k, v = (lin(y, a + f"self_attn.{n}").reshape(b, t, heads, hd)
                   .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj"))
        o = softmax_attention(pr, q, k, v, hd ** -0.5, causal=True)
        x = x + lin(o.transpose(1, 2).reshape(b, t, -1),
                    a + "self_attn.out_proj")
        y = lin(ln(x, a + "layer_norm2"), a + "mlp.fc1")
        x = x + lin(y * torch.sigmoid(1.702 * y), a + "mlp.fc2")
    x = ln(x, "final_layer_norm")
    eos = (ids == te["eos_token_id"]).int()
    idx = torch.where(eos.sum(1) > 0, eos.argmax(1),
                      torch.full_like(eos[:, 0], t - 1))
    return x[torch.arange(b, device=x.device), idx]


# -- the VAE decoder ----------------------------------------------------------

class VAEDecoder:
    def __init__(self, sd, vae: dict, pr: Products):
        self.sd, self.vae, self.pr = sd, vae, pr

    def conv(self, x, key):
        w = self.sd[key + ".weight"]
        return self.pr.conv(x, w, self.sd[key + ".bias"], w.shape[-1] // 2)

    def norm(self, x, key):
        return F.group_norm(x, self.vae["norm_num_groups"],
                            self.sd[key + ".weight"].float(),
                            self.sd[key + ".bias"].float(), 1e-6)

    def resnet(self, x, key):
        h = self.conv(F.silu(self.norm(x, key + ".norm1")), key + ".conv1")
        h = self.conv(F.silu(self.norm(h, key + ".norm2")), key + ".conv2")
        if key + ".conv_shortcut.weight" in self.sd:
            x = self.conv(x, key + ".conv_shortcut")
        return x + h

    def attn(self, x, key):
        b, c, hh, ww = x.shape
        y = self.norm(x, key + ".group_norm").flatten(2).transpose(1, 2)
        q, k, v = (self.pr.linear(y, self.sd[f"{key}.{n}.weight"],
                                  self.sd[f"{key}.{n}.bias"])
                   for n in ("to_q", "to_k", "to_v"))
        out = softmax_attention(self.pr, q[:, None], k[:, None], v[:, None],
                                c ** -0.5)[:, 0]
        out = self.pr.linear(out, self.sd[key + ".to_out.0.weight"],
                             self.sd[key + ".to_out.0.bias"])
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)

    @torch.no_grad()
    def __call__(self, z):
        """z (B, C, h, w) unscaled latents -> (B, 3, 8h, 8w) in about
        [-1, 1]."""
        p = "decoder."
        x = self.conv(z.float(), p + "conv_in")
        x = self.resnet(x, p + "mid_block.resnets.0")
        x = self.attn(x, p + "mid_block.attentions.0")
        x = self.resnet(x, p + "mid_block.resnets.1")
        chs = list(self.vae["block_out_channels"])
        for bi in range(len(chs)):
            for li in range(self.vae["layers_per_block"] + 1):
                x = self.resnet(x, f"{p}up_blocks.{bi}.resnets.{li}")
            if bi < len(chs) - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = self.conv(x, f"{p}up_blocks.{bi}.upsamplers.0.conv")
        return self.conv(F.silu(self.norm(x, p + "conv_norm_out")),
                         p + "conv_out")


def decode(vae: VAEDecoder, latents, lat_h, lat_w):
    """Packed final latents -> (B, H, W, 3) images in [0, 1]."""
    z = unpack(latents, lat_h, lat_w) / vae.vae["scaling_factor"] \
        + vae.vae["shift_factor"]
    img = vae(z).permute(0, 2, 3, 1)
    return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
