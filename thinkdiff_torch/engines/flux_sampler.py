"""FLUX sampling: flow-match Euler denoising with external prompt embeds
(counterpart of thinkdiff_tpu/engines/flux_sampler.py).

ThinkDiff overrides diffusers' FluxPipeline so that externally supplied
``prompt_embeds`` (aligned VLM/CLIP tokens) bypass T5 encoding while the
pooled CLIP embedding still comes from the text prompt. Here that contract
is the API: ``sample(prompt_embeds, pooled, ...)``.

Scheduler: FlowMatchEulerDiscrete with FLUX's dynamic shifting,
  sigmas = linspace(1, 1/N); mu = base + (seq - 256)(max - base)/(4096 - 256)
  sigma' = exp(mu) / (exp(mu) + (1/sigma - 1))
  x_{i+1} = x_i + (sigma_{i+1} - sigma_i) v_theta(x_i)
The trajectory is carried in f32 whatever the model's dtype; the model gets
x cast to its dtype and its velocity is cast back to f32 for the update.
JAX runs the loop as one jitted ``lax.scan``; here it is a Python loop over
the steps (``denoise``). Spans (``core/trace.py``): ``flux.step`` around
each Euler step (attr ``step``), ``flux.decode`` around the VAE.

The sampler is built on its device (``device="cuda"`` by default; it raises
without a card, and runs the kernels' plain versions on the CPU only when
asked with ``device="cpu"``).

``mesh`` (JAX's argument; one process a device over ``torch.distributed``,
parallel/mesh.py): the transformer and the VAE hold this rank's blocks of
JAX's placements, cut from whole modules (``shard_params``) or built block
by block (``build_sharded``), and the batch splits over the (data, fsdp)
readers (``collectives.reader_rows``); the fixed step count keeps the
peers in lockstep, and the latents and images come back whole on every
rank. JAX's rules leave FLUX's projections (``img_q``, ``txt_k``, ``q``,
``mlp``, the modulations) at ``(fsdp, None)``: over ``model`` only the
single blocks' ``proj_out`` and the final ``proj_out`` split (their
rows), so the axis that cuts FLUX's memory is ``fsdp``, as in JAX. At
``fsdp`` alone every product runs on the gathered whole weight: a rank's
rows are bit for bit the unsharded sampler's on those rows.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from thinkdiff_torch import resolve_device
from thinkdiff_torch.core.trace import span
from thinkdiff_torch.models.bridge import load_params
from thinkdiff_torch.models.flux import (
    FluxConfig, FluxTransformer, make_img_ids, unpack_latents)
from thinkdiff_torch.models.flux_vae import VAEConfig, VAEDecoder
from thinkdiff_torch.parallel import collectives as col
from thinkdiff_torch.parallel.sharding import place_on_mesh


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def flux_sigmas(num_steps: int, image_seq_len: int,
                dynamic_shifting: bool = True, shift: float = 3.0) -> np.ndarray:
    """(num_steps + 1,) f32 sigma schedule ending at 0, computed in float64."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if dynamic_shifting:
        mu = calculate_shift(image_seq_len)
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


class FluxSampler:
    def __init__(self, cfg: FluxConfig, transformer: FluxTransformer,
                 vae_cfg: Optional[VAEConfig] = None,
                 vae: Optional[VAEDecoder] = None, device="cuda",
                 mesh=None):
        """``transformer`` / ``vae``: the modules holding their weights, on
        ``device`` (JAX passes the parameter trees; ``bridge.load_params``
        loads such a tree into a module). ``mesh``: the module docstring."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vae_cfg = vae_cfg
        self.mesh = mesh
        if mesh is not None:
            transformer = place_on_mesh(transformer, mesh)
            vae = place_on_mesh(vae, mesh)
        self.transformer = transformer
        self.vae = vae

    @classmethod
    def from_pretrained(cls, flux_path: str = "black-forest-labs/FLUX.1-dev",
                        dtype=torch.bfloat16, device="cuda") -> "FluxSampler":
        """The transformer (``transformer.*`` keys, or the whole state dict)
        and, when present, the VAE decoder (``vae.*`` / ``decoder.*``) of a
        local checkpoint. Raises FileNotFoundError when it is not on
        disk; never downloads."""
        from thinkdiff_torch.models.bridge import local_hf_state_dict
        from thinkdiff_torch.models.flux import convert_flux
        from thinkdiff_torch.models.flux_vae import convert_vae_decoder

        device = resolve_device(device)
        sd = local_hf_state_dict(flux_path)
        if sd is None:
            raise FileNotFoundError(f"FLUX weights not found for {flux_path}")
        cfg = FluxConfig.flux_dev(dtype=dtype)
        transformer = load_params(FluxTransformer(cfg, device=device),
                                  convert_flux({
                                      k.replace("transformer.", "", 1): v
                                      for k, v in sd.items()
                                      if k.startswith("transformer.")} or sd))
        vae_cfg, vae = None, None
        if any(k.startswith("decoder.") or k.startswith("vae.") for k in sd):
            vae_sd = {k.replace("vae.", "", 1): v for k, v in sd.items()
                      if k.startswith("vae.")} or sd
            vae_cfg = VAEConfig.flux(dtype=dtype)
            vae = load_params(VAEDecoder(vae_cfg, device=device),
                              convert_vae_decoder(vae_sd))
        return cls(cfg, transformer, vae_cfg, vae, device=device)

    # -- the loops ----------------------------------------------------------
    @torch.no_grad()
    def denoise(self, latents, txt, pooled, img_ids, txt_ids,
                sigmas: Sequence[float], guidance: float) -> torch.Tensor:
        """len(sigmas) - 1 Euler steps from ``latents`` (B, S_img, C), f32
        on the sampler's device: the counterpart of JAX's jitted
        ``denoise(params, latents, txt, pooled, img_ids, txt_ids, sigmas)``.
        Returns the final latents (f32); on a mesh each reader runs its
        rows and every rank gets the whole batch."""
        dev, dtype = self.device, self.cfg.dtype
        x = col.reader_rows(torch.as_tensor(latents, device=dev).float())
        txt = col.reader_rows(torch.as_tensor(txt, device=dev))
        pooled = col.reader_rows(torch.as_tensor(pooled, device=dev))
        img_ids = torch.as_tensor(img_ids, device=dev)
        txt_ids = torch.as_tensor(txt_ids, device=dev)
        sig = np.asarray(sigmas, np.float32)
        b = x.shape[0]
        g = torch.full((b,), guidance, dtype=torch.float32, device=dev)
        for i in range(len(sig) - 1):
            with span("flux.step", step=i):
                t = torch.full((b,), float(sig[i]), dtype=torch.float32,
                               device=dev)
                v = self.transformer(x.to(dtype), txt, pooled, t, img_ids,
                                     txt_ids, g)
                # sigma_{i+1} - sigma_i in f32, as JAX takes it
                x = x + float(sig[i + 1] - sig[i]) * v.float()
        return col.gather_reader_rows(x)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) spatial latents -> (B, 8h, 8w, 3) images in [0, 1],
        in the VAE's dtype (on a mesh: each reader's rows, gathered)."""
        with span("flux.decode"):
            z = col.reader_rows(latents) / self.vae_cfg.scaling_factor \
                + self.vae_cfg.shift_factor
            img = self.vae(z)
            return col.gather_reader_rows(
                torch.clamp(img * 0.5 + 0.5, 0.0, 1.0))

    # -- public API ---------------------------------------------------------
    def noise(self, batch: int, seq_len: int, seed: int) -> torch.Tensor:
        """The initial latents (batch, seq_len, C), f32: a normal draw of a
        ``torch.Generator`` seeded with ``seed`` on the sampler's device. It
        cannot equal JAX's ``jax.random.normal(PRNGKey(seed))`` draw, so the
        same seed gives another image than the JAX sampler; parity with JAX
        is held on explicit latents (``denoise``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((batch, seq_len, self.cfg.in_channels),
                           generator=gen, dtype=torch.float32,
                           device=self.device)

    def sample(self, prompt_embeds, pooled_embeds, height: int = 1024,
               width: int = 1024, num_steps: int = 28, guidance: float = 3.5,
               seed: int = 0, output_latents: bool = False):
        """prompt_embeds (B, S_txt, joint_dim), the aligned tokens straight
        from the projector; pooled_embeds (B, pooled_dim). Returns images
        (B, H, W, 3) in [0, 1], or the packed f32 latents
        (``output_latents``, or no VAE). The initial noise is ``noise``'s
        draw for ``seed``."""
        b = prompt_embeds.shape[0]
        lat_h, lat_w = height // 8, width // 8
        seq_len = (lat_h // 2) * (lat_w // 2)
        latents = self.noise(b, seq_len, seed)
        img_ids = torch.from_numpy(make_img_ids(lat_h, lat_w))
        txt_ids = torch.zeros((prompt_embeds.shape[1], 3), dtype=torch.float32)
        latents = self.denoise(latents, prompt_embeds, pooled_embeds, img_ids,
                               txt_ids, flux_sigmas(num_steps, seq_len),
                               guidance)
        if output_latents or self.vae is None:
            return latents
        return self.decode(unpack_latents(latents, lat_h, lat_w))


def save_images(images, paths) -> None:
    """(B, H, W, 3) floats in [0, 1] -> PNG files: ``(img * 255)`` in the
    images' dtype, truncated to uint8, as JAX's ``save_images`` does, so
    the same images give the same bytes."""
    from PIL import Image

    arr = (torch.as_tensor(images).detach().cpu() * 255).to(torch.uint8)
    for img, path in zip(arr.numpy(), paths):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        Image.fromarray(img).save(path)
