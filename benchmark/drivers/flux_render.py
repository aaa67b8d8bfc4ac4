"""ThinkDiff-LVLM rendering with FLUX.1-dev, as the LVLM inference CLI
runs it: ``ThinkDiffPipeline.generate`` on aligned tokens, one request at
a time, each run whole and back to back (its images synchronized, as a
caller that saves them waits for them).

Set-up makes the transformer (diffusers' layout), CLIP-L (HF's) and the
VAE decoder from the seed on the card and loads them through the port's
converters and loader into a ``FluxSampler`` and a ``ThinkDiffPipeline``
with the configuration's run section (steps, guidance, prompt). It warms
the cell's shapes with one one-step request, which also computes the
prompt's CLIP-L pooled embedding the pipeline keeps.

Request ``i`` draws its tokens from (seed, i) on the card before it
starts. ``check`` renders request ``k`` again, one of the first
``CHECKED_OF`` requests drawn from the seed (every window completes more),
with the plain float32 reference (``reference/flux.py``) and compares its
final latents (the worst row's relative L2 gap) and its images (the mean
absolute gap, in [0, 1] units); only that request's outputs are kept."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.traffic import clip_prompt
from benchmark.weights import flux_dev
from benchmark.work import flux as work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the checked request is one of the first CHECKED_OF
CHECKED_OF = 4


def weight_seeds(seed: int):
    """(transformer, CLIP-L, VAE) seeds of a run seed."""
    s = np.random.SeedSequence(int(seed)).generate_state(6)
    return tuple(int(s[i]) << 32 | int(s[i + 1]) for i in (0, 2, 4))


def make_weights(config, seed, device):
    tr, te, vae = (config[k] for k in ("transformer", "text_encoder", "vae"))
    dtype = DTYPES[config["dtype"]]
    s_tr, s_te, s_vae = weight_seeds(seed)
    return (weights.make(flux_dev.transformer_spec(tr, config["mlp_ratio"]),
                         s_tr, device, dtype),
            weights.make(flux_dev.clip_spec(te), s_te, device, dtype),
            weights.make(flux_dev.vae_decoder_spec(vae), s_vae, device, dtype))


class Driver:
    path = "flux_step"
    trace = False

    def __init__(self, cell, config, traffic, seed, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = int(seed), device
        self.params = traffic["params"]
        self.gen = harness.traffic_module(traffic)
        self.shape = self.gen.shapes(self.params)
        run = config["run"]
        self.steps, self.guidance = int(run["num_inference_steps"]), \
            float(run["guidance_scale"])
        self.prompt = run["prompt"]
        self.spans = harness.Spans()
        self.k = int(np.random.default_rng(self.seed).integers(CHECKED_OF))
        self.done, self.kept = 0, None

    def setup(self):
        from thinkdiff_torch.engines.flux_sampler import FluxSampler
        from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline
        from thinkdiff_torch.models.bridge import load_params
        from thinkdiff_torch.models.clip_text import (
            CLIPTextConfig, CLIPTextEncoder, convert_clip_text)
        from thinkdiff_torch.models.flux import (
            FluxConfig, FluxTransformer, convert_flux)
        from thinkdiff_torch.models.flux_vae import (
            VAEConfig, VAEDecoder, convert_vae_decoder)

        c, dev = self.config, self.device
        self.phases = ph = harness.Phases(dev)
        tr, te, vc = c["transformer"], c["text_encoder"], c["vae"]
        dtype = DTYPES[c["dtype"]]
        fcfg = FluxConfig(
            in_channels=tr["in_channels"],
            hidden_size=tr["num_attention_heads"] * tr["attention_head_dim"],
            num_heads=tr["num_attention_heads"],
            num_double_layers=tr["num_layers"],
            num_single_layers=tr["num_single_layers"],
            mlp_ratio=c["mlp_ratio"],
            joint_attention_dim=tr["joint_attention_dim"],
            pooled_projection_dim=tr["pooled_projection_dim"],
            axes_dims_rope=tuple(tr["axes_dims_rope"]),
            rope_theta=c["rope_theta"], guidance_embeds=tr["guidance_embeds"],
            dtype=dtype)
        ccfg = CLIPTextConfig(
            vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
            intermediate_size=te["intermediate_size"],
            num_layers=te["num_hidden_layers"],
            num_heads=te["num_attention_heads"],
            max_positions=te["max_position_embeddings"],
            layer_norm_eps=te["layer_norm_eps"],
            eos_token_id=te["eos_token_id"], dtype=dtype)
        vcfg = VAEConfig(
            latent_channels=vc["latent_channels"],
            block_out_channels=tuple(vc["block_out_channels"]),
            layers_per_block=vc["layers_per_block"],
            norm_num_groups=vc["norm_num_groups"],
            scaling_factor=vc["scaling_factor"],
            shift_factor=vc["shift_factor"], dtype=dtype)
        sd_tr, sd_te, sd_vae = make_weights(c, self.seed, dev)
        transformer = load_params(FluxTransformer(fcfg, device=dev),
                                  convert_flux(sd_tr))
        del sd_tr
        clip = load_params(CLIPTextEncoder(ccfg, device=dev),
                           convert_clip_text(sd_te))
        # the VAE converter transposes numpy conv kernels
        vae = load_params(VAEDecoder(vcfg, device=dev), convert_vae_decoder(
            {k: v.float().cpu().numpy() for k, v in sd_vae.items()}))
        del sd_te, sd_vae
        ph.done("weights")
        self.pipe = ThinkDiffPipeline(
            FluxSampler(fcfg, transformer, vcfg, vae, device=dev), clip,
            clip_prompt.PromptIds(te))
        sampler = self.pipe.sampler
        denoise, decode = sampler.denoise, sampler.decode
        self.latents = None

        def keep_latents(*a, **kw):
            self.latents = denoise(*a, **kw)
            return self.latents

        def timed_decode(*a, **kw):
            # a synchronized span in traced runs (vae_ms.flux)
            if not self.trace:
                return decode(*a, **kw)
            harness.synchronize(dev)
            with self.spans.span("decode"):
                out = decode(*a, **kw)
                harness.synchronize(dev)
            return out

        sampler.denoise, sampler.decode = keep_latents, timed_decode
        s = self.shape
        img = (s["height"] // 16) * (s["width"] // 16)
        self.request_work = {
            "images": s["batch"], "steps": self.steps,
            "ops": self.steps * work.step_ops(
                tr | {"mlp_ratio": c["mlp_ratio"]}, s["batch"], img,
                s["tokens"]),
            "calls": [(call, self.steps) for call in work.step_calls(
                tr, s["batch"], img, s["tokens"])]}
        # warm: one one-step request at the cell's shapes
        self.pipe.generate(self.tokens(0), prompt=self.prompt,
                           height=s["height"], width=s["width"], num_steps=1,
                           guidance=self.guidance,
                           seed=self.gen.request_seed(self.seed, 0))
        ph.done("warm request")

    def tokens(self, i: int) -> torch.Tensor:
        return self.gen.tokens(self.params, self.config, self.seed, i,
                               self.device, DTYPES[self.config["dtype"]])

    # -- the window -----------------------------------------------------------
    def unit(self, i, spans):
        s = self.shape
        self.spans = spans
        tokens = self.tokens(i)
        with spans.span("request"):
            images = self.pipe.generate(
                tokens, prompt=self.prompt, height=s["height"],
                width=s["width"], num_steps=self.steps,
                guidance=self.guidance,
                seed=self.gen.request_seed(self.seed, i))
            harness.synchronize(self.device)
        if i == self.k:
            self.kept = (images, self.latents)
        self.done = i + 1
        return self.request_work

    def window_metrics(self, units, seconds):
        return {"image_s": seconds / sum(u["images"] for u in units),
                "denoise_step_ms": 1e3 * seconds / sum(u["steps"]
                                                       for u in units)}

    def after_window(self):
        """Requests past the window's end, untimed, until the checked one
        is done (only a window shorter than any the cells run needs it)."""
        while self.done <= self.k:
            self.unit(self.done, harness.Spans())

    # -- correctness ----------------------------------------------------------
    def release(self):
        del self.pipe

    def check(self) -> dict:
        from benchmark.reference.precision import Products

        images, latents = self.kept
        ref_lat, ref_img = render(self.config, self.traffic, self.seed,
                                  self.k, self.device, Products("fp32"))
        lim = self.cell["limits"]
        return {"latent_rel": (latent_gap(latents, ref_lat),
                               lim["latent_rel"]),
                "image_abs": (float((images.float() - ref_img).abs().mean()),
                              lim["image_abs"])}


def latent_gap(ours, ref) -> float:
    """The worst row's relative L2 gap of the final latents."""
    d = (ours.float() - ref).flatten(1).norm(dim=1)
    return float((d / ref.flatten(1).norm(dim=1)).max())


def render(config, traffic, seed, i, device, pr):
    """Request ``i`` of a run through the plain reference: (final packed
    latents, images)."""
    from benchmark.reference import flux as ref

    ref.fp32_matmuls()
    gen, params = harness.traffic_module(traffic), traffic["params"]
    s = gen.shapes(params)
    tr, te = config["transformer"], config["text_encoder"]
    sd_tr, sd_te, sd_vae = make_weights(config, seed, device)
    ids = torch.as_tensor(clip_prompt.PromptIds(te)(
        [config["run"]["prompt"]] * s["batch"])["input_ids"], device=device)
    pooled = ref.clip_pooled(sd_te, te, ids, pr)
    model = ref.Transformer(sd_tr, tr, config["mlp_ratio"],
                            config["rope_theta"], pr)
    lat_h, lat_w = s["height"] // 8, s["width"] // 8
    tokens = gen.tokens(params, config, seed, i, device,
                        DTYPES[config["dtype"]])
    noise = gen.noise(params, config, seed, i, device)
    run = config["run"]
    lat = ref.denoise(model, noise, tokens.float(), pooled, lat_h, lat_w,
                      int(run["num_inference_steps"]),
                      float(run["guidance_scale"]))
    img = ref.decode(ref.VAEDecoder(sd_vae, config["vae"], pr), lat, lat_h,
                     lat_w)
    return lat, img
