"""ThinkDiff inference pipeline: aligned tokens -> FLUX images (counterpart
of thinkdiff_tpu/engines/pipeline.py).

  - ``encode_prompt(prompt, prompt_embeds)``: external embeds pass through
    untouched; the CLIP-L pooled embedding comes from the (usually empty)
    text prompt;
  - LVLM path: model.get_embed -> aligned tokens -> ``generate``;
  - CLIP path: per-image projections concatenated, then optional T5 text
    embeds appended (``compose_clip_condition``: [img_1; img_2; text]).

``t5_embedder`` takes any callable text -> (B, S, 4096) embeds, as in JAX;
``T5TextEmbedder`` is the T5 encoder's, which ``from_pretrained`` builds
from FLUX's own ``text_encoder_2`` when the checkpoint and a local T5
tokenizer are on disk.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Sequence

import numpy as np
import torch

from thinkdiff_torch.core.trace import span
from thinkdiff_torch.engines.flux_sampler import FluxSampler
from thinkdiff_torch.models.clip_text import (
    CLIPTextConfig, CLIPTextEncoder, convert_clip_text)

logger = logging.getLogger(__name__)


class T5TextEmbedder:
    """T5 encoder text embeds (diffusers' ``_get_t5_prompt_embeds``), used
    to compose [image tokens; text embeds] conditions: each text tokenized
    (cut to ``max_len`` ids), right-padded with its mask, through the
    encoder. ``t5`` is a ``T5ForConditionalGeneration`` with an encoder,
    holding its weights."""

    def __init__(self, t5, tokenizer, max_sequence_length: int = 512):
        self.t5 = t5
        self.tokenizer = tokenizer
        self.max_sequence_length = max_sequence_length

    @classmethod
    def from_pretrained(cls, path: str = "google/flan-t5-xxl",
                        dtype=torch.bfloat16, max_sequence_length: int = 512,
                        device="cuda") -> "T5TextEmbedder":
        """flan-t5-xxl's encoder and tokenizer from local files; raises
        FileNotFoundError without the weights."""
        from transformers import AutoTokenizer

        from thinkdiff_torch.models.bridge import (
            local_hf_dir, local_hf_state_dict)

        sd = local_hf_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"T5 weights not found for {path}")
        tok = AutoTokenizer.from_pretrained(local_hf_dir(path),
                                            local_files_only=True)
        return cls(_t5_encoder(sd, dtype, device), tok, max_sequence_length)

    @torch.no_grad()
    def __call__(self, text, max_len: Optional[int] = None) -> torch.Tensor:
        """text (str or list) -> (B, S, d_model) f32 encoder states on the
        encoder's device."""
        texts = [text] if isinstance(text, str) else list(text)
        max_len = max_len or self.max_sequence_length
        ids = [self.tokenizer.encode(t)[:max_len] for t in texts]
        width = max(len(i) for i in ids)
        arr = np.zeros((len(ids), width), np.int32)
        mask = np.zeros((len(ids), width), np.int32)
        for i, row in enumerate(ids):
            arr[i, : len(row)] = row
            mask[i, : len(row)] = 1
        dev = self.t5.shared.embedding.device
        states, _ = self.t5.encode(torch.from_numpy(arr).to(dev),
                                   torch.from_numpy(mask).to(dev))
        return states.float()


def _t5_encoder(sd, dtype, device):
    """flan-t5-xxl's encoder (no decoder) from an HF state dict."""
    from thinkdiff_torch.models.aligner_base import load_hf_t5_
    from thinkdiff_torch.models.t5 import T5Config, T5ForConditionalGeneration

    t5 = T5ForConditionalGeneration(
        T5Config.flan_t5_xxl(dtype=dtype, dropout_rate=0.0), device=device,
        encoder=True, decoder=False)
    load_hf_t5_(t5, sd, None)
    return t5


class ThinkDiffPipeline:
    def __init__(self, sampler: FluxSampler, clip_encoder=None,
                 clip_tokenizer=None, t5_embedder=None,
                 max_sequence_length: int = 512):
        """``clip_encoder``: a ``CLIPTextEncoder`` holding its weights, on
        the sampler's device (JAX passes the module and its parameter tree
        apart)."""
        self.sampler = sampler
        self.clip_encoder = clip_encoder
        self.clip_tokenizer = clip_tokenizer
        self.t5_embedder = t5_embedder
        self.max_sequence_length = max_sequence_length
        self._pooled_cache = {}

    @classmethod
    def from_pretrained(cls, flux_path: str = "black-forest-labs/FLUX.1-dev",
                        dtype=torch.bfloat16,
                        device="cuda") -> "ThinkDiffPipeline":
        """The sampler of a local FLUX checkpoint, its CLIP-L text encoder
        (``text_encoder.*`` keys) and the CLIP tokenizer, and its T5 text
        embedder (``text_encoder_2.*`` keys, flan-t5's tokenizer) when they
        are on disk. Raises FileNotFoundError without the FLUX weights."""
        from thinkdiff_torch.models.bridge import (
            load_params, local_hf_state_dict)

        sampler = FluxSampler.from_pretrained(flux_path, dtype=dtype,
                                              device=device)
        sd = local_hf_state_dict(flux_path) or {}
        clip_encoder = clip_tok = None
        clip_sd = {k.replace("text_encoder.", "", 1): v for k, v in sd.items()
                   if k.startswith("text_encoder.")}
        if clip_sd:
            clip_encoder = load_params(CLIPTextEncoder(
                CLIPTextConfig.clip_l(dtype=dtype), device=sampler.device),
                convert_clip_text(clip_sd))
        try:
            from transformers import AutoTokenizer

            clip_tok = AutoTokenizer.from_pretrained(
                "openai/clip-vit-large-patch14", local_files_only=True)
        except (ImportError, OSError, ValueError) as e:
            logger.info("no local CLIP tokenizer (%s): the pooled "
                        "conditioning is zeros", e)
        # FLUX ships T5-xxl as text_encoder_2: the text embedder of
        # [image; text] compositions comes from it
        t5_embedder = None
        t5_sd = {k.split(".", 1)[1]: v for k, v in sd.items()
                 if k.startswith("text_encoder_2.")}
        if t5_sd:
            try:
                from transformers import AutoTokenizer

                t5_tok = AutoTokenizer.from_pretrained(
                    "google/flan-t5-xxl", local_files_only=True)
                t5_embedder = T5TextEmbedder(
                    _t5_encoder(t5_sd, dtype, sampler.device), t5_tok)
            except (ImportError, OSError, ValueError, KeyError) as e:
                logger.warning("FLUX text_encoder_2 present but T5 embedder "
                               "unavailable: %s", e)
        return cls(sampler, clip_encoder, clip_tok, t5_embedder=t5_embedder)

    # -- encode_prompt --------------------------------------------------------
    def pooled_from_prompt(self, prompt: str, batch: int = 1) -> torch.Tensor:
        """(batch, pooled_dim) f32 CLIP-L pooled embeds of the text prompt,
        on the sampler's device, computed once per (prompt, batch); zeros
        when no CLIP encoder or tokenizer is available."""
        if self.clip_encoder is None or self.clip_tokenizer is None:
            return torch.zeros((batch, self.sampler.cfg.pooled_projection_dim),
                               dtype=torch.float32, device=self.sampler.device)
        key = (prompt, batch)
        if key not in self._pooled_cache:
            ids = self.clip_tokenizer(
                [prompt] * batch, padding="max_length", max_length=77,
                truncation=True, return_tensors="np")["input_ids"]
            with torch.no_grad():
                _, pooled = self.clip_encoder(torch.as_tensor(
                    np.asarray(ids), device=self.sampler.device))
            self._pooled_cache[key] = pooled.float()
        return self._pooled_cache[key]

    def encode_prompt(self, prompt: str = "", prompt_embeds=None,
                      batch: int = 1):
        """Pass external embeds through (a 2-D one gains a batch axis); the
        pooled embeds come from the text prompt."""
        if prompt_embeds is None:
            raise ValueError("ThinkDiff always supplies prompt embeds")
        prompt_embeds = torch.as_tensor(prompt_embeds,
                                        device=self.sampler.device)
        if prompt_embeds.ndim == 2:
            prompt_embeds = prompt_embeds[None]
        pooled = self.pooled_from_prompt(prompt, batch=prompt_embeds.shape[0])
        return prompt_embeds, pooled

    # -- generation ----------------------------------------------------------
    def generate(self, prompt_embeds, prompt: str = "", height: int = 1024,
                 width: int = 1024, num_steps: int = 28,
                 guidance: float = 3.5, seed: int = 0):
        """Images (B, H, W, 3) in [0, 1] conditioned on ``prompt_embeds``,
        from the sampler's initial noise for ``seed``: one ``flux.request``
        span, the root of the request's step and decode spans."""
        with span("flux.request"):
            embeds, pooled = self.encode_prompt(prompt, prompt_embeds)
            return self.sampler.sample(
                embeds, pooled, height=height, width=width,
                num_steps=num_steps, guidance=guidance, seed=seed)

    def compose_clip_condition(self, image_projections: Sequence[Any],
                               text_embeds=None,
                               max_len: Optional[int] = None) -> torch.Tensor:
        """ThinkDiff-CLIP multi-image composition: the per-image projected
        tokens, then the text embeds, along the token axis."""
        parts = [torch.as_tensor(p) for p in image_projections]
        if text_embeds is not None:
            parts.append(torch.as_tensor(text_embeds))
        cond = torch.cat(parts, dim=-2)
        if max_len is not None:
            cond = cond[..., :max_len, :]
        return cond
