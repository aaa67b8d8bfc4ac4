"""CLIP dual-encoder scorer, the CoBSAT accuracy judge (counterpart of
thinkdiff_tpu/models/clip_scorer.py).

CoBSAT scores each generated image with a CLIP classifier: the image
embedding against text prompts for every candidate label of the latent
variable the model had to infer from the demonstration images, and of the
explicit attribute named in the final text input; a case is right when
both argmaxes hit (``scripts/score_cobsat.py``).

Both towers are the port's: the ViT (``ViTConfig.clip_vit_l``: 24 blocks
of 1024, 16 heads of 64, the flash forward #1 over its 257 tokens) with the
post-norm CLS token as the image feature (HF's ``pooler_output``), and the
CLIP-L text encoder (``models/clip_text.py``) with its pooled output at the
first EOS, the tokens padded with EOS. ``visual_projection`` and
``text_projection`` map both to the joint space, in the towers' dtype; the
embeddings are L2-normalized in f32, so ``classify`` returns cosine
similarities (CLIP's logit scale is monotonic and irrelevant to an argmax).
The scorer runs on its device (``device="cuda"`` by default; it raises
without a card, and runs the kernels' plain versions on ``device="cpu"``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from thinkdiff_torch import resolve_device
from thinkdiff_torch.models.bridge import load_params, to_tensor
from thinkdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from thinkdiff_torch.models.vit import ViTConfig, VisionTransformer

logger = logging.getLogger(__name__)

# HF CLIPImageProcessor constants (openai/clip-vit-large-patch14)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_clip_image(img, image_size: int = 224) -> np.ndarray:
    """PIL image -> (H, W, 3) float32: CLIP's bicubic resize of the short
    side, center crop and normalization."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, int(round(w * scale))),
                      max(image_size, int(round(h * scale)))),
                     Image.Resampling.BICUBIC)
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


class CLIPScorer:
    """``params``: the JAX-layout tree {"vision", "text",
    "visual_projection" (Dv, P), "text_projection" (Dt, P)}, loaded into
    the towers by the weight bridge; without it the towers keep their
    uninitialized weights for the caller to fill (``vision``, ``text``,
    ``visual_projection``, ``text_projection``)."""

    def __init__(self, vit_cfg: ViTConfig, text_cfg: CLIPTextConfig,
                 params: Optional[Dict[str, Any]] = None, tokenizer=None,
                 device="cuda", proj_dim: int = 768):
        self.device = dev = resolve_device(device)
        self.vit_cfg, self.text_cfg = vit_cfg, text_cfg
        self.tokenizer = tokenizer
        self.vision = VisionTransformer(vit_cfg, device=dev)
        self.text = CLIPTextEncoder(text_cfg, device=dev)
        if params is not None:
            load_params(self.vision, params["vision"])
            load_params(self.text, params["text"])
            proj_dim = np.asarray(params["visual_projection"]).shape[1]
        self.visual_projection = torch.empty(
            (vit_cfg.hidden_size, proj_dim), dtype=vit_cfg.dtype, device=dev)
        self.text_projection = torch.empty(
            (text_cfg.hidden_size, proj_dim), dtype=text_cfg.dtype, device=dev)
        if params is not None:
            self.visual_projection.copy_(to_tensor(params["visual_projection"]))
            self.text_projection.copy_(to_tensor(params["text_projection"]))

    @classmethod
    def from_pretrained(cls, path: str = "openai/clip-vit-large-patch14",
                        device="cuda", dtype=None) -> "CLIPScorer":
        """CLIP-L from a local HF checkpoint (a directory or the hub cache;
        nothing is downloaded): FileNotFoundError when it is not on disk.
        The tokenizer comes from the same local files, or is None. The
        towers run in ``dtype``: by default bf16 on the card (the flash
        kernel's type) and f32 on the CPU (the JAX scorer's)."""
        if dtype is None:
            dtype = (torch.bfloat16 if resolve_device(device).type == "cuda"
                     else torch.float32)
        from thinkdiff_torch.models.bridge import local_hf_dir, local_hf_state_dict
        from thinkdiff_torch.models.clip_text import convert_clip_text
        from thinkdiff_torch.models.convert import convert_clip_vit

        sd = local_hf_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"CLIP weights not found for {path}")
        params = {
            "vision": convert_clip_vit(sd, prefix="vision_model."),
            "text": convert_clip_text(sd, prefix="text_model."),
            "visual_projection": np.asarray(sd["visual_projection.weight"]).T,
            "text_projection": np.asarray(sd["text_projection.weight"]).T,
        }
        tok = None
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(local_hf_dir(path),
                                                local_files_only=True)
        except (ImportError, OSError, ValueError) as e:
            logger.warning("CLIP tokenizer unavailable: %s", e)
        return cls(ViTConfig.clip_vit_l(dtype=dtype),
                   CLIPTextConfig.clip_l(dtype=dtype), params, tokenizer=tok,
                   device=device)

    @staticmethod
    def _normalized(emb: torch.Tensor) -> np.ndarray:
        emb = emb.float()
        return (emb / emb.norm(dim=-1, keepdim=True)).cpu().numpy()

    @torch.no_grad()
    def encode_images(self, images: Sequence[Any]) -> np.ndarray:
        """PIL images (or preprocessed (H, W, 3) arrays) -> (B, P)
        L2-normalized f32 embeddings."""
        arrs = [img if isinstance(img, np.ndarray)
                else preprocess_clip_image(img, self.vit_cfg.image_size)
                for img in images]
        pixels = torch.from_numpy(np.stack(arrs)).to(self.device)
        pooled = self.vision(pixels)[:, 0]  # post-norm CLS (pooler_output)
        return self._normalized(pooled @ self.visual_projection.to(pooled.dtype))

    def token_batch(self, texts: Sequence[str]) -> torch.Tensor:
        """The texts' ids, each cut to ``max_positions`` and padded with
        EOS to the longest: (N, T) int64 on the device."""
        if self.tokenizer is None:
            raise RuntimeError("no CLIP tokenizer available")
        ids = [list(self.tokenizer.encode(t))[: self.text_cfg.max_positions]
               for t in texts]
        batch = np.full((len(ids), max(len(i) for i in ids)),
                        self.text_cfg.eos_token_id, np.int64)
        for r, i in enumerate(ids):
            batch[r, : len(i)] = i
        return torch.from_numpy(batch).to(self.device)

    @torch.no_grad()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """-> (N, P) L2-normalized f32 embeddings."""
        _, pooled = self.text(self.token_batch(texts))
        return self._normalized(pooled @ self.text_projection.to(pooled.dtype))

    def classify(self, images: Sequence[Any],
                 candidate_texts: Sequence[str]) -> np.ndarray:
        """(B, N) cosine similarities, image x candidate text."""
        return self.encode_images(images) @ self.encode_texts(
            candidate_texts).T
