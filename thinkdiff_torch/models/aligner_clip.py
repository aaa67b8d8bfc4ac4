"""ThinkDiff-CLIP aligner: frozen BLIP-2 ViT-g -> trainable MLP projector ->
frozen flan-t5, trained with caption-split cross-entropy (counterpart of
``BlipVisionT5Decoder`` in thinkdiff_tpu/models/aligner_clip.py).

An image's ViT tokens (optionally pooled x2 on the patch grid,
``vision_downsample``: 257 -> 65) are projected into T5's space and placed
before the T5 encoder's states of the caption's first half; the decoder
learns to produce the second half. Only the projector trains: the ViT runs
under ``torch.no_grad()`` (no gradient reaches it, and its flash forward
at head dim 88 has no backward), and the T5 encoder's input does not
depend on the projector, so the gradient reaches the projector through the
decoder's cross-attention alone.

The model is built on its device (``device="cuda"`` by default; the CPU
only when asked). ``frozen`` holds two modules with the JAX-layout weights,
``frozen["vision"]`` (``VisionTransformer``) and ``frozen["t5"]`` (encoder
and decoder); ``trainable["projector"]`` is a tree of f32 tensors. Weights
come from local HF checkpoints when ``load_pretrained`` (the default) finds
them (``convert_clip_vit`` on the BLIP-2 checkpoint's ``vision_model.*``,
``convert_t5`` on flan-t5's), else from a seed. ``quantize_frozen``
(``int8`` weight-only, ``int8_dyn`` w8a8) quantizes the T5 through
``QDense``. Batches hold tensors: ``pixel_values`` (B, H, W, 3) NHWC,
``input_ids``/``input_mask`` of the first caption half and ``labels`` of
the second (-100 past its end).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from thinkdiff_torch import registry
from thinkdiff_torch.models.aligner_base import AlignerBase
from thinkdiff_torch.models.bridge import (
    load_params, local_hf_state_dict, to_tensor)
from thinkdiff_torch.models.convert import convert_clip_vit
from thinkdiff_torch.models.t5 import ce_stats, cross_entropy_loss, shift_right
from thinkdiff_torch.models.vit import (
    ViTConfig, VisionTransformer, init_vit_, vision_downsample)

logger = logging.getLogger(__name__)


@registry.register_model("blip-vision-t5-decoder")
class BlipVisionT5Decoder(AlignerBase):
    default_model_type = "pretrain_flant5xxl"
    PRETRAINED_MODEL_CONFIG_DICT = {
        "pretrain_blip_vision_t5_decoder":
            "configs/models/blip_vision_t5_decoder.yaml",
    }
    DEFAULT_CONFIG = {
        "mm_projector_type": "mlp2x_gelu_t5_norm",
        "dtype": "bfloat16",
        "max_txt_len": 128,
        "vision_downsample_factor": None,
        "layer_norm_reinit_weight_with_language_encoder": False,
    }

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(cfg, seed, device)
        self.vit_cfg = ViTConfig(**{**dict(dtype=self.dtype),
                                    **dict(self.cfg.get("vision_config", {}))})
        self.downsample_factor = self.cfg.get("vision_downsample_factor", None)
        self._build_params(seed)

    def _build_params(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        vision = VisionTransformer(self.vit_cfg, device=self.device)
        path = self.cfg.get("blip_pretrained_model_name_or_path",
                            "Salesforce/blip2-flan-t5-xxl")
        sd = (local_hf_state_dict(path) if self.cfg.get("load_pretrained", True)
              else None)
        if sd is not None and any(k.startswith("vision_model.") for k in sd):
            load_params(vision, convert_clip_vit(sd, "vision_model."))
            logger.info("Loaded BLIP-2 vision weights from %s", path)
        else:
            init_vit_(vision, gen)
        t5, encoder_norm = self._frozen_t5(gen, encoder=True)
        self.frozen = {"vision": vision, "t5": t5}
        params = self.projector.init_params(self.vit_cfg.hidden_size, gen,
                                            self.device)
        if encoder_norm is None:  # random weights: the module's own
            encoder_norm = t5.encoder.final_norm.weight.detach()
        self._reinit_t5_norm(params, encoder_norm)
        self.trainable = {"projector": params}

    # -- compute ------------------------------------------------------------
    @torch.no_grad()
    def encode_image(self, frozen, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 3) -> the ViT's tokens (B, N, hidden),
        pooled when ``vision_downsample_factor`` is set; no gradient."""
        tokens = frozen["vision"](pixel_values)
        if self.downsample_factor:
            tokens = vision_downsample(tokens, int(self.downsample_factor))
        return tokens

    def project(self, trainable, tokens: torch.Tensor) -> torch.Tensor:
        return self.projector(trainable["projector"], tokens)

    def _logits(self, trainable, frozen, batch):
        proj = self.project(trainable,
                            self.encode_image(frozen, batch["pixel_values"]))
        labels = batch["labels"]
        logits = frozen["t5"](
            input_ids=batch["input_ids"],
            attention_mask=batch.get("input_mask"),
            decoder_input_ids=shift_right(labels),
            extra_encoder_states=proj)
        return logits, labels

    def loss_fn(self, trainable, frozen, batch, rng=None) -> torch.Tensor:
        """Vision (no gradient) -> optional pool -> projector -> T5 with the
        projected tokens before the first half's encoder states -> token-mean
        CE over the second half. ``rng`` is unused: the step has no
        dropout."""
        return cross_entropy_loss(*self._logits(trainable, frozen, batch))

    @torch.no_grad()
    def eval_metrics_fn(self, trainable, frozen, batch):
        """(loss, n_correct, n_tokens), correctness being teacher-forced
        next-token accuracy."""
        return ce_stats(*self._logits(trainable, frozen, batch))

    @torch.no_grad()
    def forward_encoder(self, pixel_values) -> torch.Tensor:
        """The inference path: image(s) (B, H, W, 3) -> aligned T5-space
        tokens (B, N, d_model) on the model's device."""
        tokens = self.encode_image(self.frozen,
                                   to_tensor(pixel_values).to(self.device))
        return self.project(self.trainable, tokens)


def clip_train_launches(model: BlipVisionT5Decoder, dec_len: int
                        ) -> Dict[str, int]:
    """Kernel launches of one training step of ``model`` (a bf16 or
    weight-only T5, no CE chunking) for decoder rows of ``dec_len`` tokens:
    the ViT's flash forward a block (no gradient, no backward), the T5
    encoder's (one flash forward and two RMSNorms a block, and its final
    norm; no gradient), then the decoder's forward and backward as the
    LVLM step counts them (``step_launches``: block 0's self-attention sees
    no gradient, every cross-attention does)."""
    from thinkdiff_torch.models.aligner_lvlm import step_launches

    cfg = model.t5_cfg
    if cfg.quant_int8 == "w8a8":
        raise ValueError("clip_train_launches counts a bf16 or weight-only T5")
    out = step_launches(cfg, dec_len, 0)
    vit = 0 if (model.vit_cfg.use_rel_pos_bias
                or model.vit_cfg.use_shared_rel_pos_bias) \
        else model.vit_cfg.num_layers
    out["flash_attention_fwd"] += vit + cfg.num_layers
    out["rmsnorm"] += 2 * cfg.num_layers + 1
    return out


def clip_flux_launches(model: BlipVisionT5Decoder, flux_cfg, steps: int,
                       clip_layers: int, images: int = 1) -> Dict[str, int]:
    """Flash forward and RMSNorm launches of ThinkDiff-CLIP inference into
    FLUX: ``images`` ViT forwards (a flash forward a block) each followed by
    the projector (its trailing t5_norm one RMSNorm), then the FLUX part
    (``flux_launches``: CLIP-L's ``clip_layers`` causal layers, 0 when its
    pooled embedding is cached, and ``steps`` Euler steps)."""
    from thinkdiff_torch.models.aligner_lvlm import flux_launches

    out = flux_launches(flux_cfg, steps, clip_layers)
    out["flash_attention_fwd"] += images * model.vit_cfg.num_layers
    out["rmsnorm"] += images * int(getattr(model.projector, "use_t5_norm",
                                           False))
    return out


def cogvideo_launches(model: BlipVisionT5Decoder, text_cfg, video_cfg,
                      steps: int) -> Dict[str, int]:
    """Flash forward and RMSNorm launches of ThinkDiff-CLIP inference into
    CogVideoX: one ViT forward (a flash forward a block) and the projector
    (its trailing t5_norm one RMSNorm), the text embedder's T5 encoder
    ``text_cfg`` (a flash forward and two RMSNorms a block, and its final
    norm), then ``steps`` DDIM steps of two transformer forwards (cond and
    uncond), each a flash forward a block; CogVideoX's q/k norms are
    LayerNorms, plain PyTorch."""
    vit = model.vit_cfg.num_layers
    return {"flash_attention_fwd": (vit + text_cfg.num_layers
                                    + 2 * video_cfg.num_layers * steps),
            "rmsnorm": (int(getattr(model.projector, "use_t5_norm", False))
                        + 2 * text_cfg.num_layers + 1)}
