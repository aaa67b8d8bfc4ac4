"""What the two aligners share (ThinkDiff-LVLM's ``MllamaT5EmbedDecoder``
in models/aligner_lvlm.py, ThinkDiff-CLIP's ``BlipVisionT5Decoder`` in
models/aligner_clip.py, counterparts of the JAX package's ``BaseModel``
plumbing): the config and device, the frozen flan-t5 from a local HF
checkpoint (``convert_t5``) or seeded random weights, the trainable
projector tree and its checkpoints, and the T5 tokenizer from local files.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from thinkdiff_torch import resolve_device
from thinkdiff_torch.core.config import model_default_config_path
from thinkdiff_torch.core.optim import tree_map
from thinkdiff_torch.models.bridge import (
    load_params, local_hf_dir, local_hf_state_dict, to_numpy, to_tensor,
    unflatten)
from thinkdiff_torch.models.convert import convert_t5
from thinkdiff_torch.models.projector import (
    build_vision_projector, convert_projector_torch, export_projector_torch)
from thinkdiff_torch.models.qdense import QDense
from thinkdiff_torch.models.t5 import (
    T5Config, T5ForConditionalGeneration, fuse_t5_params)
from thinkdiff_torch.ops.quant import quantize_tree, quantize_weight

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
INIT_STD = 0.05


def _numpy_dtype(dtype: torch.dtype):
    if dtype == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return {torch.float32: np.float32, torch.float16: np.float16}[dtype]


@torch.no_grad()
def init_frozen_t5_(t5: T5ForConditionalGeneration,
                    generator: torch.Generator) -> None:
    """Seeded random weights on the module's device, as the JAX package's
    ``quantize_leaves_on_device``: every float leaf N(0, 0.05); an int8
    QDense draws its (K, N) kernel N(0, 0.05) in f32 and keeps only the
    per-column quantization, one layer at a time, so the full-precision
    tower never exists whole."""
    for module in t5.modules():
        if isinstance(module, QDense) and module.quant:
            w = torch.randn((module.in_dim, module.features),
                            generator=generator, device=generator.device)
            qw = quantize_weight(w * INIT_STD)
            module.kernel_q.copy_(qw["q"])
            module.kernel_scale.copy_(qw["scale"])
            module.sync_train_layout()
            continue
        for p in module.parameters(recurse=False):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * INIT_STD)


def load_hf_t5_(t5: T5ForConditionalGeneration, sd: Dict[str, np.ndarray],
                quantize_frozen: Optional[str]) -> Dict[str, Any]:
    """An HF flan-t5 state dict into ``t5`` as the JAX aligners load it:
    converted in the model's dtype, the parts the stack does not hold left
    out (the LVLM stack has no encoder), quantized (``int8`` weight-only,
    ``int8_dyn`` w8a8) and fused when the config asks. Returns the
    converted tree (numpy), whose encoder final norm the projector's
    ``t5_norm`` may copy."""
    tree = convert_t5(sd, dtype=_numpy_dtype(t5.cfg.dtype))
    held = {k: v for k, v in tree.items() if hasattr(t5, k)}
    held = tree_map(to_tensor, held)
    if quantize_frozen:
        held = quantize_tree(held, min_size=0,
                             w8a8=quantize_frozen == "int8_dyn")
    if t5.cfg.fused_proj:
        held = fuse_t5_params(held)
    load_params(t5, held)
    return tree


class AlignerBase:
    """Config, device, frozen T5 and trainable projector of an aligner.
    Subclasses build ``self.frozen`` and ``self.trainable`` in
    ``_build_params``."""

    default_config_path = classmethod(model_default_config_path)
    DEFAULT_CONFIG: Dict[str, Any] = {}
    # the input dropout rate of the step, None for none (the Trainer seeds
    # a generator only for a model that has one)
    drop_rate = None

    def __init__(self, cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = {**self.DEFAULT_CONFIG, **(cfg or {})}
        self.dtype = DTYPES[cfg.get("dtype", "bfloat16")]
        qmode = cfg.get("quantize_frozen", None)
        if qmode not in (None, "int8", "int8_dyn"):
            raise ValueError(f"Unsupported quantize_frozen '{qmode}'")
        self.quantize_frozen = qmode is not None
        self.t5_cfg = T5Config(**{
            **dict(dtype=self.dtype, dropout_rate=0.0,
                   quant_int8={"int8": True, "int8_dyn": "w8a8"}.get(
                       qmode, False)),
            **dict(cfg.get("t5_config", {}))})
        self.projector = build_vision_projector(
            cfg.get("mm_projector_type", "mlp2x_gelu_t5_norm"),
            self.t5_cfg.d_model, dtype=self.dtype)

    def _frozen_t5(self, generator: torch.Generator, encoder: bool):
        """The frozen T5 (with its encoder when ``encoder``): converted from
        a local flan-t5 checkpoint when ``load_pretrained`` (the default)
        and one is on disk, else seeded random weights. Returns (the
        module, the encoder's final norm weight of a loaded checkpoint or
        None)."""
        t5 = T5ForConditionalGeneration(self.t5_cfg, device=self.device,
                                        encoder=encoder)
        path = self.cfg.get("text_pretrained_model_name_or_path",
                            "google/flan-t5-xxl")
        sd = (local_hf_state_dict(path) if self.cfg.get("load_pretrained", True)
              else None)
        if sd is not None and "shared.weight" in sd:
            tree = load_hf_t5_(t5, sd, self.cfg.get("quantize_frozen"))
            logger.info("Loaded T5 weights from %s", path)
            norm = tree.get("encoder", {}).get("final_norm", {}).get("weight")
            return t5, None if norm is None else to_tensor(norm)
        init_frozen_t5_(t5, generator)
        return t5, None

    def _reinit_t5_norm(self, params, encoder_norm) -> None:
        """``layer_norm_reinit_weight_with_language_encoder``: the
        projector's trailing T5LayerNorm starts from the T5 encoder's final
        norm weight (when there is one)."""
        if (self.cfg.get("layer_norm_reinit_weight_with_language_encoder",
                         False)
                and "t5_norm" in params and encoder_norm is not None):
            params["t5_norm"]["weight"] = encoder_norm.to(
                self.device, torch.float32, copy=True)

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        return cls(cfg, device=device)

    def load_checkpoint_from_config(self, cfg) -> None:
        """Loads the trainable weights the config's ``ckpt`` names."""
        ckpt = cfg.get("ckpt", None) if cfg else None
        if ckpt:
            self.load_checkpoint(ckpt)

    def load_checkpoint(self, path: str) -> None:
        """Trainable weights from a ``.pth``: the port's checkpoint (its
        ``model`` holds the trainable leaves under their JAX names) or the
        reference's (``mm_projector.*`` entries, raw or under ``model``)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]
        if any("mm_projector" in k for k in sd):
            self.load_trainable(self.convert_reference_checkpoint(sd))
        else:
            self.load_trainable(unflatten(sd))
        logger.info("Loaded trainable checkpoint from %s", path)

    def trainable_params(self) -> Dict[str, Any]:
        return self.trainable

    @staticmethod
    def label_count(batch) -> torch.Tensor:
        """The label tokens ``loss_fn``'s token mean divides by (labels
        other than -100), on the batch's device: over several ranks the
        trainer weighs each rank's loss by it to form the global mean."""
        return (batch["labels"] != -100).sum()

    def load_trainable(self, params: Dict[str, Any]) -> None:
        """A JAX-layout trainable tree (numpy or torch leaves), copied."""
        self.trainable = tree_map(
            lambda x: to_tensor(x).to(self.device, copy=True), params)

    def export_trainable(self) -> Dict[str, Any]:
        """Inverse of ``load_trainable``: the trainable tree as numpy. A
        frozen tower's is ``bridge.params_of(frozen[name])``."""
        return tree_map(to_numpy, self.trainable)

    def convert_reference_checkpoint(self, sd: Dict) -> Dict[str, Any]:
        """The reference's trainable checkpoint (its ``mm_projector.*``
        entries) -> the trainable tree, numpy leaves (``load_trainable``
        takes it)."""
        return {"projector": convert_projector_torch(
            {k: v for k, v in sd.items() if "mm_projector" in k})}

    def export_reference_checkpoint(self, trainable: Dict) -> Dict:
        """Inverse of ``convert_reference_checkpoint``: a state dict the
        reference's PyTorch stack loads. An instance made without its
        config (the converter CLI's) infers the projector type from the
        tree, as the JAX package does."""
        cfg = getattr(self, "cfg", None)
        return export_projector_torch(
            trainable["projector"],
            cfg.get("mm_projector_type", "mlp2x_gelu_t5_norm") if cfg
            else None)

    def get_t5_tokenizer(self):
        """The T5 tokenizer from local files only; None when they are not on
        disk (nothing is downloaded, and without local files transformers
        is not even imported)."""
        path = self.cfg.get("text_pretrained_model_name_or_path",
                            "google/flan-t5-xxl")
        local = local_hf_dir(path)
        if local is None:
            logger.warning("T5 tokenizer unavailable: %s is not on disk", path)
            return None
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(local, local_files_only=True)
        except (ImportError, OSError, ValueError) as e:
            # no transformers, or incomplete files
            logger.warning("T5 tokenizer unavailable for %s: %s", path, e)
            return None
