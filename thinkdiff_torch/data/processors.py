"""Host-side image and caption processors (the port's copy of
thinkdiff_tpu/data/processors.py, under the same registry names).

The BLIP processors of ThinkDiff-CLIP: bicubic resize to a square, CLIP's
mean/std normalization, HWC float32 numpy (the ViT takes NHWC); caption
clean-up. The VLM processors keep RGB PIL images: the VLM engine
patchifies them itself.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from thinkdiff_torch.core.registry import registry


class BaseProcessor:
    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(**{k: v for k, v in dict(cfg).items() if k != "name"})


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@registry.register_processor("blip_image_eval")
@registry.register_processor("blip2_image_eval")
class BlipImageEvalProcessor(BaseProcessor):
    """RGB, bicubic resize to ``image_size`` squared, [0, 1], then CLIP's
    mean/std: (H, W, 3) float32."""

    def __init__(self, image_size: int = 224, mean=CLIP_MEAN, std=CLIP_STD,
                 **kw):
        self.image_size = image_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        image = image.convert("RGB").resize(
            (self.image_size, self.image_size), Image.BICUBIC)
        arr = np.asarray(image, np.float32) / 255.0
        return (arr - self.mean) / self.std


@registry.register_processor("blip_image_train")
@registry.register_processor("blip2_image_train")
class BlipImageTrainProcessor(BlipImageEvalProcessor):
    """The train variant: the same resize and normalization (the reference
    configs in use train on it); ``min_scale`` / ``max_scale`` are kept for
    the config surface."""

    def __init__(self, image_size: int = 224, min_scale: float = 0.5,
                 max_scale: float = 1.0, **kw):
        super().__init__(image_size=image_size, **kw)
        self.min_scale = min_scale
        self.max_scale = max_scale


@registry.register_processor("blip_caption")
class BlipCaptionProcessor(BaseProcessor):
    """Lower case, punctuation to spaces, runs of spaces to one, at most
    ``max_words`` words, after ``prompt``."""

    def __init__(self, prompt: str = "", max_words: int = 50, **kw):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption


@registry.register_processor("mllama_image_train")
@registry.register_processor("mllama_image_eval")
class MllamaImageProcessor(BaseProcessor):
    """RGB PIL images, downscaled (bicubic) so the longer side is at most
    ``max_size`` when one is given."""

    def __init__(self, max_size: Optional[int] = None, **kw):
        self.max_size = max_size

    def __call__(self, image):
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        image = image.convert("RGB")
        if self.max_size and max(image.size) > self.max_size:
            scale = self.max_size / max(image.size)
            image = image.resize(
                (int(image.width * scale), int(image.height * scale)),
                Image.BICUBIC)
        return image


def build_processor(cfg) -> BaseProcessor:
    if cfg is None:
        return BaseProcessor()
    name = cfg.get("name") if hasattr(cfg, "get") else cfg
    cls = registry.get_processor_class(name)
    if cls is None:
        raise KeyError(f"Unknown processor '{name}'")
    return cls.from_config(cfg if hasattr(cfg, "get") else None)
