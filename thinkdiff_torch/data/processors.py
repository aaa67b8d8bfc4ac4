"""Host-side processors of the embedding builders (the port's copy of the
VLM image processors of thinkdiff_tpu/data/processors.py, under the same
registry names). Images stay RGB PIL images: the VLM engine patchifies
them itself.
"""

from __future__ import annotations

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
