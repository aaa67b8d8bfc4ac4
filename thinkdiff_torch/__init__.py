"""thinkdiff_torch: the PyTorch/CUDA port of thinkdiff_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``engines/``) with hand-written Hopper kernels in
``csrc/`` (CUDA C++, built by ``kernels/``) and Triton (``ops/norms``).
It imports ``torch`` and never JAX. See ROADMAP.md for what is ported.
"""

from __future__ import annotations

from typing import Callable, Dict

__version__ = "0.1.0"


class Registry:
    """Model name -> class map of the port, kept apart from the JAX
    package's registry so both packages can register the same names in one
    process."""

    def __init__(self):
        self.models: Dict[str, type] = {}

    def register_model(self, name: str) -> Callable[[type], type]:
        def wrap(cls: type) -> type:
            if self.models.get(name, cls) is not cls:
                raise KeyError(f"Model '{name}' already registered for "
                               f"{self.models[name]}")
            self.models[name] = cls
            return cls

        return wrap

    def get_model_class(self, name: str):
        return self.models.get(name)


registry = Registry()
