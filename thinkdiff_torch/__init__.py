"""thinkdiff_torch: the PyTorch/CUDA port of thinkdiff_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``engines/``) with hand-written Hopper kernels in
``csrc/`` (CUDA C++, built and bound by ``kernels/``).
It imports ``torch`` and never JAX. See ROADMAP.md for what is ported.
"""

from __future__ import annotations

from thinkdiff_torch.core.registry import Registry, registry  # noqa: F401

__version__ = "0.1.0"


def resolve_device(device):
    """The device an entry point runs on. A CUDA device needs a card:
    without one this raises instead of running on the CPU. ``cuda`` with
    no index is the current card: the rank's own card once
    ``core.distributed.init_distributed_mode`` has made it current."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions of its "
            "kernels on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
