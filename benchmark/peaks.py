"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit) and the least time an
operation can take on it. Every run's ``device`` gives the card's power
limit beside the rooflines read against these peaks."""

from __future__ import annotations

# operations per second
PEAK_OPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
            "tf32": 495e12, "fp32": 67e12}
# HBM3 bytes per second
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """The least seconds the card could take: the larger of the bytes at
    the HBM rate and the operations at the ``kind`` rate."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[kind])
