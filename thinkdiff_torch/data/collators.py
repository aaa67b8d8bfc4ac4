"""Collation helpers (the port's copy of thinkdiff_tpu/data/collators.py's
``bucket_length``)."""

from __future__ import annotations


def bucket_length(n: int, max_len: int, min_len: int = 32,
                  multiple: int = 32) -> int:
    """Next multiple of ``multiple`` >= n, clamped to [min_len, max_len]:
    padded batches land in few shapes (the reference pads to the batch's
    longest sample)."""
    b = max(min_len, -(-n // multiple) * multiple)
    return min(b, max_len)
