"""Operations and bytes of one RMSNorm call: ``rows`` rows of ``d``
read and written once, the scale read once; about 4 operations an
element (square, sum, scale twice). Bound by bytes on any card."""

from __future__ import annotations


def forward(rows: int, d: int, elem: int = 2) -> dict:
    return {"op": "rmsnorm", "ops": 4.0 * rows * d,
            "bytes": float(elem * (2 * rows * d + d))}
