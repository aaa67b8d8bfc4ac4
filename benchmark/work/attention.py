"""Operations and bytes that one attention call needs, from its shapes.

Operations: the two products of the forward (Q K^T and P V), 2 * D
multiply-adds per (query, key) pair each; a causal call counts only the
pairs its mask keeps. The backward needs four products (dV = P^T dO,
dP = dO V^T, dQ = dS K, dK = dS^T Q) and no recomputation. Bytes: each
input read once and each output written once (q, k, v, out; a bias in
float32, a key mask in int32; the backward also reads out, dO and the
row log-sum-exp and writes dq, dk, dv)."""

from __future__ import annotations


def pairs(tq: int, tk: int, causal: bool) -> float:
    """(query, key) pairs the call computes; a causal mask aligned at the
    end (query i sees keys up to i + tk - tq)."""
    if not causal:
        return float(tq * tk)
    return float(sum(min(tk, max(0, i + 1 + tk - tq)) for i in range(tq)))


def forward(b: int, h: int, tq: int, tk: int, d: int, causal: bool = False,
            bias_heads: int = 0, kv_mask: bool = False, elem: int = 2) -> dict:
    ops = 4.0 * b * h * d * pairs(tq, tk, causal)
    nbytes = elem * b * h * d * (2 * tq + 2 * tk) + 4 * bias_heads * tq * tk
    nbytes += 4 * b * tk if kv_mask else 0
    return {"op": "attention", "ops": ops, "bytes": float(nbytes)}


def backward(b: int, h: int, tq: int, tk: int, d: int, causal: bool = False,
             bias_heads: int = 0, kv_mask: bool = False,
             elem: int = 2) -> dict:
    ops = 8.0 * b * h * d * pairs(tq, tk, causal)
    # read q, out, dO (tq) and k, v (tk), lse; write dq (tq), dk, dv (tk)
    nbytes = (elem * b * h * d * (4 * tq + 4 * tk) + 4 * b * h * tq
              + 4 * bias_heads * tq * tk)
    nbytes += 4 * b * tk if kv_mask else 0
    return {"op": "attention", "ops": ops, "bytes": float(nbytes)}
