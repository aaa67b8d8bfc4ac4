"""Chunked lm_head + softmax cross-entropy (counterpart of
thinkdiff_tpu/ops/chunked_ce.py).

The aligner's largest activation would be the (rows, 32128) logits chain.
This op never materializes full-sequence logits: it walks the decoder's
final hidden states in token chunks, and each chunk's logits, log-softmax
and label log-likelihood run under ``torch.utils.checkpoint`` (not
reentrant), so the backward recomputes the chunk's logits instead of
keeping them, as JAX's ``jax.checkpoint`` body does. Per-token numerics
equal the monolithic head: log-softmax is per row. The lm_head is frozen,
so the backward gives d(hidden) only.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def apply_lm_head(x: torch.Tensor, head, dtype) -> torch.Tensor:
    """``x (..., D)`` -> ``(..., V)`` through the lm_head QDense (fp,
    weight-only int8 or w8a8: the layer carries its layout)."""
    return head(x.to(dtype))


def _pad(hidden, labels, chunk, ignore_index):
    t = hidden.shape[1]
    if t % chunk:
        pad = chunk - t % chunk
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=ignore_index)
    return hidden, labels


def _chunk_ll(h, y, head, dtype, ignore_index):
    logits = apply_lm_head(h, head, dtype).float()
    valid = y != ignore_index
    safe = torch.where(valid, y, torch.zeros_like(y)).long()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (ll * valid).sum(), logits


def chunked_head_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                               head, dtype=torch.bfloat16, chunk: int = 32,
                               ignore_index: int = -100) -> torch.Tensor:
    """Token-mean CE of ``lm_head(hidden)`` vs ``labels`` without full
    logits; hidden (B, T, D), labels (B, T) with ``ignore_index`` padding."""
    hidden, labels = _pad(hidden, labels, chunk, ignore_index)
    count = (labels != ignore_index).sum().float()
    sum_ll = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, hidden.shape[1], chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        sum_ll = sum_ll + checkpoint(
            lambda h, y: _chunk_ll(h, y, head, dtype, ignore_index)[0], h, y,
            use_reentrant=False)
    return -sum_ll / count.clamp(min=1.0)


def chunked_head_ce_stats(hidden: torch.Tensor, labels: torch.Tensor, head,
                          dtype=torch.bfloat16, chunk: int = 32,
                          ignore_index: int = -100):
    """Eval-side variant: ``(loss, n_correct, n_tokens)`` with teacher-
    forced next-token accuracy (argmax(logits) == label over non-ignored
    positions). No gradient."""
    hidden, labels = _pad(hidden, labels, chunk, ignore_index)
    sum_ll = hidden.new_zeros((), dtype=torch.float32)
    correct = hidden.new_zeros((), dtype=torch.float32)
    with torch.no_grad():
        for c0 in range(0, hidden.shape[1], chunk):
            h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
            s, logits = _chunk_ll(h, y, head, dtype, ignore_index)
            sum_ll += s
            valid = y != ignore_index
            correct += ((logits.argmax(-1) == y) & valid).float().sum()
    count = (labels != ignore_index).sum().float()
    return -sum_ll / count.clamp(min=1.0), correct, count
