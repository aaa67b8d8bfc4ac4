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

A head split over ``model`` by vocabulary (parallel/sharding.py) is used
as its shards: each rank's logits are its vocabulary's columns; the row
max is the MAX over the model group, the rescaled exp-sums and the
target's logit (from the one rank that owns it) SUMs, so the log-
likelihood is log-softmax's without whole logits; the backward's partial
d(hidden) is summed over the group by the head. A head split over
``fsdp`` is gathered once a call, not a chunk (the ranks of the fsdp
group may hold different numbers of chunks). Under the checkpoint the
recompute issues the same collectives in the same order on every peer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from thinkdiff_torch.parallel import collectives as col


def apply_lm_head(x: torch.Tensor, head, dtype) -> torch.Tensor:
    """``x (..., D)`` -> ``(..., V)`` through the lm_head QDense (fp,
    weight-only int8 or w8a8: the layer carries its layout)."""
    return head(x.to(dtype))


def _whole_fsdp(head):
    """The head with its fsdp blocks gathered once for the whole call."""
    gathered = getattr(head, "fsdp_gathered", None)
    return gathered() if gathered is not None else head


def _pad(hidden, labels, chunk, ignore_index):
    t = hidden.shape[1]
    if t % chunk:
        pad = chunk - t % chunk
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=ignore_index)
    return hidden, labels


def _vocab_split(head) -> bool:
    return getattr(head, "tp_local", False) and col.model_size() > 1


def _chunk_ll(h, y, head, dtype, ignore_index):
    valid = y != ignore_index
    safe = torch.where(valid, y, torch.zeros_like(y)).long()
    if not _vocab_split(head):
        logits = apply_lm_head(h, head, dtype).float()
        ll = torch.log_softmax(logits, dim=-1).gather(
            -1, safe[..., None])[..., 0]
        return (ll * valid).sum(), logits
    logits = head(h.to(dtype), keep_local=True).float()
    ll = vocab_split_ll(logits, safe)
    return (ll * valid).sum(), logits


def vocab_split_ll(logits: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """The log-likelihood of ``safe`` from this rank's vocabulary shard of
    the logits (rank m holds columns [m V_l, (m+1) V_l)): the row max, the
    exp-sum and the target's logit across the model group."""
    v = logits.shape[-1]
    lo = col.model_index() * v
    m = logits.detach().amax(dim=-1)
    col.model_all_reduce(m, "max")
    z = col.reduce_from_model((logits - m[..., None]).exp().sum(dim=-1))
    own = (safe >= lo) & (safe < lo + v)
    t = logits.gather(-1, (safe - lo).clamp(0, v - 1)[..., None])[..., 0]
    t = col.reduce_from_model(t * own)
    return t - m - z.log()


def vocab_split_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The global argmax over the model group's vocabulary shards, the
    first index winning a tie as ``torch.argmax``'s does."""
    v = logits.shape[-1]
    best, idx = logits.max(dim=-1)
    idx = idx + col.model_index() * v
    n = col.model_size()
    bests = col.gather_from_model(best[..., None].contiguous(), -1)
    idxs = col.gather_from_model(idx[..., None].contiguous(), -1)
    top = bests.amax(dim=-1, keepdim=True)
    # the shards are in vocabulary order: the first shard at the max holds
    # the smallest index among the ties
    first = (bests == top).float().argmax(dim=-1, keepdim=True)
    assert idxs.shape[-1] == n
    return idxs.gather(-1, first)[..., 0]


def chunked_head_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                               head, dtype=torch.bfloat16, chunk: int = 32,
                               ignore_index: int = -100) -> torch.Tensor:
    """Token-mean CE of ``lm_head(hidden)`` vs ``labels`` without full
    logits; hidden (B, T, D), labels (B, T) with ``ignore_index`` padding."""
    hidden, labels = _pad(hidden, labels, chunk, ignore_index)
    head = _whole_fsdp(head)
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
    head = _whole_fsdp(head)
    sum_ll = hidden.new_zeros((), dtype=torch.float32)
    correct = hidden.new_zeros((), dtype=torch.float32)
    with torch.no_grad():
        for c0 in range(0, hidden.shape[1], chunk):
            h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
            s, logits = _chunk_ll(h, y, head, dtype, ignore_index)
            sum_ll += s
            valid = y != ignore_index
            top = (vocab_split_argmax(logits) if _vocab_split(head)
                   else logits.argmax(-1))
            correct += ((top == y) & valid).float().sum()
    count = (labels != ignore_index).sum().float()
    return -sum_ll / count.clamp(min=1.0), correct, count
