"""Padded aligner training batches: a frozen copy of the port's
``data/synthetic.build_batches`` and ``data/collators.bucket_length``
(themselves copies of bench.py's workload): Qwen2-VL generations of
N(60, 25) tokens clipped to [16, 200], split at random into a condition
prefix (at most ``max_split`` embeds) and T5 labels (at most ``max_txt``
tokens) as the collator splits them, grouped by the two-level windowed
sort and padded to 32-token buckets on both axes.

``build_batches`` takes two RandomStates: ``sizes`` draws the lengths and
splits, ``rs`` the embeds, the label ids and the batch order. Given one
RandomState for both it draws what the port's function draws. The
benchmark gives ``sizes`` a seed fixed in the traffic file and ``rs`` the
run's seed, so every run seed trains on the same batch shapes, in another
order and with other contents."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def bucket_length(n: int, max_len: int, min_len: int = 32,
                  multiple: int = 32) -> int:
    b = max(min_len, -(-n // multiple) * multiple)
    return min(b, max_len)


def build_batches(sizes: np.random.RandomState, rs: np.random.RandomState,
                  n_batches: int, batch_size: int, d_vlm: int, vocab: int,
                  max_split: int = 128, max_txt: int = 128,
                  sort_window: int = 256) -> List[Dict[str, np.ndarray]]:
    n_total = n_batches * batch_size
    gen_lens = np.clip(sizes.normal(60, 25, n_total).astype(int), 16, 200)
    splits = np.array([sizes.randint(1, min(n - 1, max_split) + 1)
                       for n in gen_lens])
    label_lens = np.minimum(gen_lens - splits + 1, max_txt)
    order = []
    for i in range(0, n_total, sort_window):
        w = np.arange(i, min(i + sort_window, n_total))
        label_buckets = [bucket_length(max(1, int(n - s)), max_txt)
                         for n, s in zip(gen_lens[w], splits[w])]
        order.extend(w[np.lexsort((splits[w], label_buckets))])
    order = np.asarray(order)

    batches = []
    for bi in range(n_batches):
        idx = order[bi * batch_size:(bi + 1) * batch_size]
        sb = bucket_length(int(splits[idx].max()), max_split)
        tb = bucket_length(int(label_lens[idx].max()), max_txt)
        embeds = rs.randn(batch_size, sb, d_vlm).astype(np.float32)
        mask = (np.arange(sb)[None] < splits[idx][:, None]).astype(np.int32)
        labels = rs.randint(1, vocab, (batch_size, tb)).astype(np.int32)
        labels[np.arange(tb)[None] >= label_lens[idx][:, None]] = -100
        batches.append({"embeds": embeds, "embed_mask": mask,
                        "labels": labels})
    rs.shuffle(batches)
    return batches


def seeded(seed: int) -> np.random.RandomState:
    """A RandomState from any whole seed (wider than 32 bits too)."""
    return np.random.RandomState(
        np.random.SeedSequence(int(seed)).generate_state(1)[0])


def make(params: dict, seed: int, config: dict) -> List[Dict[str, np.ndarray]]:
    """The pool of host batches a run trains on, cycled in order."""
    return build_batches(
        np.random.RandomState(int(params["sizes_seed"])), seeded(seed),
        int(params["pool_batches"]), int(params["batch_size"]),
        int(config["vlm_hidden_size"]), int(config["t5"]["vocab_size"]),
        int(params["max_split"]), int(params["max_txt"]),
        int(params["sort_window"]))
