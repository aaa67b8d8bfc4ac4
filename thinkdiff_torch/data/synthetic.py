"""Synthetic aligner batches with bench.py's workload statistics (the
port's copies of ``build_batches`` and ``build_batches_packed``): Qwen2-VL
generations of N(60, 25) tokens clipped to [16, 200], split at random into
a condition prefix (at most 128 embeds) and T5 labels (at most 128 tokens)
as the collator splits them, random embeds and label ids from ``rs``.
The same RandomState gives the same batches as bench.py's functions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from thinkdiff_torch.data.collators import bucket_length
from thinkdiff_torch.data.packing import OnlinePacker


def build_batches(rs: np.random.RandomState, n_batches: int, batch_size: int,
                  d_vlm: int, vocab: int, max_split: int = 128,
                  max_txt: int = 128, sort_window: int = 256
                  ) -> List[Dict[str, np.ndarray]]:
    """Padded batches: samples grouped by the two-level windowed sort
    (window 256, key (label bucket, split)) and padded to ``bucket_length``
    buckets on both axes, with ``embed_mask`` and -100 label padding."""
    n_total = n_batches * batch_size
    gen_lens = np.clip(rs.normal(60, 25, n_total).astype(int), 16, 200)
    splits = np.array([rs.randint(1, min(n - 1, max_split) + 1)
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


def build_batches_packed(rs: np.random.RandomState, n_batches: int, rows: int,
                         enc_cap: int, dec_cap: int, d_vlm: int, vocab: int,
                         max_split: int = 128, max_txt: int = 128
                         ) -> Tuple[List[Dict[str, np.ndarray]], int]:
    """Packed batches of ``rows`` rows (OnlinePacker: several samples per
    row, segment ids). Returns (batches, samples), samples counted as
    bench.py counts them: the distinct decoder segments of every row."""
    packer = OnlinePacker(rows=rows, enc_cap=enc_cap, dec_cap=dec_cap)
    batches, n_samples = [], 0
    while len(batches) < n_batches:
        n = int(np.clip(rs.normal(60, 25), 16, 200))
        split = rs.randint(1, min(n - 1, max_split) + 1)
        label_len = min(n - split + 1, max_txt)
        b = packer.add({
            "embeds": rs.randn(split, d_vlm).astype(np.float32),
            "label_ids": rs.randint(1, vocab, (label_len,)).astype(np.int32),
        })
        if b is not None:
            batches.append(b)
            n_samples += int(sum(len(np.unique(r[r > 0]))
                                 for r in b["dec_segments"]))
    return batches, n_samples
