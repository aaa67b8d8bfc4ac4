"""Sequence packing for aligner training (the port's copy of
thinkdiff_tpu/data/packing.py, numpy only).

The reference pads every batch to its longest sample
(mllama_vllm_t5_embed_decoder_2.py:570 padding='longest'). Packing removes the padding
axis entirely: multiple samples share one row of the batch, attention is
restricted to same-segment pairs via the flash kernel's segment-id inputs
(ops/flash_attention.py), and the loss is untouched because
cross_entropy_loss is a GLOBAL mean over valid (non -100) tokens — the
packed batch carries exactly the same token set as the unpacked one.

Decoder inputs are built HERE, per segment ([start] + ids[:-1]), because a
global shift_right over a packed row would leak segment i's last token
into segment i+1's first position.

Capacity is two-axis (condition embeds, label tokens); rows are filled
first-fit-decreasing over the window the batcher hands us, so the row
count is data-dependent — callers bucket it (multiple-of-``row_bucket``)
to bound recompilation, same discipline as bucket_length for the padded
axes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def pack_rows(samples: Sequence[Dict[str, Any]], enc_cap: int, dec_cap: int,
              d_vlm: Optional[int] = None, decoder_start_id: int = 0,
              pad_id: int = 0, row_bucket: int = 4,
              embeds_dtype=np.float32) -> Dict[str, np.ndarray]:
    """Pack samples into rows of (enc_cap embeds, dec_cap label tokens).

    samples: dicts with ``embeds`` (S_i, Dv) float and ``label_ids`` (L_i,)
    int (the raw target ids — no -100s, no start token). Each sample must
    satisfy S_i <= enc_cap and L_i <= dec_cap.

    Returns a batch dict:
      embeds (R, enc_cap, Dv) — condition rows, zero padded
      enc_segments / embed_mask (R, enc_cap) int32 — ids >= 1, 0 = pad
      labels (R, dec_cap) int32 — -100 padded
      decoder_input_ids (R, dec_cap) int32 — per-segment shift-right
      dec_segments (R, dec_cap) int32
    with R rounded up to a multiple of ``row_bucket`` (all-pad rows carry
    segment id 0 everywhere and contribute no loss tokens).
    """
    items = []
    for s in samples:
        e = np.asarray(s["embeds"])
        l = np.asarray(s["label_ids"], np.int64).reshape(-1)
        if e.shape[0] > enc_cap or len(l) > dec_cap:
            raise ValueError(f"pack_rows: sample ({e.shape[0]}, {len(l)}) "
                             f"exceeds the caps ({enc_cap}, {dec_cap})")
        items.append((e, l))
    if d_vlm is None:
        d_vlm = items[0][0].shape[1]

    # first-fit-decreasing on the max of both axis fractions
    order = sorted(range(len(items)),
                   key=lambda i: -max(items[i][0].shape[0] / enc_cap,
                                      len(items[i][1]) / dec_cap))
    rows: List[List[int]] = []
    used = []  # (enc_used, dec_used)
    for i in order:
        se, sd = items[i][0].shape[0], len(items[i][1])
        for r, (ue, ud) in enumerate(used):
            if ue + se <= enc_cap and ud + sd <= dec_cap:
                rows[r].append(i)
                used[r] = (ue + se, ud + sd)
                break
        else:
            rows.append([i])
            used.append((se, sd))
    return _fill_rows(rows, items, enc_cap, dec_cap, d_vlm,
                      decoder_start_id, pad_id, row_bucket, embeds_dtype)


def _fill_rows(rows, items, enc_cap, dec_cap, d_vlm, decoder_start_id,
               pad_id, row_bucket, embeds_dtype=np.float32):
    """Materialize a packed batch from an explicit row assignment."""
    r_out = -(-max(len(rows), 1) // row_bucket) * row_bucket
    embeds = np.zeros((r_out, enc_cap, d_vlm), embeds_dtype)
    enc_seg = np.zeros((r_out, enc_cap), np.int32)
    labels = np.full((r_out, dec_cap), -100, np.int32)
    dec_in = np.full((r_out, dec_cap), pad_id, np.int32)
    dec_seg = np.zeros((r_out, dec_cap), np.int32)
    for r, members in enumerate(rows):
        eo = do = 0
        for sid, i in enumerate(members, start=1):
            e, l = items[i]
            se, sd = e.shape[0], len(l)
            embeds[r, eo:eo + se] = e
            enc_seg[r, eo:eo + se] = sid
            labels[r, do:do + sd] = l
            dec_in[r, do] = decoder_start_id
            dec_in[r, do + 1:do + sd] = l[:-1]
            dec_seg[r, do:do + sd] = sid
            eo += se
            do += sd
    return {
        "embeds": embeds,
        "embed_mask": (enc_seg > 0).astype(np.int32),
        "enc_segments": enc_seg,
        "labels": labels,
        "decoder_input_ids": dec_in,
        "dec_segments": dec_seg,
    }


class OnlinePacker:
    """Streaming packer emitting FIXED-shape batches of exactly ``rows``
    rows — one compiled train-step shape, no bucket ladder. Samples
    accumulate first-fit into open rows until the next one cannot fit any
    of them; the batch is then emitted with that online assignment (no
    FFD re-pack — the stream order is already shuffled upstream, and
    measured fills are within a point of pack_rows' offline FFD).

    At the aligner mixture the condition and label lengths anti-correlate
    (split + label ~= generation length + 1), so rows fill both axes
    together — measured fills are ~90%+ vs the ~58% of bucketed padding.
    """

    def __init__(self, rows: int, enc_cap: int, dec_cap: int,
                 decoder_start_id: int = 0, pad_id: int = 0):
        self.rows = rows
        self.enc_cap = enc_cap
        self.dec_cap = dec_cap
        self.decoder_start_id = decoder_start_id
        self.pad_id = pad_id
        self._samples: List[Dict[str, Any]] = []
        self._assign: List[List[int]] = []  # row -> sample indices
        self._used: List[List[int]] = []  # per open row: [enc_used, dec_used]

    def _fit(self, se: int, sd: int):
        for r, u in enumerate(self._used):
            if u[0] + se <= self.enc_cap and u[1] + sd <= self.dec_cap:
                u[0] += se
                u[1] += sd
                return r
        if len(self._used) < self.rows:
            self._used.append([se, sd])
            self._assign.append([])
            return len(self._used) - 1
        return None

    def _emit(self) -> Dict[str, np.ndarray]:
        items = [(np.asarray(s["embeds"]),
                  np.asarray(s["label_ids"], np.int64).reshape(-1))
                 for s in self._samples]
        batch = _fill_rows(self._assign, items, self.enc_cap, self.dec_cap,
                           items[0][0].shape[1], self.decoder_start_id,
                           self.pad_id, row_bucket=self.rows)
        self._samples, self._assign, self._used = [], [], []
        return batch

    def add(self, sample: Dict[str, Any]):
        """Returns a full batch when this sample would overflow, else None
        (the sample is always retained)."""
        se = int(np.asarray(sample["embeds"]).shape[0])
        sd = int(len(sample["label_ids"]))
        if se > self.enc_cap or sd > self.dec_cap:
            raise ValueError(f"OnlinePacker: sample ({se}, {sd}) exceeds the "
                             f"caps ({self.enc_cap}, {self.dec_cap})")
        out = None
        r = self._fit(se, sd)
        if r is None:
            out = self._emit()
            r = self._fit(se, sd)
        self._assign[r].append(len(self._samples))
        self._samples.append(sample)
        return out

    def flush(self):
        return self._emit() if self._samples else None


def packed_stats(batch: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Utilization diagnostics: fraction of non-pad positions per axis."""
    enc = batch["enc_segments"]
    dec = batch["dec_segments"]
    return {
        "rows": int(enc.shape[0]),
        "enc_fill": float((enc > 0).mean()),
        "dec_fill": float((dec > 0).mean()),
        "samples": int(max(enc.max(initial=0), dec.max(initial=0)) and
                       sum(len(np.unique(r[r > 0])) for r in dec)),
    }
