"""CLIP ids of the prompt a rendering request carries (ThinkDiff-LVLM
renders with the empty prompt): a stand-in for CLIP's tokenizer with its
call signature, giving BOS, one id a word (its CRC-32 over the vocabulary)
and EOS, padded with EOS to ``max_length``, as CLIP-L's tokenizer pads.
The benchmark gives the same ids to the program and to the reference."""

from __future__ import annotations

import zlib

import numpy as np


class PromptIds:
    def __init__(self, text_encoder: dict):
        self.bos = int(text_encoder["bos_token_id"])
        self.eos = int(text_encoder["eos_token_id"])
        self.words = min(self.bos, self.eos)

    def ids(self, text: str, max_length: int = 77):
        row = [self.bos] + [zlib.crc32(w.encode()) % self.words
                            for w in text.split()][:max_length - 2]
        row.append(self.eos)
        return row + [self.eos] * (max_length - len(row))

    def __call__(self, texts, padding="max_length", max_length=77,
                 truncation=True, return_tensors="np"):
        return {"input_ids": np.asarray([self.ids(t, max_length)
                                         for t in texts], np.int64)}
