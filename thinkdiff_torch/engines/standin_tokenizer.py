"""A stand-in tokenizer for runs without the real tokenizer files.

Special tokens map to fixed ids; every other whitespace-separated word (and
each newline) maps to a stable id from its CRC-32. It has the methods the
embedding engine calls: ``encode``, ``decode``, ``convert_tokens_to_ids``
and ``eos_token_id``.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

# Qwen2-VL's chat and vision special-token ids
QWEN2_VL_SPECIALS = {
    "<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
    "<|vision_start|>": 151652, "<|vision_end|>": 151653,
    "<|image_pad|>": 151655,
}


class StandInTokenizer:
    def __init__(self, specials: Dict[str, int] = None, word_lo: int = 1,
                 word_hi: int = 151000, eos_token: str = "<|endoftext|>"):
        self.specials = dict(specials or QWEN2_VL_SPECIALS)
        self.word_lo, self.word_hi = word_lo, word_hi
        self.eos_token_id = self.specials[eos_token]
        self._special_ids = set(self.specials.values())

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for part in re.split(r"(<\|[a-z_]+\|>)", text):
            if not part:
                continue
            if part in self.specials:
                ids.append(self.specials[part])
                continue
            for w in re.findall(r"\S+|\n", part):
                span = self.word_hi - self.word_lo
                ids.append(self.word_lo + zlib.crc32(w.encode()) % span)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"t{i}" for i in ids
                        if not (skip_special_tokens and i in self._special_ids))

    def convert_tokens_to_ids(self, token: str):
        return self.specials.get(token)
