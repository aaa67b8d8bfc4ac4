"""Batch collators (the port's copy of thinkdiff_tpu/data/collators.py):
host numpy batches for the trainer (ThinkDiff-CLIP's caption splits,
ThinkDiff-LVLM's embedding shards), PIL images and prompts for the VLM
engine.

Embeddings read from shards are torch tensors (bf16 as the engine writes
them); the collator converts them to f32 with torch. Random splits and
instruction choices draw from ``random.Random`` in the JAX package's order,
so one seed gives the same batches.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

IGNORE_INDEX = -100

# The caption instructions of the embedding precompute (the reference's
# prompt set; precomputed shards are interchangeable with its own).
LLAVA_BRIEF_INSTRUCTIONS = [
    "Describe the image concisely.",
    "Provide a brief description of the given image.",
    "Offer a succinct explanation of the picture presented.",
    "Summarize the visual content of the image.",
    "Give a short and clear explanation of the subsequent image.",
    "Share a concise interpretation of the image provided.",
    "Present a compact description of the photo's key features.",
    "Relay a brief, clear account of the picture shown.",
    "Render a clear and concise summary of the photo.",
    "Write a terse but informative summary of the picture.",
    "Create a compact narrative representing the image presented.",
    "Generate a prompt that can recreate the image in a 2D diffusion model.",
    "Provide a descriptive prompt to reproduce the given image using a diffusion model.",
    "Create a prompt suitable for a 2D diffusion model to generate the same image.",
    "Summarize the visual details as a prompt for a 2D diffusion model.",
    "Write a clear prompt to guide a 2D diffusion model in recreating the image.",
]


def bucket_length(n: int, max_len: int, min_len: int = 32,
                  multiple: int = 32) -> int:
    """Next multiple of ``multiple`` >= n, clamped to [min_len, max_len]:
    padded batches land in few shapes (the reference pads to the batch's
    longest sample)."""
    b = max(min_len, -(-n // multiple) * multiple)
    return min(b, max_len)


def _pad_ids(ids: Sequence[int], length: int, pad: int) -> np.ndarray:
    out = np.full((length,), pad, np.int32)
    ids = list(ids)[:length]
    out[: len(ids)] = ids
    return out


def tokenize_batch(tokenizer, texts: List[str], max_len: int,
                   add_special_tokens: bool = True):
    """-> (ids (B, max_len) int32, mask (B, max_len) int32)."""
    ids_list = [tokenizer.encode(t, add_special_tokens=add_special_tokens)
                for t in texts]
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    ids = np.stack([_pad_ids(i, max_len, pad_id) for i in ids_list])
    mask = np.stack([_pad_ids([1] * len(i), max_len, 0) for i in ids_list])
    return ids, mask


def labels_from_ids(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Pad positions -> -100."""
    return np.where(mask > 0, ids, IGNORE_INDEX).astype(np.int32)


def random_split_string(s: str, rng: Optional[random.Random] = None):
    """A caption split at a uniformly drawn word boundary: (first half,
    second half); a one-word caption gives ("", caption). Draws from
    ``rng``, or from the module-level ``random`` without one."""
    rng = rng or random
    words = s.split(" ")
    if len(words) <= 1:
        return "", s
    split_point = rng.randint(1, len(words) - 1)
    return " ".join(words[:split_point]), " ".join(words[split_point:])


def biased_random_split_string(s: str, std_factor: float = 6,
                               rng: Optional[random.Random] = None):
    """A split near the middle: the boundary drawn from N(n/2, n/std_factor)
    words, clamped to [1, n - 1]."""
    rng = rng or random
    words = s.split(" ")
    if len(words) <= 1:
        return "", s
    mean = len(words) / 2
    stddev = len(words) / std_factor
    split_point = int(rng.gauss(mean, stddev))
    split_point = max(1, min(split_point, len(words) - 1))
    return " ".join(words[:split_point]), " ".join(words[split_point:])


class CaptionSplitCollator:
    """ThinkDiff-CLIP training batches: each sample's image and its caption
    split in two, the first half the T5 encoder's input and the second the
    labels, both tokenized to ``max_txt_len`` (pad -> -100 in the labels).

    samples: [{"image": HWC float array, "answer": caption str}], or the
    raw-bytes path's [{"jpg_bytes": JPEG bytes, "answer": str,
    "image_size": int}], whose images are decoded, resized and normalized
    (CLIP mean and std) as one batch in C++ (``data/native.py``). Without
    ``seed`` the splits draw from the module-level ``random`` (as the JAX
    collator does: its builder passes no seed)."""

    def __init__(self, t5_tokenizer, max_txt_len: int = 128,
                 use_biased_split: bool = False, seed: Optional[int] = None):
        self.tok = t5_tokenizer
        self.max_txt_len = max_txt_len
        self.split_fn = (biased_random_split_string if use_biased_split
                         else random_split_string)
        self.rng = random.Random(seed) if seed is not None else None

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        if "jpg_bytes" in samples[0]:
            from thinkdiff_torch.data.native import (
                decode_resize_normalize_batch)
            from thinkdiff_torch.data.processors import CLIP_MEAN, CLIP_STD

            images = decode_resize_normalize_batch(
                [s["jpg_bytes"] for s in samples],
                samples[0].get("image_size", 224), CLIP_MEAN, CLIP_STD)
        else:
            images = np.stack([np.asarray(s["image"], np.float32)
                               for s in samples])
        firsts, seconds = [], []
        for s in samples:
            a, b = self.split_fn(s["answer"], rng=self.rng)
            firsts.append(a)
            seconds.append(b)
        input_ids, input_mask = tokenize_batch(self.tok, firsts,
                                               self.max_txt_len)
        out_ids, out_mask = tokenize_batch(self.tok, seconds, self.max_txt_len)
        return {"pixel_values": images, "input_ids": input_ids,
                "input_mask": input_mask,
                "labels": labels_from_ids(out_ids, out_mask)}


def _f32(e) -> np.ndarray:
    """An embedding field (torch tensor of any float dtype, or an array)
    as f32 numpy, converted with torch."""
    return torch.as_tensor(e).float().numpy()


class EmbedShardCollator:
    """LVLM aligner batches from precomputed embedding shards.

    samples: webdataset dicts with ``{layer}.output_embed.pth`` /
    ``{layer}.input_embed.pth`` (S, Dv) tensors and a json with
    ``output_token_ids`` and ``generated_text``.

    Modes:
      - input-embed: truncate/pad to ``input_embed_max_len`` + mask;
      - output-embed, random split: a random prefix (1..max_split_len) of the
        generated tokens' embeds is the condition and the text of the
        remaining token ids (``vlm_decode_fn``) the target; padded, or
        bucketed (``bucket_lengths``), or packed into rows of ``pack_cap``
        tokens with segment ids (``data/packing.py``);
      - output-embed plain: truncate/pad the embeds, ids clipped to match.
    """

    def __init__(self, t5_tokenizer, vlm_decode_fn: Callable[[List[int]], str],
                 use_input_embed: bool = False, use_output_embed: bool = True,
                 random_split_output_embed: bool = True,
                 input_embed_max_len: int = 576,
                 output_embed_max_len: int = 256,
                 output_embed_max_split_len: int = 128,
                 max_txt_len: int = 128,
                 t5_add_special_tokens_prob: Optional[float] = None,
                 generated_text_key: str = "generated_text",
                 bucket_lengths: bool = False,
                 pack_cap: Optional[int] = None,
                 pack_row_bucket: int = 2,
                 seed: Optional[int] = None):
        self.tok = t5_tokenizer
        self.vlm_decode = vlm_decode_fn
        self.generated_text_key = generated_text_key
        self.use_input_embed = use_input_embed
        self.use_output_embed = use_output_embed
        self.random_split = random_split_output_embed
        self.input_embed_max_len = input_embed_max_len
        self.output_embed_max_len = output_embed_max_len
        self.max_split_len = output_embed_max_split_len
        self.max_txt_len = max_txt_len
        self.add_special_prob = t5_add_special_tokens_prob
        self.bucket_lengths = bucket_lengths
        self.pack_cap = pack_cap
        self.pack_row_bucket = pack_row_bucket
        self.rng = random.Random(seed)

    @staticmethod
    def assign_split(sample: Dict[str, Any], rng: random.Random,
                     max_split_len: int = 128,
                     max_txt_len: int = 128) -> Dict[str, Any]:
        """Pre-batching split (a pipeline map function): draws the random
        prefix split from the collator's distribution, stores it as
        ``__presplit__`` and a sort key ``(bucket(label length), split)`` as
        ``__sortkey__``, so a sorted window batches samples whose padded
        shapes coincide on both axes."""
        for key in sample:
            if "output_embed" in key:
                n = int(sample[key].shape[0])
                break
        else:
            return sample
        split = rng.randint(1, max(1, min(n - 1, max_split_len)))
        label_est = max(1, n - split)
        sample["__presplit__"] = split
        sample["__sortkey__"] = (bucket_length(label_est, max_txt_len), split)
        return sample

    @staticmethod
    def _find_embed(sample: Dict[str, Any], kind: str) -> np.ndarray:
        for key in sample:
            if kind in key:
                return _f32(sample[key])
        raise KeyError(f"no '{kind}' field in sample {list(sample)}")

    @staticmethod
    def _pad_embeds(embeds: List[np.ndarray], max_len: int):
        d = embeds[0].shape[-1]
        out = np.zeros((len(embeds), max_len, d), np.float32)
        mask = np.zeros((len(embeds), max_len), np.int32)
        for i, e in enumerate(embeds):
            n = min(e.shape[0], max_len)
            out[i, :n] = e[:n]
            mask[i, :n] = 1
        return out, mask

    def _add_special(self) -> bool:
        if self.add_special_prob is None:
            return True
        return self.rng.random() < self.add_special_prob

    def _tokenize_targets(self, texts: List[str]) -> np.ndarray:
        add_special = self._add_special()
        width = self.max_txt_len
        if self.bucket_lengths:
            lens = [len(self.tok.encode(t, add_special_tokens=add_special))
                    for t in texts]
            width = bucket_length(max(lens) if lens else 1, self.max_txt_len)
        ids, mask = tokenize_batch(self.tok, texts, width, add_special)
        return labels_from_ids(ids, mask)

    def _split(self, sample: Dict[str, Any], n: int) -> int:
        """The sample's prefix length: the pipeline's ``__presplit__`` or a
        fresh draw, clamped to [1, min(n - 1, max_split_len)]."""
        hi = max(1, min(n - 1, self.max_split_len))
        return min(sample.get("__presplit__") or self.rng.randint(1, hi), hi)

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        if self.use_input_embed:
            inp = [self._find_embed(s, "input_embed") for s in samples]
            embeds, mask = self._pad_embeds(inp, self.input_embed_max_len)
            batch["input_embeds"] = embeds
            batch["input_embed_mask"] = mask

        if self.use_output_embed:
            outs = [self._find_embed(s, "output_embed") for s in samples]
            token_ids = [list(s["json"]["output_token_ids"]) for s in samples]
            if self.pack_cap and self.random_split:
                return self._collate_packed(samples, outs, token_ids)
            if self.random_split:
                parts, texts = [], []
                for s, e, ids in zip(samples, outs, token_ids):
                    split = self._split(s, e.shape[0])
                    parts.append(e[:split])
                    texts.append(self.vlm_decode(ids[split:]))
                width = self.max_split_len
                if self.bucket_lengths:
                    width = bucket_length(max(p.shape[0] for p in parts),
                                          self.max_split_len)
                embeds, mask = self._pad_embeds(parts, width)
            else:
                texts, clipped = [], []
                for e, ids in zip(outs, token_ids):
                    n = min(e.shape[0], self.output_embed_max_len)
                    clipped.append(e[:n])
                    texts.append(self.vlm_decode(ids[:n]))
                embeds, mask = self._pad_embeds(clipped,
                                                self.output_embed_max_len)
            batch["embeds"] = embeds
            batch["embed_mask"] = mask
            batch["labels"] = self._tokenize_targets(texts)
        elif self.use_input_embed:
            batch["embeds"] = batch.pop("input_embeds")
            batch["embed_mask"] = batch.pop("input_embed_mask")
            texts = [s["json"].get(self.generated_text_key, "") for s in samples]
            batch["labels"] = self._tokenize_targets(texts)
        return batch

    def _collate_packed(self, samples, outs, token_ids):
        """Random-split samples packed into rows of segment-isolated
        samples instead of one padded sample a row."""
        from thinkdiff_torch.data.packing import pack_rows

        add_special = self._add_special()
        items = []
        for s, e, ids in zip(samples, outs, token_ids):
            split = self._split(s, e.shape[0])
            text = self.vlm_decode(ids[split:])
            lab = self.tok.encode(text, add_special_tokens=add_special)
            lab = np.asarray(lab[: self.max_txt_len], np.int32)
            if len(lab) == 0:
                lab = np.asarray(
                    [getattr(self.tok, "eos_token_id", None) or 1], np.int32)
            items.append({"embeds": e[:split], "label_ids": lab})
        cap = int(self.pack_cap)
        assert cap >= self.max_split_len and cap >= self.max_txt_len, (
            "pack_cap must hold the largest single sample")
        return pack_rows(items, enc_cap=cap, dec_cap=cap,
                         row_bucket=self.pack_row_bucket)


class WidsProcessCollator:
    """Embedding-precompute batches: images (PIL, through the optional
    processor) and a random caption instruction each, with the samples'
    json and keys."""

    def __init__(self, vis_processor=None, seed: Optional[int] = None):
        self.vis_processor = vis_processor
        self.rng = random.Random(seed)

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        images, answers, jsons, filenames = [], [], [], []
        for s in samples:
            img = s.get("jpg") or s.get("png") or s.get("image")
            if self.vis_processor is not None:
                img = self.vis_processor(img)
            images.append(img)
            answers.append(self.rng.choice(LLAVA_BRIEF_INSTRUCTIONS))
            jsons.append(s.get("json", {}))
            filenames.append(s.get("__key__", ""))
        return {"images": images, "answers": answers,
                "jsons": jsons, "filenames": filenames}
