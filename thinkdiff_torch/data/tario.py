"""WebDataset tar shard IO (the port's copy of thinkdiff_tpu/data/tario.py).

A sample is the run of consecutive tar members that share a key (the
basename up to its first dot); each member's extension names its field.
``.pth`` fields are ``torch.save`` buffers and stay torch tensors here,
bf16 included: they decode with ``torch.load`` and encode with
``torch.save`` of a compact copy (a view would carry its whole storage).
"""

from __future__ import annotations

import io
import json
import os
import re
import tarfile
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple


def brace_expand(pattern: str) -> List[str]:
    """Expand ``{000000..000048}``-style numeric braces."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(brace_expand(pattern[: m.start()] + str(i).zfill(len(lo))
                                + pattern[m.end():]))
    return out


def split_key_ext(name: str) -> Tuple[str, str]:
    """key = the basename up to its FIRST dot; the rest is the (possibly
    dotted) extension, e.g. ``abc.model.norm.output_embed.pth``."""
    base = name.split("/")[-1]
    if "." not in base:
        return base, ""
    key, ext = base.split(".", 1)
    return key, ext


def tar_sample_iterator(path: str, decode: bool = False
                        ) -> Iterator[Dict[str, Any]]:
    """Samples of one tar shard, streamed: {"__key__": key, ext: bytes or
    the decoded field}."""
    with tarfile.open(path, "r|*") as tf:
        current_key: Optional[str] = None
        sample: Dict[str, Any] = {}
        for member in tf:
            if not member.isfile():
                continue
            key, ext = split_key_ext(member.name)
            if current_key is not None and key != current_key:
                yield sample
                sample = {}
            current_key = key
            sample["__key__"] = key
            data = tf.extractfile(member).read()
            sample[ext] = decode_field(ext, data) if decode else data
        if sample:
            yield sample


def decode_field(ext: str, data: bytes) -> Any:
    """Decode by the last extension: images to RGB PIL, json, text, pth/pt
    with ``torch.load`` (tensors keep their dtype); other fields stay
    bytes."""
    last = ext.split(".")[-1]
    if last in ("jpg", "jpeg", "png", "webp"):
        from PIL import Image

        return Image.open(io.BytesIO(data)).convert("RGB")
    if last == "json":
        return json.loads(data)
    if last in ("txt", "text"):
        return data.decode("utf-8")
    if last in ("pth", "pt"):
        import torch

        return torch.load(io.BytesIO(data), map_location="cpu",
                          weights_only=True)
    return data


def encode_field(ext: str, value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    last = ext.split(".")[-1]
    if last == "json":
        return json.dumps(value).encode("utf-8")
    if last in ("txt", "text"):
        return str(value).encode("utf-8")
    if last in ("pth", "pt"):
        import torch

        if isinstance(value, torch.Tensor):
            # clone: a compact copy, so a slice of a larger buffer does not
            # write that buffer's whole storage
            tensor = value.detach().cpu().clone()
        else:
            tensor = torch.as_tensor(value)
        buf = io.BytesIO()
        torch.save(tensor, buf)
        return buf.getvalue()
    if last in ("jpg", "jpeg", "png", "webp"):
        from PIL import Image

        if isinstance(value, Image.Image):
            buf = io.BytesIO()
            value.save(buf, format="JPEG" if last in ("jpg", "jpeg")
                       else last.upper())
            return buf.getvalue()
    raise TypeError(f"Cannot encode field .{ext} from {type(value)}")


class ShardWriter:
    """Rolling tar shard writer with webdataset's ``ShardWriter`` surface:
    a new shard starts when the current one holds ``maxsize`` payload bytes
    or ``maxcount`` samples."""

    def __init__(self, pattern: str, maxsize: float = 5e8,
                 maxcount: int = 100000, start_shard: int = 0):
        self.pattern = pattern
        self.maxsize = maxsize
        self.maxcount = maxcount
        self.shard = start_shard
        self.tar: Optional[tarfile.TarFile] = None
        self.count = 0
        self.size = 0
        self.total = 0
        self.fname: Optional[str] = None

    def _next_stream(self):
        self.close_current()
        self.fname = self.pattern % self.shard
        os.makedirs(os.path.dirname(os.path.abspath(self.fname)), exist_ok=True)
        self.tar = tarfile.open(self.fname, "w")
        self.shard += 1
        self.count = 0
        self.size = 0

    def write(self, sample: Dict[str, Any]):
        if (self.tar is None or self.size >= self.maxsize
                or self.count >= self.maxcount):
            self._next_stream()
        key = sample["__key__"]
        stamp = time.time()
        for ext, value in sample.items():
            if ext == "__key__":
                continue
            data = encode_field(ext, value)
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            info.mtime = stamp
            self.tar.addfile(info, io.BytesIO(data))
            self.size += len(data)
        self.count += 1
        self.total += 1

    def close_current(self):
        if self.tar is not None:
            self.tar.close()
            self.tar = None

    def close(self):
        self.close_current()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def build_tar_index(path: str,
                    items_per_sample: Optional[int] = None) -> Dict[str, Any]:
    """{"url": path, "nsamples": n}: the distinct keys of the tar, or with
    ``items_per_sample`` its files divided by it (the reference's count)."""
    keys = set()
    nfiles = 0
    with tarfile.open(path, "r|*") as tf:
        for member in tf:
            if member.isfile():
                nfiles += 1
                keys.add(split_key_ext(member.name)[0])
    n = nfiles // items_per_sample if items_per_sample else len(keys)
    return {"url": path, "nsamples": n}


def write_wids_index(shards: Iterable[str], out_path: str,
                     name: str = "dataset") -> Dict[str, Any]:
    """A wids-shard-index-v1 JSON over ``shards``."""
    index = {
        "__kind__": "wids-shard-index-v1",
        "wids_version": 1,
        "name": name,
        "shardlist": [build_tar_index(s) for s in shards],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(index, f, indent=4)
    return index
