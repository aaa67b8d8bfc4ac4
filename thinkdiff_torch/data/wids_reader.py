"""Random-access shard dataset and chunked sampler (the port's copy of
thinkdiff_tpu/data/wids_reader.py, the wids replacement).

Each tar's member offsets are scanned once, on first use: by the native
C++ indexer when the library is available (``data/native.py``), with
Python's ``tarfile`` otherwise; a sample is then read by ``pread`` of its
members (native) or by seeking to them.
"""

from __future__ import annotations

import json
import random
import tarfile
from bisect import bisect_right
from typing import Any, Dict, Iterator, List

from thinkdiff_torch.data import native
from thinkdiff_torch.data.tario import decode_field, split_key_ext


class _ShardIndex:
    """One shard's samples: [(key, ext, data offset, size)] each."""

    def __init__(self, path: str):
        self.path = path
        self.samples: List[List[tuple]] = []
        self._native = (native.NativeTarIndex(path) if native.available()
                        else None)
        if self._native is not None:
            members = self._native.members
        else:
            with tarfile.open(path, "r") as tf:
                members = [(m.name, m.offset_data, m.size)
                           for m in tf.getmembers() if m.isfile()]
        order: Dict[str, int] = {}
        for name, offset, size in members:
            key, ext = split_key_ext(name)
            if key not in order:
                order[key] = len(self.samples)
                self.samples.append([])
            self.samples[order[key]].append((key, ext, offset, size))

    def read(self, idx: int, decode: bool = True) -> Dict[str, Any]:
        sample: Dict[str, Any] = {}
        if self._native is not None:
            for key, ext, offset, size in self.samples[idx]:
                data = self._native.read(offset, size)
                sample["__key__"] = key
                sample[ext] = decode_field(ext, data) if decode else data
            return sample
        with open(self.path, "rb") as f:
            for key, ext, offset, size in self.samples[idx]:
                f.seek(offset)
                data = f.read(size)
                sample["__key__"] = key
                sample[ext] = decode_field(ext, data) if decode else data
        return sample

    def __len__(self):
        return len(self.samples)


class ShardListDataset:
    """Random-access dataset over a wids-shard-index-v1 JSON (a path or the
    loaded dict) or a list of shard paths."""

    def __init__(self, index: Any, decode: bool = True, transform=None):
        if isinstance(index, str):
            with open(index) as f:
                index = json.load(f)
        if isinstance(index, dict):
            shardlist = index["shardlist"]
        else:
            shardlist = [{"url": u, "nsamples": None} for u in index]
        self.shard_paths = [s["url"] for s in shardlist]
        self.decode = decode
        self.transform = transform
        self._indices: Dict[int, _ShardIndex] = {}
        self.cumulative = []
        total = 0
        for i, s in enumerate(shardlist):
            n = s.get("nsamples")
            total += len(self._shard(i)) if n is None else n
            self.cumulative.append(total)
        self.total = total

    def _shard(self, i: int) -> _ShardIndex:
        if i not in self._indices:
            self._indices[i] = _ShardIndex(self.shard_paths[i])
        return self._indices[i]

    def __len__(self):
        return self.total

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx < 0:
            idx += self.total
        shard_i = bisect_right(self.cumulative, idx)
        prev = self.cumulative[shard_i - 1] if shard_i > 0 else 0
        sample = self._shard(shard_i).read(idx - prev, decode=self.decode)
        if self.transform:
            sample = self.transform(sample)
        return sample


class ChunkedSampler:
    """Shuffle in contiguous chunks: the chunk order is shuffled, then the
    indices within each chunk, from ``random.Random(seed + epoch)`` in the
    JAX package's order; indices are dealt round-robin across ranks."""

    def __init__(self, dataset_len: int, chunksize: int = 1000,
                 shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.n = dataset_len
        self.chunksize = chunksize
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed + self.epoch)
        chunks = [list(range(i, min(i + self.chunksize, self.n)))
                  for i in range(0, self.n, self.chunksize)]
        if self.shuffle:
            rng.shuffle(chunks)
            for c in chunks:
                rng.shuffle(c)
        for ci, c in enumerate(chunks):
            for j, idx in enumerate(c):
                if (ci * self.chunksize + j) % self.world_size == self.rank:
                    yield idx

    def __len__(self):
        return self.n // self.world_size
