"""Streaming WebDataset pipeline and loaders (the port's copy of
thinkdiff_tpu/data/pipeline.py).

shards -> samples -> shuffle buffer -> map -> batches, with the JAX
package's draws from ``random.Random`` in the same order, so one seed gives
the same batches in both packages. JPEG decode and sample reads run in a
small thread pool (PIL releases the GIL while it decodes), and
``PrefetchLoader`` collates ahead of the step on a background thread.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from thinkdiff_torch.data.tario import brace_expand, tar_sample_iterator


class WebDatasetPipeline:
    """shards -> samples -> shuffle buffer -> map -> batches (collated)."""

    def __init__(
        self,
        urls: Any,
        *,
        resample: bool = True,
        shuffle_buffer: int = 1000,
        decode: bool = True,
        map_fns: Sequence[Callable] = (),
        batch_size: Optional[int] = None,
        collator: Optional[Callable] = None,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        token_budget: Optional[int] = None,
        sample_len_fn: Optional[Callable[[Dict[str, Any]], int]] = None,
        budget_len_cap: int = 128,
        budget_window: int = 256,
        min_batch: int = 8,
        sort_window: int = 0,
        sample_sort_fn: Optional[Callable[[Dict[str, Any]], Any]] = None,
    ):
        if isinstance(urls, str):
            urls = brace_expand(urls)
        self.urls = list(urls)
        self.resample = resample
        self.shuffle_buffer = shuffle_buffer
        self.decode = decode
        self.map_fns = list(map_fns)
        self.batch_size = batch_size
        self.collator = collator
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.token_budget = token_budget
        self.sample_len_fn = sample_len_fn
        self.budget_len_cap = budget_len_cap
        self.budget_window = budget_window
        # min_batch may not exceed batch_size: otherwise the candidate
        # range in _budget_batch_iter is empty and every batch silently
        # lands at min_batch, exceeding both the configured batch size
        # and (potentially) the token budget.
        self.min_batch = min(min_batch, batch_size) if batch_size else min_batch
        # fixed-batch length grouping: hold ``sort_window`` samples, sort by
        # ``sample_sort_fn`` (or sample_len_fn), cut batches, shuffle batch
        # order. Same-bucket samples batch together so padded shapes shrink
        # (the static-shape analog of length-grouped batching; two-level
        # keys — see EmbedShardCollator.assign_split — also align the
        # label axis).
        self.sort_window = sort_window
        self.sample_sort_fn = sample_sort_fn

    def _shard_iter(self, rng: random.Random) -> Iterator[str]:
        if self.resample:
            while True:
                yield rng.choice(self.urls)
        else:
            shards = [u for i, u in enumerate(self.urls)
                      if i % self.world_size == self.rank]
            rng.shuffle(shards)
            yield from shards

    def _sample_iter(self) -> Iterator[Dict[str, Any]]:
        rng = random.Random(self.seed + self.rank)
        buf: List[Dict[str, Any]] = []
        for shard in self._shard_iter(rng):
            try:
                samples = tar_sample_iterator(shard, decode=self.decode)
                for sample in samples:
                    for fn in self.map_fns:
                        sample = fn(sample)
                        if sample is None:
                            break
                    if sample is None:
                        continue
                    if self.shuffle_buffer > 1:
                        buf.append(sample)
                        if len(buf) >= self.shuffle_buffer:
                            idx = rng.randrange(len(buf))
                            buf[idx], buf[-1] = buf[-1], buf[idx]
                            yield buf.pop()
                    else:
                        yield sample
            except FileNotFoundError:
                continue
        rng.shuffle(buf)
        yield from buf

    def __iter__(self):
        it = self._sample_iter()
        if self.batch_size is None:
            return it
        if self.token_budget is not None:
            return self._budget_batch_iter(it)
        if self.sort_window and self.sort_window > self.batch_size:
            return self._sorted_batch_iter(it)
        return self._batch_iter(it)

    def _batch_iter(self, it) -> Iterator[Any]:
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if len(batch) < self.batch_size:
                return
            yield self.collator(batch) if self.collator else batch

    def _sorted_batch_iter(self, it) -> Iterator[Any]:
        """Fixed batch size, but batches are cut from a ``sort_window``
        window sorted by ``sample_sort_fn`` (falling back to
        sample_len_fn), then emitted in shuffled order — same samples,
        tighter padded shapes, no length curriculum."""
        key = self.sample_sort_fn or self.sample_len_fn
        assert key is not None, "sort_window requires a sort key fn"
        rng = random.Random(self.seed + self.rank + 17)
        leftover: List[Any] = []
        while True:
            window = leftover + list(
                itertools.islice(it, self.sort_window - len(leftover)))
            if len(window) < self.batch_size:
                return
            window.sort(key=key)
            n_full = len(window) // self.batch_size
            batches = [window[i * self.batch_size:(i + 1) * self.batch_size]
                       for i in range(n_full)]
            leftover = window[n_full * self.batch_size:]
            rng.shuffle(batches)
            for batch in batches:
                yield self.collator(batch) if self.collator else batch

    def _budget_batch_iter(self, it) -> Iterator[Any]:
        """Token-budget batching: batch size scales inversely with the
        length bucket so every batch carries ~token_budget padded tokens.

        This is the static-shape analog of the reference's dynamic
        ``padding='longest'`` batches (mllama_vllm_t5_embed_decoder_2.py:570
        keeps batch fixed and lets the token count float; here the token
        count is pinned — which bounds a step's memory — and the
        batch floats in multiples of 8). Short-sample batches grow up to
        ``batch_size``, long ones shrink to ``min_batch``; a window of
        ``budget_window`` samples is length-sorted before cutting so
        same-bucket samples batch together, then batch order is shuffled to
        avoid a length curriculum."""
        from thinkdiff_torch.data.collators import bucket_length

        assert self.sample_len_fn is not None, \
            "token_budget requires sample_len_fn"
        rng = random.Random(self.seed + self.rank + 1)
        max_batch = self.batch_size or 32
        leftover: List[Any] = []
        while True:
            window = leftover + list(
                itertools.islice(it, self.budget_window - len(leftover)))
            if len(window) < self.min_batch:
                return
            window.sort(key=self.sample_sort_fn or self.sample_len_fn)
            batches = []
            i = 0
            while i + self.min_batch <= len(window):
                bs = self.min_batch
                for cand in range(max_batch, self.min_batch - 1, -8):
                    if i + cand > len(window):
                        continue
                    cost = bucket_length(
                        self.sample_len_fn(window[i + cand - 1]),
                        self.budget_len_cap)
                    if cand * cost <= self.token_budget:
                        bs = cand
                        break
                batches.append(window[i:i + bs])
                i += bs
            # sub-min_batch tail rolls into the next window (no sample loss
            # on the streaming path)
            leftover = window[i:]
            rng.shuffle(batches)
            for batch in batches:
                yield self.collator(batch) if self.collator else batch


READ_THREADS = 8  # sample reads and JPEG decodes of a MapDatasetLoader


class MapDatasetLoader:
    """Batched loader over a random-access dataset + sampler (the wids
    precompute path — reference runner_process_data.py:86-91); the last
    batch may be short."""

    def __init__(self, dataset, sampler, batch_size: int,
                 collator: Optional[Callable] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collator = collator

    def __len__(self):
        return -(-len(self.sampler) // self.batch_size)

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        indices = list(iter(self.sampler))
        with ThreadPoolExecutor(READ_THREADS) as pool:
            for i in range(0, len(indices), self.batch_size):
                chunk = indices[i: i + self.batch_size]
                samples = list(pool.map(self.dataset.__getitem__, chunk))
                yield self.collator(samples) if self.collator else samples


class IterLoader:
    """Infinite epoch-wrapping iterator (reference dataloader_utils.py:127-162)."""

    def __init__(self, loader):
        self._loader = loader
        self._epoch = 0
        self.iter_loader = iter(self._loader)

    @property
    def epoch(self) -> int:
        return self._epoch

    def __next__(self):
        try:
            return next(self.iter_loader)
        except StopIteration:
            self._epoch += 1
            sampler = getattr(self._loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(self._epoch)
            self.iter_loader = iter(self._loader)
            return next(self.iter_loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._loader)


class MultiIterLoader:
    """Sample from multiple loaders with given ratios
    (reference dataloader_utils.py:15-43)."""

    def __init__(self, loaders: List[Any], ratios: Optional[List[float]] = None,
                 seed: int = 0):
        self.loaders = loaders
        if ratios is None:
            ratios = [1.0] * len(loaders)
        total = sum(ratios)
        self.ratios = [r / total for r in ratios]
        self.rng = random.Random(seed)

    def __next__(self):
        idx = self.rng.choices(range(len(self.loaders)), weights=self.ratios)[0]
        return next(self.loaders[idx])

    def __iter__(self):
        return self




class PrefetchLoader:
    """Collates batches ``depth`` ahead of the consumer on a background
    thread. It yields host batches: the task moves each to the device."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # the consumer stopped (an epoch's iterations are done): the
            # thread leaves at its next put, once the batch it is collating
            # is done
            stop.set()
            t.join()
