"""Dataset builders (the port's copy of thinkdiff_tpu/data/builders.py):
ThinkDiff-CLIP's image-caption shards (``cc_sbu``), the precompute's
indexed image shards and ThinkDiff-LVLM's embedding shards.

A builder turns its config section into a ``DatasetBundle`` that the runner
asks for batch loaders. The task injects the tokenizers after the model is
built (tokenization happens in the collators). Loaders yield host
batches; the task moves each to the device.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Callable, Dict, Optional

from thinkdiff_torch.core.config import ConfigNode
from thinkdiff_torch.core.registry import registry
from thinkdiff_torch.data.collators import (
    CaptionSplitCollator, EmbedShardCollator, WidsProcessCollator)
from thinkdiff_torch.data.pipeline import (
    MapDatasetLoader, PrefetchLoader, WebDatasetPipeline)
from thinkdiff_torch.data.processors import build_processor
from thinkdiff_torch.data.wids_reader import ChunkedSampler, ShardListDataset

logger = logging.getLogger(__name__)

# The reference's mllama_generated_text_key names the BATCH key its collater
# emits (reference llava_instruct_dataset_mllama_embed_2.py:168-176); the
# per-sample shard JSON field drops the plural. Translate the two known
# reference values; anything else is taken as a literal JSON field name.
_GENERATED_TEXT_BATCH_KEYS = {
    "generated_texts": "generated_text",
    "revised_generated_texts": "revised_generated_text",
}


class DatasetBundle:
    """One split's data source + collator wiring."""

    def __init__(self, make_loader: Callable[..., Any],
                 set_tokenizers: Optional[Callable] = None,
                 batch_size: Optional[int] = None):
        self._make_loader = make_loader
        self._set_tokenizers = set_tokenizers
        self.batch_size = batch_size

    def set_tokenizers(self, t5_tokenizer=None, vlm_decode_fn=None):
        if self._set_tokenizers:
            self._set_tokenizers(t5_tokenizer, vlm_decode_fn)

    def get_loader(self, batch_size: Optional[int] = None, rank: int = 0,
                   world_size: int = 1, seed: int = 0, epoch: int = 0):
        return self._make_loader(
            batch_size=batch_size or self.batch_size, rank=rank,
            world_size=world_size, seed=seed, epoch=epoch,
        )


class BaseDatasetBuilder:
    DEFAULT_CONFIG: Dict[str, Any] = {}

    def __init__(self, cfg: Optional[ConfigNode] = None, model_cfg=None):
        self.config = cfg if cfg is not None else ConfigNode()
        self.model_cfg = model_cfg if model_cfg is not None else {}

    def knob(self, name: str, default=None):
        """Behavior knob lookup: dataset section first, then the model
        section. The reference declares collation-affecting knobs
        (max_txt_len, use_biased_random_split,
        t5_tokenizer_add_special_tokens_prob, mllama_generated_text_key, ...)
        on the MODEL config (reference train_thinkdiff_lvlm_ccsbu.yaml:10-19,
        mllama_vllm_t5_embed_decoder_2.py:310-357) and applies them inside
        model.forward; here collation is loader-side, so builders must see
        the model section for reference YAMLs to behave identically."""
        v = self.config.get(name, None)
        if v is None:
            v = self.model_cfg.get(name, None) if self.model_cfg else None
        return default if v is None else v

    def build_datasets(self) -> Dict[str, DatasetBundle]:
        return {"train": self.build()}

    def build(self) -> DatasetBundle:
        raise NotImplementedError

    def _vis_processor(self, split: str = "train"):
        cfgs = self.config.get("vis_processor", {}) or {}
        vp_cfg = cfgs.get(split) or cfgs.get("eval")  # eval-only sections
        return build_processor(vp_cfg) if vp_cfg else None

    def _text_processor(self, split: str = "train"):
        cfgs = self.config.get("text_processor", {}) or {}
        tp_cfg = cfgs.get(split) or cfgs.get("eval")
        return build_processor(tp_cfg) if tp_cfg else None


class DatasetZoo:
    """The registered builder names (reference
    datasets/builders/__init__.py:24-73)."""

    def __init__(self):
        self.dataset_zoo = {name: [name]
                            for name in sorted(registry.mapping["builder"])}

    def __len__(self):
        return len(self.dataset_zoo)

    def get_names(self):
        return list(self.dataset_zoo.keys())


def load_dataset(name: str, cfg=None) -> Dict[str, DatasetBundle]:
    """Build a dataset by its builder's registered name (reference
    builders/__init__.py ``load_dataset``)."""
    builder_cls = registry.get_builder_class(name)
    if builder_cls is None:
        raise KeyError(f"Unknown dataset builder '{name}'")
    return builder_cls(cfg if cfg is not None else ConfigNode()
                       ).build_datasets()


@registry.register_builder("cc_sbu")
class CCSBUBuilder(BaseDatasetBuilder):
    """Image-caption tar shards -> caption-split batches
    (reference image_text_pair_builder.py:12-41, cc_sbu_dataset.py:11-25).

    Two paths, chosen as the JAX builder chooses them. With
    ``use_native_decode`` (default true) and the native IO library built
    (``data/native.py``), the pipeline leaves samples undecoded: a sample
    keeps its JPEG bytes and its caption parsed from the JSON bytes, and
    the collator decodes, resizes and normalizes the batch in C++ (the
    whole image to the vision processor's size: no crop or flip). Without
    either, the pipeline decodes each image (PIL), the vision processor
    resizes and normalizes it, and the text processor cleans the caption
    on both paths. The path taken is logged once a loader."""

    DEFAULT_CONFIG = {
        "vis_processor": {"train": {"name": "blip2_image_train",
                                    "image_size": 224}},
        "text_processor": {"train": {"name": "blip_caption"}},
    }

    def build(self) -> DatasetBundle:
        import json

        from thinkdiff_torch.data import native

        cfg = self.config
        storage = cfg.build_info.storage
        vis_proc = self._vis_processor()
        text_proc = self._text_processor()
        state: Dict[str, Any] = {"t5_tok": None}
        want_native = bool(cfg.get("use_native_decode", True))
        use_native = want_native and native.available()
        image_size = int(getattr(vis_proc, "image_size", 224) or 224)

        def map_fn(sample):
            """The decoded-sample path."""
            img = sample.get("jpg") or sample.get("png")
            if img is None or "json" not in sample:
                return None
            caption = sample["json"].get("caption", "")
            if text_proc:
                caption = text_proc(caption)
            return {"image": vis_proc(img) if vis_proc else img,
                    "answer": caption}

        def map_fn_raw(sample):
            """The raw-bytes path: the batch is decoded in C++."""
            img = sample.get("jpg") or sample.get("png")
            if img is None or "json" not in sample:
                return None
            caption = json.loads(sample["json"]).get("caption", "")
            if text_proc:
                caption = text_proc(caption)
            return {"jpg_bytes": img, "answer": caption,
                    "image_size": image_size}

        def make_loader(batch_size, rank, world_size, seed, epoch):
            assert state["t5_tok"] is not None, "tokenizer not injected"
            if use_native:
                logger.info("cc_sbu: native JPEG decode (C++ batch decode "
                            "to %d px)", image_size)
            else:
                logger.info("cc_sbu: decoded-sample path (PIL), %s",
                            "use_native_decode is off" if not want_native
                            else "native IO unavailable: "
                            f"{native.unavailable_reason()}")
            collator = CaptionSplitCollator(
                state["t5_tok"],
                max_txt_len=int(self.knob("max_txt_len", 128)),
                use_biased_split=bool(self.knob("use_biased_random_split",
                                                False)))
            # resample=False -> one finite pass (eval sections set this)
            resample = bool(cfg.get("resample", True))
            pipe = WebDatasetPipeline(
                storage, resample=resample,
                shuffle_buffer=1000 if resample else 0,
                decode=not use_native,
                map_fns=[map_fn_raw if use_native else map_fn],
                batch_size=batch_size, collator=collator,
                seed=seed + epoch, rank=rank, world_size=world_size)
            return PrefetchLoader(pipe)

        def set_tok(t5_tok, vlm_decode):
            state["t5_tok"] = t5_tok

        return DatasetBundle(make_loader, set_tokenizers=set_tok,
                             batch_size=cfg.get("batch_size"))


@registry.register_builder("cc_sbu_mllama_vllm_process_wids")
class CCSBUWidsProcessBuilder(BaseDatasetBuilder):
    """Indexed shards for embedding precompute
    (reference image_text_pair_builder.py:76-107)."""

    def build(self) -> DatasetBundle:
        cfg = self.config
        index_path = cfg.build_info.storage
        vis_proc = self._vis_processor()

        def make_loader(batch_size, rank, world_size, seed, epoch):
            dataset = ShardListDataset(index_path, decode=True)
            sampler = ChunkedSampler(
                len(dataset), chunksize=1000, shuffle=True, seed=seed,
                rank=rank, world_size=world_size,
            )
            sampler.set_epoch(epoch)
            collator = WidsProcessCollator(vis_proc, seed=seed)
            return MapDatasetLoader(dataset, sampler, batch_size, collator)

        return DatasetBundle(make_loader,
                             batch_size=cfg.get("batch_size"))


@registry.register_builder("llava_instruct_mllama_embed_2")
class LlavaInstructEmbedBuilder(BaseDatasetBuilder):
    """Precomputed-embedding shards -> LVLM aligner batches
    (reference image_text_pair_builder.py:111-143)."""

    def build(self) -> DatasetBundle:
        cfg = self.config
        build_info = cfg.build_info
        storage = build_info.storage
        state: Dict[str, Any] = {"t5_tok": None, "vlm_decode": None}

        def make_loader(batch_size, rank, world_size, seed, epoch):
            assert state["t5_tok"] is not None, "tokenizers not injected"
            collator = EmbedShardCollator(
                state["t5_tok"], state["vlm_decode"],
                use_input_embed=bool(build_info.get("use_input_embed", False)),
                use_output_embed=bool(build_info.get("use_output_embed", True)),
                random_split_output_embed=bool(
                    build_info.get("random_split_output_embed", True)),
                input_embed_max_len=int(build_info.get("input_embed_max_len", 576)),
                output_embed_max_len=int(build_info.get("output_embed_max_len", 256)),
                output_embed_max_split_len=int(
                    build_info.get(
                        "output_embed_max_split_len",
                        self.knob("max_split_len", 128) or 128)),
                max_txt_len=int(self.knob("max_txt_len", 128)),
                t5_add_special_tokens_prob=self.knob(
                    "t5_tokenizer_add_special_tokens_prob", None),
                bucket_lengths=bool(build_info.get("bucket_lengths", False)),
                # pack: <row tokens> enables segment-id sequence packing
                # (data/packing.py) — batch_size then counts SAMPLES fed to
                # the packer per emitted batch; rows are derived
                pack_cap=(int(build_info["pack"])
                          if build_info.get("pack") else None),
                pack_row_bucket=int(build_info.get("pack_row_bucket", 2)),
                generated_text_key=_GENERATED_TEXT_BATCH_KEYS.get(
                    self.knob("mllama_generated_text_key", "generated_texts"),
                    self.knob("mllama_generated_text_key", "generated_text"),
                ),
                seed=seed,
            )
            resample = bool(cfg.get("resample", True))
            # token_budget: batch size floats inversely with the length
            # bucket (static-shape analog of the reference's
            # padding='longest' dynamic batches) — bounds step memory by
            # padded tokens instead of sample count
            budget = build_info.get("token_budget", None)
            budget_kw = {}
            if budget:
                max_split = int(build_info.get(
                    "output_embed_max_split_len",
                    self.knob("max_split_len", 128) or 128))
                max_txt = int(self.knob("max_txt_len", 128))

                def embed_len(sample):
                    # max over ALL embed fields: a sample carrying both
                    # input and output embeds of different lengths must be
                    # costed by the longer one, or batches can exceed the
                    # intended padded-token budget.
                    lens = [int(sample[key].shape[0])
                            for key in sample
                            if "output_embed" in key or "input_embed" in key]
                    return max(lens) if lens else max(max_split, max_txt)

                budget_kw = dict(
                    token_budget=int(budget), sample_len_fn=embed_len,
                    budget_len_cap=max(max_split, max_txt),
                )
            sort_kw = {}
            if (bool(build_info.get("bucket_lengths", False))
                    and bool(build_info.get("use_output_embed", True))
                    and bool(build_info.get("random_split_output_embed", True))):
                # Two-level length grouping: draw the random prefix split
                # BEFORE batch cutting (same distribution the collator
                # uses), then sort the window by (label bucket, split) so
                # batches coincide on BOTH padded axes. Cuts padded-token
                # cost ~2.37x -> ~1.71x of ideal at the CC-SBU length
                # mixture (see EmbedShardCollator.assign_split).
                max_split = int(build_info.get(
                    "output_embed_max_split_len",
                    self.knob("max_split_len", 128) or 128))
                max_txt = int(self.knob("max_txt_len", 128))
                split_rng = random.Random(seed + rank + 23)
                sort_kw = dict(
                    map_fns=[lambda s: EmbedShardCollator.assign_split(
                        s, split_rng, max_split, max_txt)],
                    sample_sort_fn=lambda s: s.get(
                        "__sortkey__", (max_txt, 0)),
                    sort_window=int(build_info.get("sort_window", 256)),
                )
            pipe = WebDatasetPipeline(
                storage, resample=resample,
                shuffle_buffer=1000 if resample else 0,
                batch_size=batch_size, collator=collator,
                seed=seed + epoch, rank=rank, world_size=world_size,
                **budget_kw, **sort_kw,
            )
            return PrefetchLoader(pipe)

        def set_tok(t5_tok, vlm_decode):
            state["t5_tok"] = t5_tok
            state["vlm_decode"] = vlm_decode

        return DatasetBundle(make_loader,
                             set_tokenizers=set_tok,
                             batch_size=cfg.get("batch_size"))
