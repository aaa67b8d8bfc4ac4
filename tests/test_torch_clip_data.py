"""Port parity: ThinkDiff-CLIP's data layer against the JAX package on the
CPU: the BLIP image and caption processors under their five registry names,
the caption splits, ``CaptionSplitCollator`` and the ``cc_sbu`` builder's
batches on seeded image-caption tar shards (JAX's decoded-sample path,
``use_native_decode: False``, with Python's ``random`` seeded alike)."""

import random

import numpy as np
import pytest
from PIL import Image

from thinkdiff_torch.core.config import ConfigNode as TConfigNode
from thinkdiff_torch.core.registry import registry as treg
from thinkdiff_torch.data import builders as tb
from thinkdiff_torch.data import collators as tcol
from thinkdiff_torch.data import processors as tp
from thinkdiff_torch.data.tario import ShardWriter
from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
from thinkdiff_tpu.core.config import ConfigNode as JConfigNode
from thinkdiff_tpu.core.registry import registry as jreg
from thinkdiff_tpu.data import builders as jb
from thinkdiff_tpu.data import collators as jcol
from thinkdiff_tpu.data import processors as jp

CAPTIONS = [
    "A Dog, running on the beach!!  (sunset)",
    "two cats; sleeping* on a sofa ~ near #the window: morning",
    "single",
    "",
    "Lorem ipsum dolor sit amet consectetur adipiscing elit sed do eiusmod "
    "tempor incididunt ut labore et dolore magna aliqua ut enim ad minim "
    "veniam quis nostrud exercitation ullamco laboris nisi ut aliquip ex ea "
    "commodo consequat duis aute irure dolor in reprehenderit in voluptate",
]


def t5_tok():
    """flan-t5's id range through the stand-in: pad 0, eos 1, unk 2."""
    return StandInTokenizer({"<pad>": 0, "</s>": 1, "<unk>": 2}, word_lo=3,
                            word_hi=32100, eos_token="</s>")


def _image(seed, h=40, w=30):
    return Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255)
                           .astype("uint8"))


NAMES = ("blip_image_eval", "blip2_image_eval", "blip_image_train",
         "blip2_image_train", "blip_caption")


@pytest.mark.parametrize("name", NAMES)
def test_processors_identical_under_every_name(name):
    cfg = {"name": name, "image_size": 32}
    got = tp.build_processor(cfg)
    want = jp.build_processor(cfg)
    assert type(got).__name__ == type(want).__name__
    assert treg.get_processor_class(name).__name__ == \
        jreg.get_processor_class(name).__name__
    if name == "blip_caption":
        for c in CAPTIONS:
            assert got(c) == want(c)
        prompted = tp.build_processor({"name": name, "prompt": "a photo of ",
                                       "max_words": 5})
        assert prompted(CAPTIONS[4]) == jp.build_processor(
            {"name": name, "prompt": "a photo of ", "max_words": 5})(CAPTIONS[4])
        return
    for img in (_image(0), np.asarray(_image(1, 20, 50)),
                _image(2).convert("L")):
        a, b = got(img), want(img)
        assert a.dtype == b.dtype == np.float32 and a.shape == (32, 32, 3)
        assert np.array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(tp.CLIP_MEAN),
                                  np.asarray(jp.CLIP_MEAN))
    np.testing.assert_array_equal(np.asarray(tp.CLIP_STD),
                                  np.asarray(jp.CLIP_STD))


def test_caption_splits_identical():
    for fn in ("random_split_string", "biased_random_split_string"):
        for seed in range(5):
            a, b = random.Random(seed), random.Random(seed)
            for c in CAPTIONS:
                assert getattr(tcol, fn)(c, rng=a) == getattr(jcol, fn)(c, rng=b)
        # without an rng both draw from the module-level random
        random.seed(3)
        got = [getattr(tcol, fn)(c) for c in CAPTIONS]
        random.seed(3)
        want = [getattr(jcol, fn)(c) for c in CAPTIONS]
        assert got == want


def _samples(n=6, size=16):
    proc = tp.BlipImageEvalProcessor(image_size=size)
    return [{"image": proc(_image(i)), "answer": CAPTIONS[i % len(CAPTIONS)]}
            for i in range(n)]


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("seed", [None, 11])
def test_caption_split_collator_identical(biased, seed):
    samples = _samples()
    kw = dict(max_txt_len=12, use_biased_split=biased, seed=seed)
    random.seed(5)
    got = tcol.CaptionSplitCollator(t5_tok(), **kw)(samples)
    random.seed(5)
    want = jcol.CaptionSplitCollator(t5_tok(), **kw)(samples)
    assert set(got) == set(want) == {"pixel_values", "input_ids",
                                     "input_mask", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pixel_values"].shape == (6, 16, 16, 3)
    assert (got["labels"] == -100).any() and (got["labels"] >= 3).any()


def write_cc_sbu_shards(root, n=24, per_shard=10, size=48, seed=0):
    """Seeded image-caption tar shards in the cc_sbu layout (a JPEG and a
    json with its caption per sample), one sample with no caption file.
    Returns the brace pattern of the shards."""
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    pattern = str(root / "%05d.tar")
    with ShardWriter(pattern, maxcount=per_shard) as w:
        for i in range(n):
            img = Image.fromarray((rs.rand(size, size + 8 * (i % 3), 3) * 255)
                                  .astype("uint8"))
            words = [CAPTIONS[4].split()[j] for j in rs.randint(0, 40, 3 + i % 9)]
            sample = {"__key__": f"{i:06d}", "jpg": img}
            if i != 5:
                sample["json"] = {"caption": " ".join(words).title() + "."}
            w.write(sample)
        shards = w.shard
    return str(root / f"{{00000..{shards - 1:05d}}}.tar")


def _cc_sbu_cfg(storage, node, **kw):
    return node({"batch_size": 4, "max_txt_len": 16,
                 "vis_processor": {"train": {"name": "blip2_image_train",
                                             "image_size": 32}},
                 "text_processor": {"train": {"name": "blip_caption"}},
                 "build_info": {"storage": storage},
                 "use_native_decode": False, **kw})


@pytest.mark.parametrize("resample", [True, False])
def test_cc_sbu_builder_batches_identical(tmp_path, resample):
    """The port's cc_sbu loader and the JAX one (decoded-sample path) give
    the same batches from the same shards and seeds: the shuffle, the
    skipped sample, the processors and the caption splits (module-level
    random, seeded alike before each). The JAX side is read through its
    synchronous pipeline (``.loader``): its ``PrefetchLoader`` has no stop,
    so its thread would go on drawing caption splits from the module-level
    ``random`` after the case, into the next one's draws. The port's
    ``PrefetchLoader`` stays under test and joins its thread on close."""
    storage = write_cc_sbu_shards(tmp_path / "shards")
    batches = {}
    for side, mod, node in (("port", tb, TConfigNode), ("jax", jb, JConfigNode)):
        cfg = _cc_sbu_cfg(storage, node, resample=resample)
        bundle = mod.CCSBUBuilder(cfg, model_cfg={"max_txt_len": 99}) \
            .build_datasets()["train"]
        bundle.set_tokenizers(t5_tok(), None)
        random.seed(9)
        loader = bundle.get_loader(seed=4, epoch=1)
        it = iter(loader if side == "port" else loader.loader)
        batches[side] = [next(it) for _ in range(3 if resample else 2)]
        if hasattr(it, "close"):
            it.close()
    for got, want in zip(batches["port"], batches["jax"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["pixel_values"].shape == (4, 32, 32, 3)
        assert got["input_ids"].shape == (4, 16)


def test_cc_sbu_is_registered_and_needs_its_tokenizer(tmp_path):
    assert treg.get_builder_class("cc_sbu") is tb.CCSBUBuilder
    storage = write_cc_sbu_shards(tmp_path / "shards", n=4)
    bundle = tb.CCSBUBuilder(_cc_sbu_cfg(storage, TConfigNode)) \
        .build_datasets()["train"]
    with pytest.raises(AssertionError, match="tokenizer"):
        bundle.get_loader()
