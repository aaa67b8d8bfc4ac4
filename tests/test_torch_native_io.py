"""Port parity: the port's native IO library (``thinkdiff_torch/data/native.py``
on its own copy of ``thinkdiff_io.cc``) against the JAX package's on the CPU:
the tar member index and ``pread`` against JAX's and ``tarfile``, JPEG decode
and the batched decode + resize + normalize against JAX's library bit for bit
(one source, the same g++ flags, one host) and against the PIL processor
within JAX's bounds, the wids reader's native path against its ``tarfile``
path and JAX's reader, and the ``cc_sbu`` builder's raw-bytes path against
JAX's (both read synchronously, the caption splits seeded alike)."""

import io
import random
import tarfile

import numpy as np
import pytest
from PIL import Image

from thinkdiff_torch.core.config import ConfigNode as TConfigNode
from thinkdiff_torch.data import builders as tb
from thinkdiff_torch.data import collators as tcol
from thinkdiff_torch.data import native as tn
from thinkdiff_torch.data import processors as tp
from thinkdiff_torch.data import wids_reader as tw
from thinkdiff_torch.data.tario import ShardWriter, write_wids_index
from thinkdiff_tpu.core.config import ConfigNode as JConfigNode
from thinkdiff_tpu.data import builders as jb
from thinkdiff_tpu.data import collators as jcol
from thinkdiff_tpu.data import native as jn
from thinkdiff_tpu.data import wids_reader as jw
from tests.test_torch_clip_data import _cc_sbu_cfg, t5_tok, write_cc_sbu_shards


@pytest.fixture(scope="module")
def libs():
    """Both libraries built (g++, jpeglib.h and libjpeg are on this host)."""
    if not tn.available():
        pytest.skip(f"port's native IO unavailable: {tn.unavailable_reason()}")
    if not jn.available():
        pytest.skip("the JAX package's native IO library is unavailable")
    return tn, jn


def _jpeg_bytes(arr, quality=95):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rs = np.random.RandomState(0)
    with ShardWriter(str(tmp / "%06d.tar"), maxcount=100) as w:
        for i in range(7):
            w.write({"__key__": f"{i:04d}",
                     "jpg": Image.fromarray((rs.rand(40, 32, 3) * 255)
                                            .astype("uint8")),
                     "json": {"caption": f"c{i}"}})
    return str(tmp / "000000.tar")


def test_library_is_built_from_the_port_s_own_source(libs):
    path = tn.library_path()
    assert path.exists() and path.parent == tn.BUILD_DIR
    assert tn.SOURCE.parent.name == "native"
    assert tn.SOURCE.parent.parent.name == "thinkdiff_torch"
    assert tn.unavailable_reason() is None


def test_tar_index_matches_jax_and_tarfile(libs, shard):
    """Members, offsets and sizes in archive order."""
    got = tn.NativeTarIndex(shard).members
    assert got == jn.NativeTarIndex(shard).members
    with tarfile.open(shard) as tf:
        want = [(m.name, m.offset_data, m.size) for m in tf.getmembers()
                if m.isfile()]
    assert got == want


def test_pread_matches_jax_and_tarfile(libs, shard):
    idx = tn.NativeTarIndex(shard)
    with tarfile.open(shard) as tf:
        for name, off, size in idx.members:
            data = idx.read(off, size)
            assert data == tf.extractfile(name).read()
            assert data == jn.NativeTarIndex(shard).read(off, size)
    with pytest.raises(IOError, match="short read"):
        idx.read(idx.members[-1][1], 1 << 20)


def test_missing_tar_raises(libs, tmp_path):
    with pytest.raises(FileNotFoundError):
        tn.NativeTarIndex(str(tmp_path / "none.tar"))


def test_jpeg_decode_identical_to_jax_and_near_pil(libs):
    rs = np.random.RandomState(1)
    data = _jpeg_bytes((rs.rand(33, 47, 3) * 255).astype("uint8"))
    got = tn.decode_jpeg(data)
    np.testing.assert_array_equal(got, jn.decode_jpeg(data))
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.shape == ref.shape == (33, 47, 3)
    # the same libjpeg under PIL: within one level
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        tn.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("target", [32, 224])
def test_batch_decode_identical_to_jax_and_close_to_pil(libs, target):
    """Bit for bit JAX's library; against the PIL processor, JAX's bounds
    (tests/test_native_io.py): median |diff| < 0.05, correlation > 0.99."""
    rs = np.random.RandomState(2)
    jpegs = [_jpeg_bytes((rs.rand(50 + 7 * i, 40 + 11 * i, 3) * 255)
                         .astype("uint8")) for i in range(6)]
    got = tn.decode_resize_normalize_batch(jpegs, target, tp.CLIP_MEAN,
                                           tp.CLIP_STD, nthreads=3)
    assert got.shape == (6, target, target, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jn.decode_resize_normalize_batch(
        jpegs, target, tp.CLIP_MEAN, tp.CLIP_STD))
    proc = tp.BlipImageEvalProcessor(image_size=target)
    for i, j in enumerate(jpegs):
        ref = np.asarray(proc(Image.open(io.BytesIO(j))))
        assert np.median(np.abs(got[i] - ref)) < 0.05
        assert np.corrcoef(got[i].ravel(), ref.ravel())[0, 1] > 0.99
    with pytest.raises(ValueError, match="1/2 jpegs"):
        tn.decode_resize_normalize_batch([jpegs[0], b"bad"], target,
                                         tp.CLIP_MEAN, tp.CLIP_STD)


def test_wids_reader_native_path_matches_tarfile_path_and_jax(
        libs, tmp_path, monkeypatch):
    rs = np.random.RandomState(3)
    with ShardWriter(str(tmp_path / "img-%06d.tar"), maxcount=5) as w:
        for i in range(12):
            w.write({"__key__": f"img{i:04d}", "jpg": Image.fromarray(
                rs.randint(0, 256, (12, 12, 3), np.uint8)),
                "json": {"caption": f"c {i}"}})
        n = w.shard
    index = str(tmp_path / "i.json")
    write_wids_index([str(tmp_path / f"img-{i:06d}.tar") for i in range(n)],
                     index, "imgs")
    native_ds = tw.ShardListDataset(index, decode=False)
    assert native_ds._shard(0)._native is not None
    got = [native_ds[i] for i in range(len(native_ds))]
    want = jw.ShardListDataset(index, decode=False)
    assert [want[i] for i in range(len(want))] == got
    monkeypatch.setattr(tn, "available", lambda: False)
    plain_ds = tw.ShardListDataset(index, decode=False)
    assert plain_ds._shard(0)._native is None
    assert [plain_ds[i] for i in range(len(plain_ds))] == got
    decoded = tw.ShardListDataset(index)[4]
    assert decoded["json"] == {"caption": "c 4"}
    assert np.asarray(decoded["jpg"]).shape == (12, 12, 3)


def test_caption_split_collator_takes_jpeg_bytes_as_jax_does(libs):
    rs = np.random.RandomState(4)
    samples = [{"jpg_bytes": _jpeg_bytes((rs.rand(30 + i, 41, 3) * 255)
                                         .astype("uint8")),
                "answer": f"a caption with {i} more words here",
                "image_size": 16} for i in range(3)]
    random.seed(5)
    got = tcol.CaptionSplitCollator(t5_tok(), max_txt_len=12)(samples)
    random.seed(5)
    want = jcol.CaptionSplitCollator(t5_tok(), max_txt_len=12)(samples)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pixel_values"].shape == (3, 16, 16, 3)


@pytest.mark.parametrize("resample", [True, False])
def test_cc_sbu_native_path_batches_identical(libs, tmp_path, resample,
                                              caplog):
    """``use_native_decode`` on both sides: JPEG bytes through the C++
    batch decode, the caption parsed from the JSON bytes; the JAX side read
    through its synchronous pipeline (no prefetch thread outlives the
    case). The port logs the path it took."""
    storage = write_cc_sbu_shards(tmp_path / "shards")
    batches = {}
    for side, mod, node in (("port", tb, TConfigNode), ("jax", jb, JConfigNode)):
        cfg = _cc_sbu_cfg(storage, node, resample=resample,
                          use_native_decode=True)
        bundle = mod.CCSBUBuilder(cfg, model_cfg={"max_txt_len": 99}) \
            .build_datasets()["train"]
        bundle.set_tokenizers(t5_tok(), None)
        random.seed(9)
        with caplog.at_level("INFO", logger=tb.__name__):
            loader = bundle.get_loader(seed=4, epoch=1)
        it = iter(loader if side == "port" else loader.loader)
        batches[side] = [next(it) for _ in range(3 if resample else 2)]
        if hasattr(it, "close"):
            it.close()
    assert "cc_sbu: native JPEG decode" in caplog.text
    for got, want in zip(batches["port"], batches["jax"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["pixel_values"].shape == (4, 32, 32, 3)


def test_cc_sbu_logs_the_decoded_path_when_native_is_off(tmp_path, caplog,
                                                         monkeypatch):
    storage = write_cc_sbu_shards(tmp_path / "shards", n=4)
    monkeypatch.setattr(tn, "available", lambda: False)
    monkeypatch.setattr(tn, "unavailable_reason", lambda: "no g++")
    bundle = tb.CCSBUBuilder(_cc_sbu_cfg(storage, TConfigNode,
                                         use_native_decode=True)) \
        .build_datasets()["train"]
    bundle.set_tokenizers(t5_tok(), None)
    with caplog.at_level("INFO", logger=tb.__name__):
        bundle.get_loader()
    assert "decoded-sample path (PIL), native IO unavailable: no g++" \
        in caplog.text


def test_dataset_zoo_and_load_dataset_as_jax(tmp_path):
    assert tb.DatasetZoo().get_names() == sorted(
        tb.registry.mapping["builder"])
    assert len(tb.DatasetZoo()) == len(jb.DatasetZoo())
    assert set(tb.DatasetZoo().get_names()) == set(jb.DatasetZoo().get_names())
    storage = write_cc_sbu_shards(tmp_path / "shards", n=4)
    bundles = tb.load_dataset("cc_sbu", _cc_sbu_cfg(storage, TConfigNode))
    assert isinstance(bundles["train"], tb.DatasetBundle)
    with pytest.raises(KeyError, match="Unknown dataset builder"):
        tb.load_dataset("no_such_builder")
