"""Port parity: the data layer of stages 1 and 2 (thinkdiff_torch.data:
tario, the wids reader, the pipeline, the collators and builders) against
the JAX package on the same shards and seeds, on the CPU. Payloads,
sample orders and batches must be identical: there is no tolerance."""

import itertools
import tarfile

import numpy as np
import pytest
import torch

from thinkdiff_torch.core.config import ConfigNode as TNode
from thinkdiff_torch.data import builders as tb
from thinkdiff_torch.data import collators as tc
from thinkdiff_torch.data import pipeline as tp
from thinkdiff_torch.data import tario as tt
from thinkdiff_torch.data import wids_reader as tw
from thinkdiff_tpu.core.config import ConfigNode as JNode
from thinkdiff_tpu.data import builders as jb
from thinkdiff_tpu.data import pipeline as jp
from thinkdiff_tpu.data import tario as jt
from thinkdiff_tpu.data import wids_reader as jw

D = 12


class T5Tok:
    """A T5-like stand-in: words to ids in [3, 300), EOS 1 appended with
    special tokens."""
    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text, add_special_tokens=True):
        ids = [3 + sum(map(ord, w)) % 297 for w in text.split()]
        return ids + [1] if add_special_tokens else ids


def vlm_decode(ids):
    return " ".join(f"w{i}" for i in ids)


def _members(path):
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


def _bf16(rs, rows, width=D):
    return torch.from_numpy(rs.randn(rows, width).astype(np.float32)).to(
        torch.bfloat16)


def _jax_bf16(t):
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _embed_samples(n=40, seed=0):
    """Embed-shard samples as the precompute writes them: bf16 output and
    input embeds, json with output_token_ids and generated_text."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        gen = int(rs.randint(3, 40))
        ids = rs.randint(0, 500, gen).tolist()
        out.append({
            "__key__": f"s{i:05d}",
            "json": {"output_token_ids": ids, "generated_text": vlm_decode(ids),
                     "caption": f"c{i}"},
            "model.norm.input_embed.pth": _bf16(rs, int(rs.randint(4, 20))),
            "model.norm.output_embed.pth": _bf16(rs, gen),
        })
    return out


def _write_jax_shards(tmp_path, samples, per_shard=15, name="e"):
    """The samples through the JAX writer (bf16 fields as ml_dtypes
    arrays), ``per_shard`` samples a tar."""
    pattern = str(tmp_path / f"{name}-%06d.tar")
    with jt.ShardWriter(pattern, maxcount=per_shard) as w:
        for s in samples:
            w.write({k: (_jax_bf16(v) if isinstance(v, torch.Tensor) else v)
                     for k, v in s.items()})
        n = w.shard
    return [pattern % i for i in range(n)]


def test_tario_payloads_equal_the_jax_writers(tmp_path):
    """The same samples through both writers: the same member names in the
    same order with byte-identical payloads (json, txt, jpg, and the bf16
    and f32 .pth tensors), a view of a larger buffer written as its own
    rows only; both readers decode either tar to the same fields."""
    from PIL import Image

    rs = np.random.RandomState(3)
    big = _bf16(rs, 512)
    img = Image.fromarray(rs.randint(0, 256, (16, 24, 3), np.uint8))
    f32 = rs.randn(5, 3).astype(np.float32)
    port = [{"__key__": "a0", "json": {"x": [1, 2]}, "txt": "hello",
             "jpg": img, "model.norm.output_embed.pth": big[7:12],
             "f32.pth": torch.from_numpy(f32)},
            {"__key__": "a1", "json": {"y": "z"}, "txt": "two",
             "jpg": img, "model.norm.output_embed.pth": big[:3],
             "f32.pth": torch.from_numpy(f32[1:])}]
    jax = [{k: (_jax_bf16(v.clone()) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else
                v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in s.items()} for s in port]
    with tt.ShardWriter(str(tmp_path / "t-%06d.tar")) as w:
        for s in port:
            w.write(s)
    with jt.ShardWriter(str(tmp_path / "j-%06d.tar")) as w:
        for s in jax:
            w.write(s)
    got, want = _members(tmp_path / "t-000000.tar"), _members(
        tmp_path / "j-000000.tar")
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n for n, _ in got][:3] == ["a0.json", "a0.txt", "a0.jpg"]
    for (name, a), (_, b) in zip(got, want):
        assert a == b, name
    # 5 rows x 12 x 2 bytes plus torch.save's header, not the 512-row buffer
    pth = dict(got)["a0.model.norm.output_embed.pth"]
    assert len(pth) <= 5 * D * 2 + 2048 < 512 * D * 2
    for path in (tmp_path / "t-000000.tar", tmp_path / "j-000000.tar"):
        samples = list(tt.tar_sample_iterator(str(path), decode=True))
        jsamples = list(jt.tar_sample_iterator(str(path), decode=True))
        assert [s["__key__"] for s in samples] == ["a0", "a1"]
        for s, js, src in zip(samples, jsamples, port):
            e = s["model.norm.output_embed.pth"]
            assert e.dtype == torch.bfloat16
            assert torch.equal(e, src["model.norm.output_embed.pth"])
            assert np.array_equal(e.float().numpy(), np.asarray(
                js["model.norm.output_embed.pth"], np.float32))
            assert s["json"] == js["json"] and s["txt"] == js["txt"]
            assert torch.equal(s["f32.pth"], torch.as_tensor(js["f32.pth"]))
            assert np.array_equal(np.asarray(s["jpg"]), np.asarray(js["jpg"]))


def test_brace_expand_and_wids_index_match_jax(tmp_path):
    for pat in ("/d/{000000..000012}.tar", "x{1..3}y{07..09}", "plain.tar"):
        assert tt.brace_expand(pat) == jt.brace_expand(pat)
    shards = _write_jax_shards(tmp_path, _embed_samples(20))
    got = tt.write_wids_index(shards, str(tmp_path / "t.json"), "d")
    want = jt.write_wids_index(shards, str(tmp_path / "j.json"), "d")
    assert got == want
    assert [s["nsamples"] for s in got["shardlist"]] == [15, 5]
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("n,chunk,seed,epoch,world,rank", [
    (2500, 1000, 0, 0, 1, 0), (2500, 1000, 42, 3, 1, 0),
    (37, 5, 7, 1, 2, 1), (256, 1000, 42, 0, 1, 0)])
def test_chunked_sampler_order_matches_jax(n, chunk, seed, epoch, world, rank):
    samplers = [mod.ChunkedSampler(n, chunksize=chunk, seed=seed, rank=rank,
                                   world_size=world) for mod in (tw, jw)]
    for s in samplers:
        s.set_epoch(epoch)
    got, want = (list(s) for s in samplers)
    assert got == want and len(samplers[0]) == len(samplers[1])
    assert sorted(got) == list(range(rank, n, world)) or world > 1


def test_shard_list_dataset_reads_like_jax(tmp_path):
    shards = _write_jax_shards(tmp_path, _embed_samples(20))
    index = str(tmp_path / "i.json")
    jt.write_wids_index(shards, index, "d")
    got, want = tw.ShardListDataset(index), jw.ShardListDataset(index)
    assert len(got) == len(want) == 20
    for i in (0, 14, 15, 19, -1):
        a, b = got[i], want[i]
        assert a["__key__"] == b["__key__"] and a["json"] == b["json"]
        assert np.array_equal(
            a["model.norm.output_embed.pth"].float().numpy(),
            np.asarray(b["model.norm.output_embed.pth"], np.float32))


PIPELINES = {
    "stream": dict(resample=False, shuffle_buffer=0),
    "shuffle": dict(resample=False, shuffle_buffer=8),
    "resample": dict(resample=True, shuffle_buffer=8),
    "batched": dict(resample=False, shuffle_buffer=8, batch_size=4),
    "sorted": dict(resample=False, shuffle_buffer=8, batch_size=4,
                   sort_window=12,
                   sample_sort_fn=lambda s: len(s["json"]["output_token_ids"])),
    "budget": dict(resample=False, shuffle_buffer=8, batch_size=16,
                   token_budget=200, min_batch=2, budget_window=20,
                   budget_len_cap=64,
                   sample_len_fn=lambda s: len(s["json"]["output_token_ids"])),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
@pytest.mark.parametrize("seed", [0, 5])
def test_pipeline_order_matches_jax(tmp_path, name, seed):
    """Shard order, shuffle buffer, resampling, batch cutting, sorted windows
    and token budgets draw in the same order: the same keys in the same
    batches."""
    shards = _write_jax_shards(tmp_path, _embed_samples(40))
    kw = dict(PIPELINES[name], seed=seed)

    def keys(mod):
        out = []
        for item in mod.WebDatasetPipeline(shards, **kw):
            out.append([s["__key__"] for s in item] if isinstance(item, list)
                       else item["__key__"])
            if len(out) >= 60:
                break
        return out

    got, want = keys(tp), keys(jp)
    assert got == want and len(got) > 3


def _embed_cfg(storage, **build_info):
    return {"batch_size": 6, "max_txt_len": 16,
            "build_info": {"storage": storage, "use_input_embed": False,
                           "use_output_embed": True,
                           "random_split_output_embed": True,
                           "output_embed_max_split_len": 8, **build_info}}


COLLATE_MODES = {
    "padded": {},
    "bucketed": {"bucket_lengths": True, "sort_window": 18},
    "packed": {"pack": 40, "pack_row_bucket": 2},
    "plain": {"random_split_output_embed": False,
              "output_embed_max_len": 24},
    "input_embed": {"use_input_embed": True, "use_output_embed": False,
                    "input_embed_max_len": 20},
}


@pytest.mark.parametrize("mode", sorted(COLLATE_MODES))
def test_embed_shard_batches_match_jax(tmp_path, mode):
    """llava_instruct_mllama_embed_2 on the same shards, seed and epoch in
    both packages: every array of the first five batches identical."""
    shards = _write_jax_shards(tmp_path, _embed_samples(60))
    storage = str(tmp_path / ("e-{000000..%06d}.tar" % (len(shards) - 1)))
    cfg = _embed_cfg(storage, **COLLATE_MODES[mode])
    model_cfg = {"t5_tokenizer_add_special_tokens_prob": 0.5}
    loaders = []
    for builder, node in ((tb.LlavaInstructEmbedBuilder, TNode),
                          (jb.LlavaInstructEmbedBuilder, JNode)):
        bundle = builder(node(cfg), model_cfg=node(model_cfg)).build_datasets()[
            "train"]
        bundle.set_tokenizers(T5Tok(), vlm_decode)
        loaders.append(iter(bundle.get_loader(seed=3, epoch=1)))
    for _ in range(5):
        got, want = next(loaders[0]), next(loaders[1])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    if mode == "packed":
        assert "dec_segments" in got and got["dec_segments"].max() > 1


@pytest.mark.parametrize("processor", [None, {"name": "mllama_image_eval",
                                               "max_size": 8}])
def test_wids_process_batches_match_jax(tmp_path, processor):
    """cc_sbu_mllama_vllm_process_wids, with and without a VLM image
    processor: the same sample order, images, instructions, json and
    keys."""
    from PIL import Image

    rs = np.random.RandomState(1)
    with jt.ShardWriter(str(tmp_path / "img-%06d.tar"), maxcount=7) as w:
        for i in range(17):
            w.write({"__key__": f"img{i:04d}", "jpg": Image.fromarray(
                rs.randint(0, 256, (12, 12, 3), np.uint8)),
                "json": {"caption": f"c {i}"}})
        n = w.shard
    index = str(tmp_path / "i.json")
    jt.write_wids_index([str(tmp_path / f"img-{i:06d}.tar") for i in range(n)],
                        index, "imgs")
    cfg = {"batch_size": 5, "build_info": {"storage": index}}
    if processor:
        cfg["vis_processor"] = {"eval": processor}
    got = list(tb.CCSBUWidsProcessBuilder(TNode(cfg)).build_datasets()[
        "train"].get_loader(seed=42))
    want = list(jb.CCSBUWidsProcessBuilder(JNode(cfg)).build_datasets()[
        "train"].get_loader(seed=42))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a["filenames"] == b["filenames"] and a["jsons"] == b["jsons"]
        assert a["answers"] == b["answers"]
        assert all(x in tc.LLAVA_BRIEF_INSTRUCTIONS for x in a["answers"])
        for x, y in zip(a["images"], b["images"]):
            assert x.size == y.size == ((8, 8) if processor else (12, 12))
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_prefetch_loader_keeps_order_and_raises():
    """The prefetch thread yields the loader's host batches in order,
    stops when the consumer does, and an error in the loader reaches the
    consumer."""
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    seen = list(tp.PrefetchLoader(batches, depth=1))
    assert [int(b["x"][0]) for b in seen] == [0, 1, 2, 3, 4]
    assert all(b is a for a, b in zip(batches, seen))
    first = list(itertools.islice(tp.PrefetchLoader(batches, depth=1), 2))
    assert [int(b["x"][0]) for b in first] == [0, 1]

    def bad():
        yield {"x": np.zeros(1)}
        raise ValueError("broken shard")

    with pytest.raises(ValueError, match="broken shard"):
        list(tp.PrefetchLoader(bad()))


def test_iter_loaders_match_jax():
    """IterLoader wraps epochs; MultiIterLoader draws its loaders in the
    JAX package's order."""
    got = tp.IterLoader([1, 2, 3])
    assert [next(got) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]
    assert got.epoch == 2
    mk = lambda mod: mod.MultiIterLoader(
        [iter(range(0, 100)), iter(range(100, 200))], [0.3, 0.7], seed=4)
    a, b = mk(tp), mk(jp)
    assert [next(a) for _ in range(30)] == [next(b) for _ in range(30)]
