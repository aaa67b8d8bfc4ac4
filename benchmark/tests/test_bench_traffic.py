"""The frozen copy of the aligner batches against the port's generator,
and the seeds' traffic: the same seed the same inputs, every seed the
same shapes."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import aligner_padded, clip_prompt, flux_requests

TRAIN = harness.cell_files("train-lvlm-bs32")
FLUX = harness.cell_files("flux-1024")


def small_params(**kw):
    return {**TRAIN["traffic"]["params"], "pool_batches": 4, **kw}


def test_frozen_copy_equals_the_ports():
    synthetic = pytest.importorskip("thinkdiff_torch.data.synthetic")
    rs = np.random.RandomState(5)
    a = aligner_padded.build_batches(rs, rs, 8, 8, 16, 100)
    b = synthetic.build_batches(np.random.RandomState(5), 8, 8, 16, 100)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, 2 ** 40 + 3])
def test_same_seed_same_batches(seed):
    cfg = {"vlm_hidden_size": 16, "t5": {"vocab_size": 100}}
    a = aligner_padded.make(small_params(), seed, cfg)
    b = aligner_padded.make(small_params(), seed, cfg)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_every_seed_the_same_shapes():
    cfg = {"vlm_hidden_size": 16, "t5": {"vocab_size": 100}}

    def shapes(seed):
        return sorted((b["embeds"].shape, b["labels"].shape,
                       int(b["embed_mask"].sum()),
                       int((b["labels"] != -100).sum()))
                      for b in aligner_padded.make(small_params(), seed, cfg))

    a, b = aligner_padded.make(small_params(), 1, cfg), \
        aligner_padded.make(small_params(), 2, cfg)
    assert shapes(1) == shapes(2)
    assert not all(np.array_equal(x["embeds"], y["embeds"])
                   for x, y in zip(a, b) if x["embeds"].shape ==
                   y["embeds"].shape)


def test_pool_lengths_follow_the_generation_statistics():
    cfg = {"vlm_hidden_size": 8, "t5": {"vocab_size": 100}}
    pool = aligner_padded.make(TRAIN["traffic"]["params"], 3, cfg)
    assert len(pool) == TRAIN["traffic"]["params"]["pool_batches"]
    for b in pool:
        assert b["labels"].shape[0] == 32
        assert b["labels"].shape[1] in (32, 64, 96, 128)
        assert b["embeds"].shape[1] in (32, 64, 96, 128)
        assert (b["embed_mask"].sum(1) >= 1).all()


def test_flux_requests_seeded():
    params, cfg = FLUX["traffic"]["params"], FLUX["config"]
    small = dict(params, height=64, width=64, tokens=4)
    a = flux_requests.tokens(small, cfg, 2 ** 31 + 5, 3, "cpu")
    b = flux_requests.tokens(small, cfg, 2 ** 31 + 5, 3, "cpu")
    c = flux_requests.tokens(small, cfg, 2 ** 31 + 5, 4, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1, 4, 4096) and a.dtype == torch.bfloat16
    n = flux_requests.noise(small, cfg, 2 ** 31 + 5, 3, "cpu")
    assert n.shape == (1, 16, 64)
    # the noise is the sampler's draw for the request's seed
    gen = torch.Generator().manual_seed(
        flux_requests.request_seed(2 ** 31 + 5, 3))
    assert torch.equal(n, torch.randn((1, 16, 64), generator=gen))


def test_prompt_ids():
    ids = clip_prompt.PromptIds(FLUX["config"]["text_encoder"])([""] * 2)
    row = ids["input_ids"][0]
    assert ids["input_ids"].shape == (2, 77)
    assert row[0] == 49406 and (row[1:] == 49407).all()
