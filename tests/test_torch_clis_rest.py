"""Port parity: the last two CLIs against the JAX package's scripts on the
CPU. ``get_wids_input_json`` writes the same JSON as
scripts/get_wids_input_json.py (distinct keys, ``--items-per-sample``,
missing shards skipped); ``convert_checkpoint`` carries a reference
checkpoint (made by the JAX script from a seeded trainable tree) to the
port's layout and back, the reference keys equal to JAX's export and every
value exact."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import scripts.convert_checkpoint as jconv
from thinkdiff_torch.data.tario import ShardWriter
from thinkdiff_torch.models.bridge import flatten
from thinkdiff_torch.scripts import convert_checkpoint as tconv
from thinkdiff_torch.scripts import get_wids_input_json as twids
from thinkdiff_tpu.models.aligner_lvlm import MllamaT5EmbedDecoder as JModel
from thinkdiff_tpu.models.base import save_msgpack_params
from tests.test_torch_aligner_train import _models

ARCH = "mllama-vllm-t5-embed-decoder-2"
REPO = Path(__file__).resolve().parents[1]


def _run_jax(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["script"] + argv)
    main()


@pytest.mark.parametrize("items", [None, 2])
def test_get_wids_input_json_identical_to_jax(tmp_path, items):
    rs = np.random.RandomState(0)
    with ShardWriter(str(tmp_path / "s-%05d.tar"), maxcount=4) as w:
        for i in range(10):
            sample = {"__key__": f"k{i:03d}", "jpg": Image.fromarray(
                rs.randint(0, 256, (8, 8, 3), np.uint8))}
            if i % 3:
                sample["json"] = {"caption": f"c{i}"}
            w.write(sample)
    # one shard of the pattern is missing: both scripts skip it
    shards = f"{tmp_path}/s-{{00000..00003}}.tar"
    extra = [] if items is None else ["--items-per-sample", str(items)]
    common = ["--shards", shards, "--name", "cc", "--workers", "2"] + extra
    got = twids.main(common + ["--output", str(tmp_path / "port.json")])
    # JAX's script forks its pool: run it in a process of its own, not in
    # this one, whose JAX runtime has threads
    subprocess.run([sys.executable, "-m", "scripts.get_wids_input_json",
                    *common, "--output", str(tmp_path / "jax.json")],
                   cwd=REPO, check=True, capture_output=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert len(got["shardlist"]) == 3
    assert got == json.loads((tmp_path / "jax.json").read_text())


def test_convert_checkpoint_round_trip_equals_jax(tmp_path, monkeypatch):
    """msgpack (JAX) -> reference .pth (the JAX script) -> the port's .pth
    -> reference .pth (the port): the port's trainable tree is JAX's
    ``convert_reference_checkpoint`` of it, and the reference file written
    back has JAX's export's keys and values, in the reference's wrapper."""
    jm, tm = _models(False)
    trainable = jax.tree.map(np.asarray, jm.trainable_params())
    save_msgpack_params(trainable, str(tmp_path / "t.msgpack"))
    ref = tmp_path / "ref.pth"
    _run_jax(monkeypatch, jconv.main, ["--arch", ARCH, "--input",
                                       str(tmp_path / "t.msgpack"),
                                       "--output", str(ref)])
    ref_sd = torch.load(ref, weights_only=False)["model"]
    port_ck = tmp_path / "ckpt" / "checkpoint_0.pth"
    tconv.main(["--arch", ARCH, "--input", str(ref), "--output",
                str(port_ck)])
    got = torch.load(port_ck, weights_only=True)
    assert got["epoch"] == 0
    want = flatten(JModel.convert_reference_checkpoint(
        JModel.__new__(JModel), {k: v.numpy() for k, v in ref_sd.items()}))
    assert sorted(got["model"]) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got["model"][k].numpy(), np.asarray(w))
    # the port's model loads it as it loads its own checkpoints
    tm.load_checkpoint(str(port_ck))
    for k, w in flatten(trainable).items():
        np.testing.assert_array_equal(flatten(tm.trainable)[k].numpy(), w)
    back = tmp_path / "back.pth"
    tconv.main(["--arch", ARCH, "--input", str(port_ck), "--output",
                str(back)])
    back_ck = torch.load(back, weights_only=True)
    assert set(back_ck) == {"model", "epoch"} and back_ck["epoch"] == 0
    export = JModel.export_reference_checkpoint(JModel.__new__(JModel),
                                                trainable)
    assert sorted(back_ck["model"]) == sorted(export) == sorted(ref_sd)
    for k, w in export.items():
        np.testing.assert_array_equal(back_ck["model"][k].numpy(),
                                      np.asarray(w))
        assert torch.equal(back_ck["model"][k], ref_sd[k])


def test_convert_checkpoint_refuses_other_files(tmp_path):
    bad = tmp_path / "bad.pth"
    torch.save({"model": {"weight": torch.zeros(2)}}, bad)
    with pytest.raises(ValueError, match="neither"):
        tconv.main(["--arch", ARCH, "--input", str(bad), "--output",
                    str(tmp_path / "o.pth")])
    with pytest.raises(KeyError, match="Unknown arch"):
        tconv.main(["--arch", "nope", "--input", str(bad), "--output",
                    str(tmp_path / "o.pth")])
