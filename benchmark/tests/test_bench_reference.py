"""The plain references against the port's plain path (its kernels'
plain PyTorch versions on the CPU), in float32 at tiny widths: the whole
cell, set-up, window and check, through the harness."""

import pytest

from benchmark import run
from benchmark.tests import tiny


def test_aligner_reference_matches_the_port():
    out = run.run_cell("train-lvlm-bs32", 2 ** 31 + 101, 0.5, False,
                       device="cpu", files=tiny.train("float32"))
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert out["correct"] and out["attempted"] >= 1


@pytest.mark.parametrize("batch", [1, 2])
def test_flux_reference_matches_the_port(batch):
    out = run.run_cell("flux-1024", 2 ** 31 + 102, 0.5, False, device="cpu",
                       files=tiny.flux("float32", batch))
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert out["correct"]
