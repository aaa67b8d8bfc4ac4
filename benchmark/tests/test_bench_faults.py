"""The comparison that decides ``correct`` fails what it must: whole runs
of the harness on the CPU at tiny widths, with the cells' own limits, the
look for a card skipped and the timed path broken underneath (each
fault the cell can have), see ``correct`` come out false; the sound run
beside them comes out true. The controls (the nearest lower precision)
fail at least one number: for training the program's own w8a8 path, for
rendering the reference itself with fp8 products in the program's
place."""

from unittest import mock

import pytest
import torch

from benchmark import control, harness, run
from benchmark.tests import tiny

SEED = 2 ** 31 + 77


def train_run(files=None):
    return run.run_cell("train-lvlm-bs32", SEED, 0.3, False, device="cpu",
                        files=files or tiny.train())


def flux_run(batch=1):
    return run.run_cell("flux-1024", SEED, 0.3, False, device="cpu",
                        files=tiny.flux(batch=batch))


def failed(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_runs_are_correct():
    assert train_run()["correct"]
    assert flux_run()["correct"]
    assert flux_run(2)["correct"]


def test_training_state_left_unchanged():
    from thinkdiff_torch.core.optim import AdamW

    with mock.patch.object(AdamW, "update", lambda self, g, s, p: None):
        out = train_run()
    assert not out["correct"] and "change_gap" in failed(out)


def test_training_half_the_batch_left_out():
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder

    loss_fn = MllamaT5EmbedDecoder.loss_fn

    def half(self, trainable, frozen, batch, rng=None):
        n = batch["labels"].shape[0] // 2
        return loss_fn(self, trainable, frozen,
                       {k: v[:n] for k, v in batch.items()}, rng)

    with mock.patch.object(MllamaT5EmbedDecoder, "loss_fn", half):
        out = train_run()
    assert not out["correct"], out["checks"]


def test_flux_step_returns_its_state_unchanged():
    from thinkdiff_torch.models.flux import FluxTransformer

    forward = FluxTransformer.forward

    def still(self, *a, **kw):
        # every Euler step leaves the latents as they are
        return torch.zeros_like(forward(self, *a, **kw))

    with mock.patch.object(FluxTransformer, "forward", still):
        out = flux_run()
    assert not out["correct"] and "latent_rel" in failed(out), out["checks"]


def test_flux_half_the_batch_left_out():
    from thinkdiff_torch.engines.flux_sampler import FluxSampler

    denoise = FluxSampler.denoise

    def half(self, latents, txt, pooled, *a, **kw):
        n = latents.shape[0] // 2
        x = denoise(self, latents[:n], txt[:n], pooled[:n], *a, **kw)
        return torch.cat([x, x])

    with mock.patch.object(FluxSampler, "denoise", half):
        out = flux_run(2)
    assert not out["correct"] and "latent_rel" in failed(out)


def test_flux_image_altered_where_it_is_produced():
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    generate = ThinkDiffPipeline.generate

    def altered(self, *a, **kw):
        images = generate(self, *a, **kw).clone()
        images[0, :8] = 1.0 - images[0, :8]
        return images

    with mock.patch.object(ThinkDiffPipeline, "generate", altered):
        out = flux_run()
    assert not out["correct"] and "image_abs" in failed(out)


CONTROL_CELLS = [("train-lvlm-bs32", tiny.train), ("flux-1024", tiny.flux),
                 ("flux-512-b4", lambda: tiny.flux(batch=2))]


@pytest.mark.parametrize("cell,files", CONTROL_CELLS,
                         ids=[c for c, _ in CONTROL_CELLS])
def test_control_stands_apart_at_tiny_widths(cell, files):
    """At tiny widths every error is smaller than at the cell's, so the
    cell's limits do not apply; the control still reads three times the
    sound run's reading on the same seed in one of the numbers."""
    names = harness.cell_files(cell)["cell"]["limits"]
    sound = control.readings(cell, SEED, "sound", "cpu", files(), passes=2)
    low = control.readings(cell, SEED, "control", "cpu", files(), passes=2)
    assert any(low[k] >= 3 * sound[k] for k in names), (sound, low)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c, _ in CONTROL_CELLS])
def test_control_fails_the_cells_limits_on_the_card(cell):
    """The control at the cell's own size, on three seeds: each fails one
    of the cell's numbers (python -m pytest -m gpu benchmark/tests on the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.cell_files(cell)["cell"]["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.readings(cell, seed, "control", passes=2)
        assert any(got[k] > limits[k] for k in limits), (seed, got, limits)
