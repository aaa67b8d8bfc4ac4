"""The program's spans against a card's trace (``program_trace.py``) and
the nine readers on it: a synthetic chrome trace of CUDA activity with
synthetic spans of the port's tracer, on the trace's clock."""

import json
import sys

import pytest

import thinkdiff_torch.core
from benchmark import harness, program_trace as pt
from thinkdiff_torch.core.trace import Span

pt_program_spans = pt.program_spans

BASE = 1_700_000_000_000_000_000   # the trace's baseTimeNanoseconds
STEP_US = 2000                     # a step's offset on the trace


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def call(name, ts, dur, corr, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def span(i, name, a, b, parent=None, **attrs):
    """A record of the port's tracer from a to b us on the trace."""
    return Span(i, parent, name, BASE + int(a * 1e3), BASE + int(b * 1e3),
                attrs, 1)


def train_step(k):
    """Step k's spans and events, ``k * STEP_US`` on. In it (us from its
    offset): prepare_batch 100-200 (a pinned copy, device 130-170); step
    200-1200: forward 250-500 (a GEMM, device 270-470, and a 150 us
    synchronize with a driver call nested in it), backward 500-800 (a
    launch from autograd's thread, device 560-860), the step's own work
    (device 870-890), optimizer 900-1100 (a driver launch, device
    1000-1100); then a launch outside every span (device 1260-1270) and
    a long synchronize outside. Idle inside the step: 470-560, 860-870,
    890-1000, 1100-1260 = 370 us; 170-270 began in prepare_batch."""
    o, c, s = k * STEP_US, 100 * k, 10 * k
    spans = [span(s + 1, "train.prepare_batch", o + 100, o + 200),
             span(s + 3, "train.forward", o + 250, o + 500, s + 2),
             span(s + 4, "train.backward", o + 500, o + 800, s + 2),
             span(s + 5, "train.optimizer", o + 900, o + 1100, s + 2),
             span(s + 2, "train.step", o + 200, o + 1200, step=k)]
    events = [
        call("cudaMemcpyAsync", o + 120, 5, c + 2),
        kernel("Memcpy HtoD (Pinned -> Device)", o + 130, 40, c + 2,
               "gpu_memcpy"),
        call("cudaLaunchKernel", o + 260, 5, c + 3),
        kernel("nvjet_gemm_fwd", o + 270, 200, c + 3),
        call("cudaStreamSynchronize", o + 300, 150, c + 90),
        call("cuLaunchKernel", o + 310, 30, c + 91, cat="cuda_driver"),
        call("cudaLaunchKernel", o + 550, 5, c + 4, tid=2),
        kernel("nvjet_gemm_bwd", o + 560, 300, c + 4),
        call("cudaLaunchKernel", o + 850, 5, c + 5),
        kernel("vectorized_elementwise_kernel", o + 870, 20, c + 5),
        call("cuLaunchKernelEx", o + 950, 5, c + 6, cat="cuda_driver"),
        kernel("multi_tensor_apply_kernel", o + 1000, 100, c + 6),
        call("cudaLaunchKernel", o + 1250, 5, c + 7),
        kernel("outside_kernel", o + 1260, 10, c + 7),
        call("cudaDeviceSynchronize", o + 1300, 500, c + 92)]
    return spans, events


def flux_step(k, parent):
    """A denoise step 1000 us long from ``k * 1000``: its own GEMM (50),
    then a norm-mod (10), a rope (20) and a residual (30)."""
    o, c, s = 1000 * k, 100 * k + 10, 10 * k
    sid = s + 11
    spans = [span(s + 12, "flux.norm_mod", o + 100, o + 200, sid),
             span(s + 13, "flux.rope", o + 300, o + 400, sid),
             span(s + 14, "flux.residual", o + 500, o + 600, sid),
             span(sid, "flux.step", o + 50, o + 900, parent, step=k)]
    events = []
    for i, (at, dur) in enumerate(((60, 50), (110, 10), (310, 20),
                                   (510, 30))):
        events += [call("cudaLaunchKernel", o + at, 5, c + i),
                   kernel(f"k{i}", o + at + 5, dur, c + i)]
    return spans, events


@pytest.fixture
def cell(tmp_path, monkeypatch):
    """Installs a trace and spans as a run of ``workload`` would leave
    them; returns a function that does so."""
    monkeypatch.setattr(pt, "trace_path",
                        lambda w: tmp_path / f"thinkdiff_bench_{w}.json")
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "c",
                                      "--seed", "1"])
    pt._cache.clear()

    def install(spans, events, anchor=True):
        if anchor:  # the harness's marker kernel, left out of everything
            events = [call("cudaLaunchKernel", 10, 3, 1),
                      kernel("void spin_kernel(long)", 15, 2, 1)] + events
        (tmp_path / "thinkdiff_bench_c.json").write_text(json.dumps(
            {"baseTimeNanoseconds": BASE, "traceEvents": events}))
        monkeypatch.setattr(pt, "program_spans", lambda: list(spans))
        pt._cache.clear()

    return install


TRAIN = {"path": "train_step", "trace": {"busy_s": 1.0}}
FLUX = {"path": "flux_step", "trace": {"busy_s": 1.0}}


@pytest.fixture
def train(cell):
    spans, events = [], []
    for k in range(2):
        s, e = train_step(k)
        spans += s
        events += e
    cell(spans, events)
    return TRAIN


def reader(name):
    return harness.metric_reader(name)


def test_kernels_belong_to_the_innermost_span_at_launch(train):
    r = pt.read(train, "train_step")
    owners = {d[1]: r.spans[d[4]][0] if d[4] is not None else None
              for d in r.device}
    assert owners == {"Memcpy HtoD (Pinned -> Device)": "train.prepare_batch",
                      "nvjet_gemm_fwd": "train.forward",
                      # launched from autograd's thread
                      "nvjet_gemm_bwd": "train.backward",
                      "vectorized_elementwise_kernel": "train.step",
                      "multi_tensor_apply_kernel": "train.optimizer",
                      "outside_kernel": None}
    assert not any("spin_kernel" in d[1] for d in r.device)


def test_phase_readers_give_device_ms_a_step(train):
    assert reader("fwd_ms.train")(train) == pytest.approx(0.2)
    assert reader("bwd_ms.train")(train) == pytest.approx(0.3)
    assert reader("optim_ms.train")(train) == pytest.approx(0.1)


def test_blocked_counts_each_call_beyond_its_first_20_us(train):
    # the 150 us synchronize counts 130 us; its nested driver call and the
    # enqueues nothing; the 500 us synchronize after the step nothing
    assert reader("blocked_ms.train")(train) == pytest.approx(0.130)


def test_host_gap_counts_gaps_begun_inside_the_step(train):
    assert reader("host_gap_ms.train")(train) == pytest.approx(0.370)


def test_launches_counts_kernels_launched_inside_the_step(train):
    assert reader("launches.train")(train) == pytest.approx(4.0)


def test_flux_readers_give_device_ms_a_denoise_step(cell):
    spans, events = [span(1, "flux.request", 0, 3000)], []
    for k in range(2):
        s, e = flux_step(k, 1)
        spans += s
        events += e
    spans.append(span(99, "flux.decode", 2000, 2900, 1))
    cell(spans, events)
    assert reader("norm_mod_ms.flux")(FLUX) == pytest.approx(0.010)
    assert reader("rope_ms.flux")(FLUX) == pytest.approx(0.020)
    assert reader("residual_ms.flux")(FLUX) == pytest.approx(0.030)
    # the flux readers read nothing of a training cell and back
    assert reader("norm_mod_ms.flux")(TRAIN) is None
    assert reader("fwd_ms.train")(FLUX) is None


def test_split_names_device_and_idle_time_by_span(train):
    out = pt.split(pt.read(train, "train_step"))
    assert out["device_s"] == pytest.approx({
        "train.prepare_batch": 80e-6, "train.forward": 400e-6,
        "train.backward": 600e-6, "train.step": 40e-6,
        "train.optimizer": 200e-6, pt.OUTSIDE: 20e-6})
    assert out["outside_share"] == pytest.approx(20 / 1340)
    assert out["spans"]["train.step"] == 2
    assert out["idle_s"]["train.prepare_batch"] == pytest.approx(200e-6)
    assert out["idle_s"]["train.forward"] == pytest.approx(180e-6)
    assert out["kernels"]["train.forward"] == [
        ("nvjet_gemm_fwd", pytest.approx(400e-6))]


def test_innermost_across_threads_and_unnested_spans():
    spans = [("a", 0, 100), ("b", 10, 20), ("c", 15, 50), ("d", 60, 70)]
    assert pt.innermost(spans, [5, 12, 17, 30, 65, 80, 100, None]) == \
        [0, 1, 2, 2, 3, 0, None, None]


def test_no_spans_no_trace_no_workload_give_none(cell, monkeypatch):
    s, e = train_step(0)
    names = ["fwd_ms.train", "blocked_ms.train", "host_gap_ms.train",
             "launches.train"]
    cell([], e)                                   # no spans
    assert all(reader(n)(TRAIN) is None for n in names)
    cell(s, [])                                   # no device events
    assert all(reader(n)(TRAIN) is None for n in names)
    cell(s, e)
    assert all(reader(n)(TRAIN) is not None for n in names)
    assert all(reader(n)(dict(TRAIN, trace=None)) is None for n in names)
    monkeypatch.setattr(sys, "argv", ["-c"])      # no --workload
    assert all(reader(n)(TRAIN) is None for n in names)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload=other"])
    assert all(reader(n)(TRAIN) is None for n in names)   # no such file


def test_a_program_without_the_tracer_gives_none(cell, monkeypatch):
    s, e = train_step(0)
    cell(s, e)
    assert pt.load("c") is not None
    monkeypatch.setattr(pt, "program_spans", pt_program_spans)
    monkeypatch.delattr(thinkdiff_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "thinkdiff_torch.core.trace", None)
    assert pt.program_spans() == []
    assert pt.load("c") is None


def test_workload_arg_reads_both_spellings():
    assert pt.workload_arg(["x", "--workload", "w", "--seed", "1"]) == "w"
    assert pt.workload_arg(["x", "--workload=w"]) == "w"
    assert pt.workload_arg(["x", "--seed", "1"]) is None
