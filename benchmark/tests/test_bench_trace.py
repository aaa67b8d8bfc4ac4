"""The reading of a card's trace: a chrome trace of CUDA activity alone
(kernels, copies, sets and the runtime calls that launched them), with
the harness's spans placed on its clock by the anchor kernel's launch."""

import json

import pytest

from benchmark import harness, readers


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 3, "args": {"correlation": corr}}


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.fixture
def trace(tmp_path):
    # the anchor launched at 1,000 us on the trace's clock; then #1, a
    # copy beside a GEMM, and a GEMM: idle 1,400-1,600 and 2,000-2,100
    events = [launch(1000, 1), kernel("void spin_kernel(long)", 1005, 2, 1),
              launch(1100, 2), kernel("flash_fwd_kernel<64>", 1200, 200, 2),
              kernel("Memcpy HtoD", 1600, 100, 3, "gpu_memcpy"),
              launch(1650, 4), kernel("nvjet_gemm", 1650, 350, 4),
              launch(1700, 5), kernel("nvjet_gemm", 2100, 100, 5)]
    # host spans in seconds from the anchor: the host was in train_step
    # from 1,300 to 1,950 us and in prepare_batch before that
    spans = [("prepare_batch", 0.0, 300e-6), ("train_step", 300e-6, 950e-6)]
    return harness.read_trace(write(tmp_path, events), spans, cuda=True)


def test_the_stretch_runs_from_the_first_operation_to_the_last(trace):
    # the anchor kernel is left out: 1,200 to 2,200 us
    assert trace["window_s"] == pytest.approx(1000e-6)
    # the copy and the first GEMM overlap: 1,600 to 2,000 us
    assert trace["busy_s"] == pytest.approx((200 + 400 + 100) * 1e-6)
    assert trace["kernels"] == pytest.approx(
        {"flash_fwd_kernel<64>": 200e-6, "nvjet_gemm": 450e-6})


def test_gaps_are_named_by_the_span_the_host_was_in(trace):
    assert sorted(trace["gaps"]) == sorted(
        [("train_step", pytest.approx(200e-6)),
         ("outside the benchmark's spans", pytest.approx(100e-6))])


def test_no_anchor_leaves_the_gaps_unnamed(tmp_path):
    events = [kernel("a", 0, 10, 7), kernel("b", 20, 10, 8)]
    tr = harness.read_trace(write(tmp_path, events), [("x", 0, 1)], True)
    assert tr["gaps"] == [("outside the benchmark's spans",
                           pytest.approx(10e-6))]
    assert tr["window_s"] == pytest.approx(30e-6)


def test_the_readers_of_a_trace(trace):
    rec = {"path": "train_step", "trace": trace, "plain_s": 1.0,
           "spans": harness.Spans(),
           "units": [({"ops": 0, "calls": [
               ({"op": "attention", "bytes": 0, "ops": 98.9e6}, 1)]},
               True)]}
    assert readers.idle(rec, "train_step") == pytest.approx(30.0)
    # 98.9 M operations are 0.1 us at the peak, over 200 us of #1
    assert readers.roofline(rec, "train_step", "attention") == \
        pytest.approx(100 * 0.1 / 200)
    assert readers.idle(dict(rec, path="flux_step"), "train_step") is None


def test_breakdown_keeps_ten_of_each(trace):
    b = harness.breakdown(trace)
    assert b["device_ops"][0][0] == "nvjet_gemm"
    assert len(b["idle_gaps"]) == 2 and b["idle_gaps"][0][0] == "train_step"
