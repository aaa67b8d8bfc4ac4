"""The port's tracer (thinkdiff_torch/core/trace.py): off it records
nothing; on (under torch.profiler or after enable()) its spans nest by
thread, stamp the profiler's clock, and mark the training step's and the
FLUX request's phases without changing a bit of their outputs. Tiny
models on the CPU."""

import json
import threading

import numpy as np
import pytest
import torch

from thinkdiff_torch.core import trace
from thinkdiff_torch.core.optim import tree_leaves
from thinkdiff_torch.engines.flux_sampler import FluxSampler
from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline
from thinkdiff_torch.engines.trainer import Trainer
from thinkdiff_torch.models import flux as tf
from thinkdiff_torch.models import flux_vae as tv
from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder

STEPS = 3
HW = 32


@pytest.fixture
def recording():
    """Tracing on for the test, from no records; off and cleared after."""
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def _by_name(records, name):
    return [s for s in records if s.name == name]


def test_off_returns_the_shared_no_op_and_records_nothing():
    trace.clear()
    a, b = trace.span("x"), trace.span("y", step=1)
    assert a is b
    with a as got:
        with b:
            pass
    assert got is None and trace.spans() == []


def test_on_after_enable_ids_parents_and_nesting(recording):
    with trace.span("root", step=7):
        with trace.span("child"):
            with trace.span("leaf"):
                pass
        with trace.span("child"):
            pass
    with trace.span("second root"):
        pass
    recs = trace.spans()
    assert [s.name for s in recs] == ["leaf", "child", "child", "root",
                                      "second root"]
    leaf, c1, c2, root, other = recs
    assert root.parent is None and other.parent is None
    assert c1.parent == c2.parent == root.id and leaf.parent == c1.id
    assert len({s.id for s in recs}) == 5
    assert root.attrs == {"step": 7} and leaf.attrs == {}
    assert root.start_ns <= c1.start_ns <= leaf.start_ns <= leaf.end_ns \
        <= c1.end_ns <= c2.start_ns <= c2.end_ns <= root.end_ns
    assert all(isinstance(s.start_ns, int) for s in recs)


def test_spans_nest_by_thread(recording):
    done = []

    def other():
        with trace.span("other"):
            done.append(True)

    with trace.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and done
    (main,), (oth,) = _by_name(trace.spans(), "main"), \
        _by_name(trace.spans(), "other")
    # the other thread's span is a root of its own
    assert oth.parent is None and oth.thread != main.thread


def test_on_under_the_profiler_alone_and_off_after_it():
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("profiled"):
            pass
    with trace.span("after"):
        pass
    assert [s.name for s in trace.spans()] == ["profiled"]
    trace.clear()


def test_a_marker_inside_a_span_lands_inside_it_on_the_trace(tmp_path):
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with torch.profiler.record_function("marker"):
                torch.ones(64).add_(1)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    (outer,) = trace.spans()
    trace.add_to_chrome_trace(str(path))
    trace.clear()
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    ev = data["traceEvents"]
    marker = next(e for e in ev if e.get("name") == "marker"
                  and e.get("ph") == "X")
    a, b = (outer.start_ns - base) / 1e3, (outer.end_ns - base) / 1e3
    assert a <= marker["ts"] and marker["ts"] + marker["dur"] <= b
    # the exported span: its own process row, the same interval
    (sp,) = [e for e in ev if e.get("cat") == "program_span"]
    assert sp["pid"] == trace.CHROME_PID and sp["name"] == "outer"
    assert sp["ts"] == pytest.approx(a) and sp["dur"] == pytest.approx(b - a)
    assert any(e.get("ph") == "M" and e["pid"] == trace.CHROME_PID
               and e["args"]["name"] == trace.CHROME_PROCESS for e in ev)


# -- the training step ---------------------------------------------------------

def _trainer():
    cfg = {"dtype": "float32", "load_pretrained": False,
           "chunked_ce": 8, "mm_projector_type": "mlp2x_gelu_t5_norm",
           "vlm_hidden_size": 16,
           "t5_config": dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                             num_layers=1, num_decoder_layers=2,
                             num_heads=4, fused_proj=True)}
    model = MllamaT5EmbedDecoder(cfg, seed=1, device="cpu")
    return Trainer(model, {"warmup_steps": 0}, device="cpu")


def _batch():
    rs = np.random.RandomState(0)
    labels = rs.randint(1, 128, (3, 10)).astype(np.int32)
    labels[1, 6:] = -100
    return {"embeds": rs.randn(3, 8, 16).astype(np.float32),
            "embed_mask": np.ones((3, 8), np.int32), "labels": labels}


def test_train_step_spans_its_phases_in_order(recording):
    tr = _trainer()
    state = tr.init_state()
    for _ in range(2):
        tr.train_step(state, tr.prepare_batch(_batch()))
    recs = trace.spans()
    assert len(_by_name(recs, "train.prepare_batch")) == 2
    steps = _by_name(recs, "train.step")
    assert [s.attrs["step"] for s in steps] == [0, 1]
    assert all(s.parent is None for s in steps)
    for st in steps:
        kids = sorted((s for s in recs if s.parent == st.id),
                      key=lambda s: s.start_ns)
        # one rank: no all-reduce
        assert [s.name for s in kids] == ["train.forward", "train.backward",
                                          "train.optimizer"]
        assert all(st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns
                   for s in kids)


# -- the FLUX request ------------------------------------------------------------

def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return module


def _pipe():
    cfg, vcfg = tf.FluxConfig.tiny(), tv.VAEConfig.tiny()
    sampler = FluxSampler(
        cfg, _seeded(tf.FluxTransformer(cfg, device="cpu"), 1), vcfg,
        _seeded(tv.VAEDecoder(vcfg, device="cpu"), 2), device="cpu")
    return ThinkDiffPipeline(sampler)


def _tokens(cfg):
    g = torch.Generator().manual_seed(3)
    return torch.randn((1, 8, cfg.joint_attention_dim), generator=g)


def test_flux_request_spans_steps_blocks_and_decode(recording):
    pipe = _pipe()
    cfg = pipe.sampler.cfg
    pipe.generate(_tokens(cfg), height=HW, width=HW, num_steps=STEPS)
    recs = trace.spans()
    (req,) = _by_name(recs, "flux.request")
    assert req.parent is None
    steps = _by_name(recs, "flux.step")
    assert [s.attrs["step"] for s in steps] == list(range(STEPS))
    assert all(s.parent == req.id for s in steps)
    (dec,) = _by_name(recs, "flux.decode")
    assert dec.parent == req.id and dec.start_ns >= steps[-1].end_ns
    d, n = cfg.num_double_layers, cfg.num_single_layers
    want = {"flux.norm_mod": 4 * d + n, "flux.rope": d + n,
            "flux.residual": 4 * d + n}
    for st in steps:
        kids = [s.name for s in recs if s.parent == st.id]
        assert {k: kids.count(k) for k in want} == want
        assert len(kids) == sum(want.values())
    assert len(recs) == 1 + STEPS * (1 + sum(want.values())) + 1


def test_outputs_are_bit_identical_with_tracing_on_and_off():
    """A FLUX request's images and latents, and a training step's
    parameters and moments."""
    pipe = _pipe()
    tokens = _tokens(pipe.sampler.cfg)
    kw = dict(height=HW, width=HW, num_steps=STEPS)
    trace.clear()
    off = (pipe.generate(tokens, **kw),
           pipe.sampler.sample(tokens, pipe.pooled_from_prompt(""),
                               output_latents=True, **kw))
    trace.enable()
    try:
        on = (pipe.generate(tokens, **kw),
              pipe.sampler.sample(tokens, pipe.pooled_from_prompt(""),
                                  output_latents=True, **kw))
    finally:
        trace.disable()
    assert trace.spans()
    trace.clear()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    params = []
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        try:
            tr = _trainer()
            state = tr.init_state()
            tr.train_step(state, tr.prepare_batch(_batch()))
        finally:
            trace.disable()
        params.append(torch.cat([t.reshape(-1) for tree in (
            state["params"], state["opt_state"]["mu"],
            state["opt_state"]["nu"]) for _, t in tree_leaves(tree)]))
    trace.clear()
    assert torch.equal(*params)
