"""What every cell shares: the files a cell is made of, found by name;
spans around the calls into each layer; the window loop; the profiler's
stretch and the reading of its trace; the result line.

A driver (``drivers/<name>.py``) defines ``Driver(cell, config, traffic,
seed, device)`` with ``setup()``, ``unit(i, spans)`` (one step or one
request of the window; returns what it completed), ``window_metrics(
units, seconds)``, ``after_window()`` (what the check needs beyond the
window, driven through the window's own call), ``release()`` and
``check()``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# kernel and build caches of the program, at fixed paths in the checkout
# (the kernel library itself builds into the checkout's build/)
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / ".cache" / "triton",
              "TORCH_EXTENSIONS_DIR": ROOT / ".cache" / "torch_extensions"}
# libraries that would load JAX by themselves if let
NO_JAX_ENV = {"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "orbax", "thinkdiff_tpu")


def prepare_env() -> None:
    for k, v in NO_JAX_ENV.items():
        os.environ[k] = v
    for k, path in CACHE_DIRS.items():
        os.environ[k] = str(path)


def jax_modules(modules) -> List[str]:
    """Modules whose top-level name (before the first dot) is JAX's or the
    JAX package's, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in JAX_NAMES)


# -- the files of a cell ------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_files(name: str) -> dict:
    """The workload file of ``name`` with its configuration and traffic
    files."""
    cell = load_json(ROOT / "workloads" / f"{name}.json")
    return {"cell": cell,
            "config": load_json(ROOT / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(ROOT / "traffic" / f"{cell['traffic']}.json")}


def traffic_module(traffic: dict):
    """The generator a traffic file names (``traffic/<generator>.py``)."""
    return importlib.import_module(f"benchmark.traffic.{traffic['generator']}")


def driver_class(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def metric_reader(name: str):
    """``read(rec)`` of ``metrics/<name>.py`` (names carry dots)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}",
        ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(operation: str) -> List[str]:
    """Kernel-name fragments that count as ``operation``'s device time:
    one a line, from every ``kernels/<operation>/*.txt``."""
    out = []
    for f in sorted((ROOT / "kernels" / operation).glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    return out


def metrics_of(spec: dict, section: str, workload: str) -> List[dict]:
    return [m for m in spec[section]
            if workload in m.get("workloads", [workload])]


# -- spans --------------------------------------------------------------------

class Spans:
    """Host-clock spans (name, start, end, profiled) around the calls the
    benchmark makes into the program. The profiler records no host
    activity, so the spans of the profiled stretch are placed on the
    trace's clock by the tracer's anchor, to say what the host was doing
    in a device gap."""

    def __init__(self):
        self.items: List[tuple] = []
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.items.append((name, t0, time.perf_counter(), self.profiling))

    def unprofiled(self, name: str) -> List[float]:
        """Seconds of each ``name`` span outside the profiled stretch."""
        return [t1 - t0 for n, t0, t1, p in self.items if n == name and not p]


class Phases:
    """Seconds of set-up's phases, printed on standard error."""

    def __init__(self, device):
        self.device, self.items = device, []
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.items.append((name, now - self.t))
        self.t = now

    def __str__(self):
        return ", ".join(f"{n} {s:.2f} s" for n, s in self.items)


def synchronize(device) -> None:
    import torch

    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize()


# -- the profiled stretch -----------------------------------------------------

class Tracer:
    """torch.profiler over a stretch of whole units, recording the device's
    activity alone: on a card its kernels, copies and sets and the runtime
    calls that launched them, and no host operator or range, which would
    slow a host-bound step. The chrome trace goes to ``path`` and is read
    back by ``read_trace``. (On the CPU, for tests, the CPU's operators
    stand in for the device's.)"""

    def __init__(self, path: Path, device):
        self.path, self.device = path, device
        self.cuda = getattr(device, "type", device) == "cuda"
        self.prof = None
        self.anchor = 0.0

    def start(self):
        import torch

        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if self.cuda else act.CPU])
        self.prof.__enter__()
        synchronize(self.device)
        # the host clock at a marked launch, which the trace records on
        # its own clock: it places the harness's spans on the trace
        self.anchor = time.perf_counter()
        if self.cuda:
            torch.cuda._sleep(1000)
        else:
            with torch.profiler.record_function(ANCHOR):
                pass

    def stop(self, spans: Spans) -> dict:
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        host = [(n, a - self.anchor, b - self.anchor)
                for n, a, b, profiled in spans.items if profiled]
        return read_trace(self.path, host, self.cuda)


ANCHOR = "bench.anchor"
ANCHOR_KERNEL = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: Path, host_spans=(), cuda: bool = True) -> dict:
    """From a chrome trace: the stretch, from its first device operation's
    start to its last one's end (the anchor left out); the device-busy
    seconds (the union of kernel, copy and set intervals); seconds by
    kernel name; and the idle gaps, each named by the innermost of
    ``host_spans`` ((name, start, end), host seconds from the anchor) the
    host was in when the gap began."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    cats = DEVICE_CATS if cuda else ("cpu_op",)
    anchor_corr, anchor_ts = None, None
    for e in events:
        if cuda and e.get("cat") == "kernel" and ANCHOR_KERNEL in e["name"]:
            anchor_corr = e.get("args", {}).get("correlation")
        if not cuda and e.get("name") == ANCHOR:
            anchor_ts = float(e["ts"])
    if anchor_corr is not None:
        anchor_ts = next((float(e["ts"]) for e in events
                          if e.get("cat") == "cuda_runtime"
                          and e.get("args", {}).get("correlation")
                          == anchor_corr), None)
    dev, by_name = [], {}
    for e in events:
        if e.get("cat") not in cats or (
                anchor_corr is not None
                and e.get("args", {}).get("correlation") == anchor_corr):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        dev.append((a, b))
        if e["cat"] in ("kernel", "cpu_op"):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
    if not dev:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "gaps": []}
    dev.sort()
    merged: List[list] = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    spans = ([(anchor_ts + 1e6 * a, anchor_ts + 1e6 * b, n)
              for n, a, b in host_spans] if anchor_ts is not None else [])
    gaps = []
    for (_, prev), (a, _) in zip(merged, merged[1:]):
        inside = [s for s in spans if s[0] <= prev < s[1]]
        name = (max(inside, key=lambda s: s[0])[2] if inside
                else "outside the benchmark's spans")
        gaps.append((name, (a - prev) / 1e6))
    return {"window_s": (merged[-1][1] - merged[0][0]) / 1e6,
            "busy_s": sum(b - a for a, b in merged) / 1e6,
            "kernels": by_name, "gaps": gaps}


def matching_seconds(kernels: Dict[str, float], patterns: List[str]) -> float:
    return sum(s for name, s in kernels.items()
               if any(p in name for p in patterns))


def breakdown(trace: dict) -> dict:
    def short(name):
        if name.startswith("void "):
            name = name[5:]
        cut = name.find("(", 1)
        return (name[:cut] if cut > 0 else name)[:160]

    ops: Dict[str, float] = {}
    for name, s in trace["kernels"].items():
        ops[short(name)] = ops.get(short(name), 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


# -- the window ---------------------------------------------------------------

def run_window(driver, seconds: float, spans: Spans, device,
               tracer: Optional[Tracer] = None) -> dict:
    """``driver.unit(i, spans)`` back to back until ``seconds`` have passed
    on the host clock at a unit's end, then a synchronize. With a tracer,
    the first unit after a third of the window runs under the profiler,
    synchronized on both sides. Returns ``units`` ([(what the unit
    returned, profiled)]), ``unit_s`` (each unit's host seconds), the
    window's seconds ``total_s``, those outside the profiled unit
    ``plain_s``, and ``trace`` (its reading, or None)."""
    units, unit_s, trace = [], [], None
    profiled_s = 0.0
    synchronize(device)
    t0 = time.perf_counter()
    while True:
        profiling = (tracer is not None and trace is None
                     and time.perf_counter() - t0 >= seconds / 3)
        if profiling:
            synchronize(device)
            p0 = time.perf_counter()
            tracer.start()
            spans.profiling = True
        u0 = time.perf_counter()
        units.append((driver.unit(len(units), spans), profiling))
        if profiling:
            synchronize(device)
        unit_s.append(time.perf_counter() - u0)
        if profiling:
            spans.profiling = False
            profiled_s = time.perf_counter() - p0
            trace = tracer.stop(spans)
            # reading the trace is not the program's time
            t0 += time.perf_counter() - p0 - profiled_s
        if time.perf_counter() - t0 >= seconds \
                and (tracer is None or trace is not None):
            break
    synchronize(device)
    total = time.perf_counter() - t0
    return {"units": units, "unit_s": unit_s, "total_s": total,
            "plain_s": total - profiled_s, "trace": trace}
