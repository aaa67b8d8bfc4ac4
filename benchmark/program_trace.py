"""The program's own spans against the card's trace: what the profiled
unit's device time and idle gaps were for, by the span that launched
them.

The spans come from the port's tracer in this process
(``thinkdiff_torch.core.trace``), which records while a torch.profiler
session does: the harness's profiler turns it on for exactly the profiled
unit. The device's events come from the chrome trace ``benchmark/run.py``
exported in this process, ``<tempdir>/thinkdiff_bench_<workload>_trace.json``,
the workload from the process's ``--workload``. Both are on one clock:
a span's ns less the trace's ``baseTimeNanoseconds`` is on the events'
``ts`` axis (microseconds). Each kernel, copy or set is linked by its
``correlation`` to its launch (the ``cuda_runtime`` or ``cuda_driver``
call) and belongs to the innermost span open when the launch began, on
any thread (autograd's device thread launches the backward). With no
tracer in the program, no spans or no trace, a reader gets None.

    python3 -m benchmark.program_trace --workload <cell> --seed <n> --seconds <s>

runs a cell traced and prints, beside its result, the profiled unit's
device time and idle gaps by span and each span's costliest kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

from benchmark import harness

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# a runtime call that only enqueues returns sooner; the rest of a longer
# one is the host blocked (a synchronize, a pageable copy, a full queue)
ENQUEUE_US = 20.0
OUTSIDE = "outside every span"


class Reading(NamedTuple):
    """The profiled unit on the trace's clock, in microseconds."""
    spans: List[tuple]    # (name, start, end), by start
    device: List[tuple]   # (cat, name, start, dur, owner span index | None)
    calls: List[tuple]    # host launch-API calls (start, dur, thread)
    launch: List[Optional[float]]  # each device event's launch start
    busy: List[tuple]     # the union of the device events' intervals


def workload_arg(argv: Sequence[str] = None) -> Optional[str]:
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--workload" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--workload="):
            return a.split("=", 1)[1]
    return None


def trace_path(workload: str) -> Path:
    """Where ``benchmark/run.py`` exports a traced run's chrome trace."""
    return Path(tempfile.gettempdir()) / \
        f"thinkdiff_bench_{workload}_trace.json"


def program_spans() -> list:
    try:
        from thinkdiff_torch.core import trace
    except ImportError:  # a program without the tracer
        return []
    return trace.spans()


def innermost(spans: List[tuple], times: List[Optional[float]]):
    """For each time, the index of the innermost (latest-started) span of
    ``spans`` (by start) open at it, start <= t < end, or None."""
    out = [None] * len(times)
    active, j = [], 0
    for i in sorted((i for i, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            active.append(j)
            j += 1
        while active and spans[active[-1]][2] <= t:
            active.pop()
        if active:
            out[i] = active[-1]
    return out


def reading(data: dict, records) -> Optional[Reading]:
    """``data`` (a chrome trace) with the program's ``records``."""
    base = int(data.get("baseTimeNanoseconds", 0))
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    launches, calls, dev = {}, [], []
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in LAUNCH_CATS:
            launches[args.get("correlation")] = float(e["ts"])
            calls.append((float(e["ts"]), float(e.get("dur", 0)),
                          e.get("tid")))
        elif cat in harness.DEVICE_CATS and not (
                cat == "kernel" and harness.ANCHOR_KERNEL in e["name"]):
            dev.append((cat, e["name"], float(e["ts"]),
                        float(e.get("dur", 0)), args.get("correlation")))
    if not dev:
        return None
    lo = min([d[2] for d in dev] + [c[0] for c in calls])
    hi = max(d[2] + d[3] for d in dev)
    spans = sorted(((s.name, (s.start_ns - base) / 1e3,
                     (s.end_ns - base) / 1e3) for s in records),
                   key=lambda s: s[1])
    spans = [s for s in spans if s[2] >= lo and s[1] <= hi]
    if not spans:
        return None
    launch = [launches.get(d[4]) for d in dev]
    owner = innermost(spans, launch)
    busy: List[list] = []
    for a, b in sorted((d[2], d[2] + d[3]) for d in dev):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return Reading(spans, [d[:4] + (o,) for d, o in zip(dev, owner)],
                   calls, launch, [tuple(b) for b in busy])


_cache: Dict[tuple, Optional[Reading]] = {}


def load(workload: Optional[str]) -> Optional[Reading]:
    """The reading of ``workload``'s exported trace with the spans the
    program holds; read once a trace file."""
    if workload is None:
        return None
    records = program_spans()
    path = trace_path(workload)
    if not records or not path.exists():
        return None
    key = (str(path), path.stat().st_mtime_ns, len(records))
    if key not in _cache:
        _cache.clear()
        with open(path) as f:
            _cache[key] = reading(json.load(f), records)
    return _cache[key]


def read(rec, path: str) -> Optional[Reading]:
    if rec["path"] != path or rec["trace"] is None:
        return None
    return load(workload_arg())


def count(r: Reading, name: str) -> int:
    return sum(1 for s in r.spans if s[0] == name)


def within(r: Reading, names, times) -> List[bool]:
    """Whether each time lies inside a span named in ``names``."""
    sel = [s for s in r.spans if s[0] in names]
    return [o is not None for o in innermost(sel, times)]


# -- the readers -------------------------------------------------------------

def device_ms(rec, path: str, phase: str, per: str):
    """Device ms a ``per`` span of what ``phase`` launched (events whose
    innermost span at launch is ``phase``)."""
    r = read(rec, path)
    if r is None or not count(r, phase) or not count(r, per):
        return None
    us = sum(d[3] for d in r.device
             if d[4] is not None and r.spans[d[4]][0] == phase)
    return us / 1e3 / count(r, per)


def blocked_ms(rec, path: str, names, per: str):
    """Host ms a ``per`` span inside launch-API calls begun in a span
    named in ``names``, each call's time beyond ``ENQUEUE_US``. A call
    nested in another of its thread (a driver call inside a runtime one)
    is the outer call's time."""
    r = read(rec, path)
    if r is None or not count(r, per):
        return None
    calls, last_end = [], {}
    for a, d, tid in sorted(r.calls, key=lambda c: (str(c[2]), c[0])):
        if a >= last_end.get(tid, float("-inf")):
            calls.append((a, d))
            last_end[tid] = a + d
    inside = within(r, names, [a for a, _ in calls])
    us = sum(max(0.0, d - ENQUEUE_US)
             for (_, d), ok in zip(calls, inside) if ok)
    return us / 1e3 / count(r, per)


def host_gap_ms(rec, path: str, name: str, per: str):
    """Device-idle ms a ``per`` span in the gaps that began while the host
    was inside a ``name`` span."""
    r = read(rec, path)
    if r is None or not count(r, per):
        return None
    gaps = [(prev[1], nxt[0]) for prev, nxt in zip(r.busy, r.busy[1:])]
    inside = within(r, (name,), [a for a, _ in gaps])
    return sum(b - a for (a, b), ok in zip(gaps, inside) if ok) \
        / 1e3 / count(r, per)


def launches(rec, path: str, name: str, per: str):
    """Kernels a ``per`` span launched inside a ``name`` span."""
    r = read(rec, path)
    if r is None or not count(r, per):
        return None
    kernels = [t for d, t in zip(r.device, r.launch) if d[0] == "kernel"]
    return sum(within(r, (name,), kernels)) / count(r, per)


# -- the split of a traced run -----------------------------------------------

def short(name: str) -> str:
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(", 1)
    return (name[:cut] if cut > 0 else name)[:120]


def split(r: Reading, top: int = 8) -> dict:
    """Device seconds by the span that launched them (with the share
    launched outside every span), each span's costliest kernels, and idle
    seconds by the span the host was in when each gap began."""
    by, kernels = {}, {}
    for cat, name, _, dur, o in r.device:
        owner = r.spans[o][0] if o is not None else OUTSIDE
        by[owner] = by.get(owner, 0.0) + dur / 1e6
        k = kernels.setdefault(owner, {})
        k[short(name)] = k.get(short(name), 0.0) + dur / 1e6
    gaps = [(prev[1], nxt[0]) for prev, nxt in zip(r.busy, r.busy[1:])]
    idle = {}
    for (a, b), o in zip(gaps, innermost(r.spans, [a for a, _ in gaps])):
        owner = r.spans[o][0] if o is not None else OUTSIDE
        idle[owner] = idle.get(owner, 0.0) + (b - a) / 1e6
    total = sum(by.values())
    return {"device_s": by, "outside_share": by.get(OUTSIDE, 0.0) / total,
            "spans": {n: count(r, n) for n in sorted({s[0]
                                                     for s in r.spans})},
            "kernels": {o: sorted(k.items(), key=lambda kv: -kv[1])[:top]
                        for o, k in kernels.items()},
            "idle_s": idle,
            "window_s": (r.busy[-1][1] - r.busy[0][0]) / 1e6,
            "busy_s": sum(b - a for a, b in r.busy) / 1e6}


def main(argv=None) -> int:
    harness.prepare_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from benchmark import run

    out = run.run_cell(args.workload, args.seed, args.seconds, True)
    r = load(args.workload)
    print(json.dumps({"workload": args.workload, "metrics": out["metrics"],
                      "device": out["device"], "units": out["units"],
                      "split": split(r) if r is not None else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
