"""The port's spans: where the program spends its time, recorded where the
work happens.

``span(name, **attrs)`` opens a span around a block::

    with trace.span("train.step", step=i):
        ...

A record (``Span``) holds its id, the id of the span that was innermost
open on its thread when it opened (None for a root), its name, its start
and end in integer ns, its attrs and its thread. The spans of one step or
request share their root's id through the parent chain.

Tracing is on while a ``torch.profiler`` session records (torch's
``_is_profiler_enabled``), whatever activities it records, and between
``enable()`` and ``disable()``. Off, ``span`` returns one shared no-op
context manager after reading those two flags: no clock read and no
record. Records stay in memory: ``spans()`` returns them, ``clear()``
drops them.

Stamps are ``time.time_ns()``, the clock the profiler's chrome trace is
written on: an event's ``ts`` is microseconds after the trace's
``baseTimeNanoseconds``. So a kernel's launch, the trace's
``cuda_runtime`` event, falls inside the span that launched it, on
whatever thread it was made (autograd's device thread launches the
backward while ``train.backward`` is open). ``add_to_chrome_trace``
writes the spans into such a trace, in a process row of their own.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

# the process row of the spans in a chrome trace
CHROME_PID = 0x7FFF0000
CHROME_PROCESS = "thinkdiff_torch spans"


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]
    thread: int


_on = False
_records: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "stack")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        _records.append(Span(self.id, self.parent, self.name, self.start_ns,
                             end, self.attrs, threading.get_ident()))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` around its block while
    tracing is on, and the shared no-op otherwise."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def spans() -> List[Span]:
    """The records so far, in the order their spans closed."""
    return list(_records)


def clear() -> None:
    _records.clear()


def chrome_events(records: List[Span], base_ns: int = 0) -> List[dict]:
    """``records`` as chrome-trace complete events on the clock of a trace
    whose ``baseTimeNanoseconds`` is ``base_ns``, in their own process
    row (one row a thread)."""
    out = [{"ph": "M", "name": "process_name", "pid": CHROME_PID,
            "args": {"name": CHROME_PROCESS}}]
    for s in records:
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": CHROME_PID, "tid": s.thread,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, **s.attrs}})
    return out


def add_to_chrome_trace(path: str, records: Optional[List[Span]] = None
                        ) -> int:
    """Appends ``records`` (default: every record) to the chrome trace at
    ``path``, on its own clock; returns how many."""
    records = spans() if records is None else records
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += chrome_events(
        records, int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(records)
