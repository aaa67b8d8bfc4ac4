"""What the per-layer readers (``metrics/<name>.py``) share. Each takes
the run's record: ``path`` (what the cell's driver drives), ``spans``,
``units`` ([(what a unit completed, profiled)]: its operations ``ops``
and kernel calls ``calls``, [(work item, count)]), ``plain_s`` (the
window's seconds outside the profiled stretch), ``trace`` (the stretch's
reading, or None). A reader that finds nothing to read returns None."""

from __future__ import annotations

from benchmark import harness
from benchmark.peaks import PEAK_OPS, bound_s


def mfu(rec, path: str):
    """The operations the unprofiled units required over their seconds, as
    a share of the card's peak."""
    if rec["path"] != path or rec["plain_s"] <= 0:
        return None
    ops = sum(u["ops"] for u, profiled in rec["units"] if not profiled)
    return 100.0 * ops / rec["plain_s"] / PEAK_OPS["bf16"] if ops else None


def roofline(rec, path: str, operation: str):
    """The least time the profiled units' ``operation`` calls could take
    over the device time of the kernels that count as it."""
    if rec["path"] != path or rec["trace"] is None:
        return None
    bound = sum(bound_s(c["bytes"], c["ops"]) * n
                for u, profiled in rec["units"] if profiled
                for c, n in u["calls"] if c["op"] == operation)
    device = harness.matching_seconds(rec["trace"]["kernels"],
                                      harness.kernel_patterns(operation))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


def idle(rec, path: str):
    """The share of the profiled stretch with nothing running on the
    device."""
    tr = rec["trace"]
    if rec["path"] != path or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def span_ms(rec, path: str, names, per: str = None):
    """Milliseconds of the named spans an unprofiled unit (or a unit's
    ``per`` count: steps, images), summed over the names."""
    if rec["path"] != path:
        return None
    plain = [u for u, profiled in rec["units"] if not profiled]
    total = sum(sum(rec["spans"].unprofiled(n)) for n in names)
    count = sum(u[per] for u in plain) if per else len(plain)
    return 1e3 * total / count if total and count else None
