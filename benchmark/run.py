"""Runs one cell of the benchmark and prints its result as the last line
of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, weights made on the card from the
seed, warming the cell's own shapes) runs from the process's start to the
window's; the window then drives the cell's entry for ``--seconds``. With
``--trace 1`` a stretch of the window runs under torch.profiler and the
result carries the cell's per-layer metrics and ``breakdown``; without,
its end-to-end metrics. After the window the program's state is freed and
the plain reference judges what the timed path produced (training: the
first steps set-up drove through the window's call and three steps more
from the state the window left; rendering: a request of the window):
``correct``, with each number compared beside its limit, last on
standard error and last in the result. Without as many CUDA cards as the cell asks for it exits 2 and
prints no result."""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from benchmark import harness


def process_age_s() -> float:
    """Seconds since this process started (/proc's start time)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", files=None) -> dict:
    """One run of ``workload``; returns the result line's object. Tests
    pass ``files`` (tiny copies of the cell's) and run it on the CPU."""
    import torch

    files = files or harness.cell_files(workload)
    spec = harness.benchmark_spec()
    cell, config, traffic = files["cell"], files["config"], files["traffic"]
    device = torch.device(device)
    driver = harness.driver_class(cell["driver"])(cell, config, traffic,
                                                  seed, device)
    driver.trace = trace
    driver.setup()
    harness.synchronize(device)
    setup_s = process_age_s()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans = harness.Spans()
    tracer = None
    out_dir = Path(tempfile.gettempdir())
    if trace:
        tracer = harness.Tracer(
            out_dir / f"thinkdiff_bench_{workload}_trace.json", device)
    win = harness.run_window(driver, seconds, spans, device, tracer)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    units, tr = win["units"], win["trace"]
    e2e = driver.window_metrics([u for u, _ in units], win["total_s"])
    e2e["setup_s"] = setup_s
    e2e["peak_mem_gib"] = peak / 2 ** 30
    rec = {"path": driver.path, "spans": spans, "units": units,
           "plain_s": win["plain_s"], "trace": tr}
    if trace:
        # the harness's spans beside the chrome trace: (name, start, end,
        # profiled), host seconds from the window's first unit
        t0 = spans.items[0][1] if spans.items else 0.0
        (out_dir / f"thinkdiff_bench_{workload}_spans.json").write_text(
            json.dumps([(n, a - t0, b - t0, p) for n, a, b, p in spans.items]))
    driver.after_window()
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in harness.metrics_of(spec, section, workload):
        value = (harness.metric_reader(m["name"])(rec) if trace
                 else e2e.get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu"),
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": len(units), "failed": 0,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = harness.breakdown(tr)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    out["setup_s"] = setup_s
    out["phases"] = str(getattr(driver, "phases", ""))
    plain = [s for s, (_, p) in zip(win["unit_s"], units) if not p]
    out["units"] = (f"{len(units)} units, median {statistics.median(plain):.4f}"
                    f" s" if plain else f"{len(units)} units")
    if tr is not None:
        out["units"] += (", the profiled one " + " ".join(
            f"{s:.4f} s" for s, (_, p) in zip(win["unit_s"], units) if p))
    # last, once every reader has run: nothing the run loaded may be JAX
    found = harness.jax_modules(sys.modules)
    if found:
        raise SystemExit(f"benchmark: JAX loaded in the benchmark's "
                         f"process: {found}")
    return out


def main(argv=None) -> int:
    harness.prepare_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(harness.cell_files(args.workload)["cell"].get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"benchmark: {args.workload} seed {args.seed} ran in "
          f"{time.perf_counter() - t0:.1f} s after import; set-up "
          f"{out['setup_s']:.2f} s ({out['phases']}); {out['units']}",
          file=sys.stderr)
    sys.stderr.flush()
    del out["setup_s"], out["phases"], out["units"]
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
