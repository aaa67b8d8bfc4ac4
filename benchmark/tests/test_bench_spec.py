"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files by name."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 << 10


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.CHECKOUT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_names_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= allowed | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_unique_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[section]]
        assert len(names) == len(set(names)), section
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    files = harness.cell_files(w["name"])
    cell = files["cell"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    assert w["config"] in {c["name"] for c in SPEC["configs"]}
    driver = harness.driver_class(cell["driver"])
    assert all(hasattr(driver, f) for f in (
        "setup", "unit", "window_metrics", "release", "check"))
    assert harness.traffic_module(files["traffic"]) is not None
    reported = harness.metrics_of(SPEC, "end_to_end", w["name"])
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.metrics_of(SPEC, "per_layer", w["name"])
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"].startswith("benchmark/configs/")
    assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    body = json.loads((harness.CHECKOUT / c["file"]).read_text())
    assert body["source"] == c["source"]
    assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_per_layer_workloads_exist():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in ALL_METRICS:
        assert set(m.get("workloads", [])) <= cells


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_run_seconds_fits_the_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    full = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert full <= 43200


def test_files_named_from_name_characters():
    for f in Path(harness.ROOT).rglob("*"):
        if "__pycache__" in f.parts or ".cache" in f.parts:
            continue
        rel = f.relative_to(harness.CHECKOUT).as_posix()
        assert PATH.match(rel), rel


def test_kernel_patterns_present():
    for op in ("attention", "rmsnorm"):
        assert harness.kernel_patterns(op)


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(len(SPEC["workloads"]) / 4))
