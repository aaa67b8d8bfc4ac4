"""A later change adds a cell and a per-layer metric as new files and
entries: in a copy of the benchmark, a new configuration, traffic mix,
workload and metric reader are added, BENCHMARK.json gains their entries,
and the harness runs the new cell (on the CPU, tiny) with the new metric
in its result; no file of the benchmark's folder is edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.tests import tiny

READER = '''"""steps_seen.train: the window's training steps."""


def read(rec):
    if rec["path"] != "train_step":
        return None
    return float(len(rec["units"]))
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_need_no_edit(tmp_path):
    co = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, co / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digests(co / "benchmark")
    files = tiny.train()
    b = co / "benchmark"
    (b / "configs" / "tiny-aligner.json").write_text(
        json.dumps(files["config"]))
    (b / "traffic" / "tiny-padded.json").write_text(
        json.dumps(files["traffic"]))
    cell = dict(files["cell"], config="tiny-aligner", traffic="tiny-padded")
    (b / "workloads" / "tiny-train.json").write_text(json.dumps(cell))
    (b / "metrics" / "steps_seen.train.py").write_text(READER)
    spec = harness.benchmark_spec()
    spec["configs"].append({"name": "tiny-aligner", "source": "tiny",
                            "file": "benchmark/configs/tiny-aligner.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": "tiny-train", "config": "tiny-aligner",
                              "traffic": "tiny-padded", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "train-lvlm-bs32" in m.get("workloads", []):
            m["workloads"].append("tiny-train")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "engines/trainer.py",
                              "moves": "train_samples_per_s",
                              "workloads": ["tiny-train"]})
    (co / "BENCHMARK.json").write_text(json.dumps(spec))

    script = ("import json\nfrom benchmark import run\n"
              "print(json.dumps(run.run_cell('tiny-train', 5, 0.5, {t}, "
              "device='cpu')))")
    env = dict(os.environ, PYTHONPATH=f"{co}{os.pathsep}{harness.CHECKOUT}")
    for trace in (False, True):
        out = subprocess.run([sys.executable, "-c",
                              script.format(t=trace)], cwd=co, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"]
        if trace:
            assert res["metrics"]["steps_seen.train"]["value"] >= 1
            assert "mfu.train" in res["metrics"]
        else:
            assert set(res["metrics"]) == {"train_samples_per_s",
                                           "peak_mem_gib", "setup_s"}
    after = digests(co / "benchmark")
    assert {k: after[k] for k in before} == before
