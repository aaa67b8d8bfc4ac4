"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
process imports the harness, every driver, reader, generator and
reference, runs a tiny cell of each driver on the CPU, and then holds no
module whose top-level name (before the first dot, compared whole) is
jax, jaxlib, flax, optax, orbax or thinkdiff_tpu."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

SCRIPT = r"""
import importlib, json, sys
from pathlib import Path
from benchmark import harness, run, control, readers
harness.prepare_env()
root = harness.ROOT
for sub in ("drivers", "traffic", "reference", "work", "weights"):
    for f in sorted((root / sub).glob("*.py")):
        if f.stem != "__init__":
            importlib.import_module(f"benchmark.{sub}.{f.stem}")
for f in sorted((root / "metrics").glob("*.py")):
    harness.metric_reader(f.stem)
from benchmark.tests import tiny
run.run_cell("train-lvlm-bs32", 1, 0.2, False, device="cpu",
             files=tiny.train())
run.run_cell("flux-1024", 1, 0.2, False, device="cpu", files=tiny.flux())
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_in_the_benchmark_process():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "thinkdiff_torch" in modules and "benchmark.run" in modules
    assert harness.jax_modules(modules) == []


def test_the_names_are_compared_whole():
    assert harness.jax_modules(["thinkdiff_torch", "thinkdiff_torch.ops",
                                "jaxtyping", "flaxen", "benchmark"]) == []
    assert harness.jax_modules(["jax.numpy", "thinkdiff_tpu", "flax"]) == [
        "flax", "jax.numpy", "thinkdiff_tpu"]


JAX_READER = '''"""jaxy.train: a reader that loads JAX when it reads."""


def read(rec):
    import jax

    return 1.0
'''


def test_a_reader_that_loads_jax_gives_no_result(tmp_path):
    """The look for JAX comes after every reader has run: a per-layer
    reader that imports (a stand-in for) jax inside ``read`` leaves the
    traced run with no result and a nonzero exit."""
    co = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, co / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (co / "benchmark" / "metrics" / "jaxy.train.py").write_text(JAX_READER)
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    spec = harness.benchmark_spec()
    spec["per_layer"].append({"name": "jaxy.train", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "device",
                              "moves": "train_samples_per_s",
                              "workloads": ["train-lvlm-bs32"]})
    (co / "BENCHMARK.json").write_text(json.dumps(spec))
    script = ("import json\nfrom benchmark import run\n"
              "from benchmark.tests import tiny\n"
              "print(json.dumps(run.run_cell('train-lvlm-bs32', 3, 0.3, True,"
              " device='cpu', files=tiny.train())))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(co), str(tmp_path / "stub"), str(harness.CHECKOUT)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=co, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "JAX loaded" in out.stderr and "jax" in out.stderr
