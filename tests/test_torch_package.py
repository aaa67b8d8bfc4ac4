"""The port as a package: no JAX anywhere in it, CPU tensors on the plain
paths with the launch counters untouched, its own model registry, and the
kernel build's inputs."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import thinkdiff_torch
from thinkdiff_torch import kernels
from thinkdiff_torch.kernels import _build
from thinkdiff_torch.ops.flash_attention import flash_attention, mha_reference
from thinkdiff_torch.ops.int8_matmul import s8_matmul, s8_matmul_reference
from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

REPO = Path(__file__).resolve().parents[1]


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        thinkdiff_torch.__path__, "thinkdiff_torch."))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'thinkdiff_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "thinkdiff_torch.engines.embed_engine" in _submodules()


def test_cpu_tensors_take_the_plain_paths():
    kernels.reset_launch_counts()
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32))
               for _ in range(3))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       mha_reference(q, k, v, causal=True))
    xq = torch.from_numpy(rs.randint(-127, 128, (4, 32)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-127, 128, (32, 16)).astype(np.int8))
    sx, s = torch.rand(4), torch.rand(16)
    assert torch.equal(s8_matmul(xq, sx, wq, s), s8_matmul_reference(xq, sx, wq, s))
    x, scale = torch.randn(3, 16), torch.randn(16)
    assert torch.equal(rmsnorm(x, scale), rmsnorm_reference(x, scale))
    assert kernels.launch_counts() == {"flash_attention_fwd": 0,
                                       "s8_matmul": 0, "rmsnorm": 0}


def test_own_registry_beside_the_jax_one():
    from thinkdiff_torch.engines.embed_engine import MllamaVllmGenerateModel
    from thinkdiff_tpu.core.registry import registry as jax_registry
    from thinkdiff_tpu.engines import embed_engine as je

    name = "mllama-vllm-generate-1"
    assert thinkdiff_torch.registry.get_model_class(name) is MllamaVllmGenerateModel
    assert jax_registry.get_model_class(name) is je.MllamaVllmGenerateModel
    with pytest.raises(KeyError):
        thinkdiff_torch.registry.register_model(name)(type("Other", (), {}))


def test_kernel_build_inputs():
    names = [p.name for p in _build.sources()]
    assert names == ["flash_fwd.cu", "s8_gemm.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path()
    assert path.parent == REPO / "build" and path.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_standin_tokenizer_round_trip():
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer

    tok = StandInTokenizer()
    ids = tok.encode("<|im_start|>user\nhello world<|im_end|>")
    assert ids[0] == 151644 and ids[-1] == 151645 and len(ids) == 6
    assert ids == tok.encode("<|im_start|>user\nhello world<|im_end|>")
    assert all(1 <= i < 151000 for i in ids[1:-1])
    assert tok.decode(ids) == " ".join(f"t{i}" for i in ids[1:-1])


@pytest.mark.gpu
def test_kernel_library_builds_and_loads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    lib = kernels.library()
    assert lib.thinkdiff_s8_gemm and lib.thinkdiff_flash_fwd
