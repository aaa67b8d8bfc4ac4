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
from thinkdiff_torch.ops.fused_sample import (
    fused_lm_sample, fused_lm_sample_reference, gumbel_noise, pack_lm_head)
from thinkdiff_torch.ops.int8_matmul import s8_matmul, s8_matmul_reference
from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference
from thinkdiff_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

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
    for name in ("engines.embed_engine", "engines.trainer", "models.t5",
                 "ops.int8_matmul", "models.qdense",
                 "models.aligner_lvlm", "models.projector", "ops.chunked_ce",
                 "core.optim", "data.packing", "data.synthetic",
                 "core.config", "core.registry", "core.logging",
                 "core.distributed", "core.utils", "data.tario",
                 "data.wids_reader", "data.processors", "data.pipeline",
                 "data.collators", "data.builders", "tasks.base_task",
                 "tasks.image_text_process_data", "engines.checkpoint",
                 "runners.runner_base", "runners.runner_process_data",
                 "train", "scripts.common",
                 "scripts.generate_embedding_webdataset", "models.flux",
                 "models.clip_text", "models.flux_vae",
                 "engines.flux_sampler", "engines.pipeline",
                 "scripts.test_mllama_t5_decoder_flux",
                 "scripts.test_mllama_t5_decoder_text", "parallel",
                 "parallel.mesh", "data.native", "data.randaugment",
                 "models.clip_scorer", "models.llama", "models.lora",
                 "scripts.score_cobsat", "scripts.get_wids_input_json",
                 "scripts.convert_checkpoint"):
        assert f"thinkdiff_torch.{name}" in _submodules()


def test_no_module_level_triton_or_jax_package_import():
    """Importing every module of the port loads neither Triton (the kernels
    are CUDA C++ in one library) nor anything of the JAX package, and no
    source of the port names Triton or the JAX package in an import."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {_submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('triton', 'thinkdiff_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    pkg = Path(thinkdiff_torch.__file__).parent
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in (
                    "triton", "thinkdiff_tpu", "jax"), (path, line)


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
    qp = torch.randn(2, 4, 128)
    pools = [torch.randn(5, 2, 8, 128) for _ in range(2)]
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([12, 5], dtype=torch.int32)
    assert torch.equal(paged_attention(qp, *pools, table, lens),
                       paged_attention_reference(qp, *pools, table, lens))
    pack = pack_lm_head(wq, s)
    hidden, blocked = torch.randn(4, 32), torch.zeros(4)
    seed = torch.tensor([3, 4], dtype=torch.int32)
    for noise in (False, True):
        g = gumbel_noise(seed, 4, 128) if noise else None
        assert torch.equal(
            fused_lm_sample(hidden, pack, blocked, seed, temperature=0.6,
                            noise=noise),
            fused_lm_sample_reference(hidden, pack, blocked, temperature=0.6,
                                      noise=g))
    # the backward wrappers too
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        logsumexp_reference)
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul_bwd, s8_matmul_bwd_reference)

    lse = logsumexp_reference(q, k, causal=True)
    args = (q, k, v, None, None, True, 0.25, None, None, lse, q)
    for a, b in zip(flash_attention_backward(*args),
                    flash_attention_backward_reference(*args)):
        assert torch.equal(a, b)
    gq = torch.from_numpy(rs.randint(-127, 128, (4, 16)).astype(np.int8))
    assert torch.equal(s8_matmul_bwd(gq, sx, wq), s8_matmul_bwd_reference(gq, sx, wq))
    xg = x.clone().requires_grad_(True)
    rmsnorm(xg, scale).sum().backward()
    assert kernels.launch_counts() == {
        "flash_attention_fwd": 0, "s8_matmul": 0, "rmsnorm": 0,
        "paged_attention": 0, "fused_lm_sample": 0, "flash_attention_dq": 0,
        "flash_attention_dkv": 0, "s8_matmul_bwd": 0, "int8_matmul": 0,
        "int8_matmul_wide_fwd": 0, "int8_matmul_wide_bwd": 0,
        "s8_matmul_qx": 0}


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
    assert names == ["flash_bwd.cu", "flash_fwd.cu", "fused_sample.cu",
                     "int8_gemv.cu", "int8_wide.cu", "paged_decode.cu",
                     "rmsnorm.cu", "s8_gemm.cu", "s8_gemm_bwd.cu",
                     "s8_gemm_qx.cu"]
    # the bf16 mma step (and ldmatrix) is the GEMV's and the paged decode's,
    # the Hopper PTX (TMA, mbarriers, wgmma, cached tensor maps) every TMA
    # kernel's, s8_wgmma.cuh the w8a8 GEMMs' mainloop (#2, #7 and #12), and
    # s8_quant.cuh the per-row quantization of #8 and #12; no mma.sync int8
    # tile is left; an edit to any names a new library
    assert [p.name for p in _build.headers()] == ["bf16_mma.cuh",
                                                  "hopper.cuh",
                                                  "s8_quant.cuh",
                                                  "s8_wgmma.cuh"]
    assert not (_build.CSRC / "s8_tile.cuh").exists()
    # #8 and #12: s8 wgmma on a TMA ring, each row of x quantized once in
    # the same launch (tickets, a ready counter acquired before the TMA of
    # the quanta, after the async-proxy fence), one kernel each, the
    # counters reset by the last CTA
    quant = (_build.CSRC / "s8_quant.cuh").read_text()
    for call in ("__fdiv_rn(", "rintf(", "__frcp_rn(127.0f)", "atomicAdd(",
                 "__threadfence()", "ld_acquire_gpu(",
                 "fence_proxy_async_global()"):
        assert call in quant
    for name in ("fused_sample.cu", "s8_gemm_qx.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "hopper.cuh"' in src and '#include "s8_quant.cuh"' in src
        assert "s8_tile.cuh" not in src and "mma.sync" not in src
        assert src.count("__global__") == 1
        assert "quant_rows_once<" in src and "quant_exit(" in src
    sample = (_build.CSRC / "fused_sample.cu").read_text()
    for call in ("wgmma_s8<N>(", "tma_load_4d(", "mbar_wait(", "cached_map_2d(",
                 "CU_TENSOR_MAP_DATA_TYPE_UINT8", "wait_tile(", "atomicMax(",
                 "atomicExch(", "logf(", "__fadd_rn(", "__fmul_rn("):
        assert call in sample
    assert "__logf(" not in sample
    assert "s8_body<BM, BN, true, OUTF32>(" in (_build.CSRC / "s8_gemm_qx.cu").read_text()
    # #9 and #4: bandwidth kernels on a TMA ring (mma.sync products), the
    # split reduced in the same launch through a counter: no second kernel
    for name in ("int8_gemv.cu", "paged_decode.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "bf16_mma.cuh"' in src and '#include "hopper.cuh"' in src
        for call in ("tma_load_4d(", "mbar_wait(", "cached_map_2d(",
                     "mma_bf16(", "atomicAdd(", "__threadfence()"):
            assert call in src
        assert src.count("__global__") == 1
    assert "ldsm_x4_t(" in (_build.CSRC / "paged_decode.cu").read_text()
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    # the flash forward and backward and the w8a8 and wide GEMMs multiply
    # with wgmma (bf16 -> f32, A from shared memory or registers, and s8 ->
    # s32) on tiles that TMA copies into an mbarrier ring
    for op in ("wgmma.mma_async", ".s32.s8.s8", "cp.async.bulk.tensor",
               "mbarrier.try_wait.parity", "cached_map_2d("):
        assert op in hopper
    assert "m64n256k16.f32.bf16.bf16" in hopper
    # #2, #7 and #12: the s8 wgmma on a TMA ring, no mma.sync tile; int8
    # tiles through UINT8 maps (TMA has no signed 8-bit type); #2 and #7
    # add a split's partials in a second kernel; #12 waits for its row
    # tiles and never splits, so it has no second kernel
    s8 = (_build.CSRC / "s8_wgmma.cuh").read_text()
    assert '#include "hopper.cuh"' in s8 and "mma.sync" not in s8
    for call in ("wgmma_s8<", "tma_load_4d(", "mbar_wait(", "cached_map_2d(",
                 "CU_TENSOR_MAP_DATA_TYPE_UINT8", "wait_tile(",
                 "s8_split_sum<<<"):
        assert call in s8
    qx = (_build.CSRC / "s8_gemm_qx.cu").read_text()
    assert "s8_split_sum" not in qx and "s8_launch<" not in qx
    for name in ("s8_gemm.cu", "s8_gemm_bwd.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "hopper.cuh"' in src
        assert '#include "s8_wgmma.cuh"' in src
        assert "s8_tile.cuh" not in src and "mma.sync" not in src
        assert "s8_wgmma(" in src
    # #10 and #11: bf16 wgmma with the weight as A, converted from int8 in
    # registers (16-bit loads, or ldmatrix .trans on byte pairs for the
    # input gradient), on a TMA ring of activations and UINT8 weight tiles,
    # and a TMA-store epilogue; no mma.sync route is left
    wide = (_build.CSRC / "int8_wide.cu").read_text()
    assert '#include "hopper.cuh"' in wide
    assert "bf16_mma.cuh" not in wide and "mma.sync" not in wide
    assert "mma_bf16(" not in wide
    for call in ("wgmma_rs_kb<BR>(", "tma_load_4d(", "mbar_wait(",
                 "tma_store_4d(", "regs_alloc<", "CU_TENSOR_MAP_DATA_TYPE_UINT8",
                 "ldmatrix.sync.aligned.m8n8.x4.trans", "stmatrix.sync",
                 "s8sel_to_bf16("):
        assert call in wide
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "hopper.cuh"' in src
        assert '#include "bf16_mma.cuh"' not in src
        for call in ("wgmma_ss<", "wgmma_rs<", "tma_load_4d(", "mbar_wait("):
            assert call in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path()
    assert path.parent == REPO / "build" and path.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_default_device_is_the_card(monkeypatch):
    """EmbedEngine, EmbedEngine.from_config, MllamaVllmGenerateModel, the
    aligner MllamaT5EmbedDecoder and the Trainer default to CUDA; without a
    card they raise and never build on the CPU."""
    from thinkdiff_torch.engines import embed_engine as te
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder
    from thinkdiff_torch.models.qwen2_vl import Qwen2VLConfig

    tiny = {"vlm_hidden_size": 8, "t5_config": dict(
        vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_decoder_layers=1,
        num_heads=4)}
    cpu_model = MllamaT5EmbedDecoder(tiny, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
            lambda: te.EmbedEngine(Qwen2VLConfig.tiny(), {}),
            lambda: te.EmbedEngine.from_config({}),
            lambda: te.MllamaVllmGenerateModel({"vllm_config": {}}),
            lambda: MllamaT5EmbedDecoder(tiny),
            lambda: Trainer(cpu_model, {})):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()
    assert te.resolve_device("cpu") == torch.device("cpu")


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
    assert (lib.thinkdiff_s8_gemm and lib.thinkdiff_flash_fwd
            and lib.thinkdiff_paged_decode and lib.thinkdiff_fused_sample
            and lib.thinkdiff_s8_gemm_bwd and lib.thinkdiff_flash_bwd_dq
            and lib.thinkdiff_flash_bwd_dkv and lib.thinkdiff_int8_gemv
            and lib.thinkdiff_int8_wide_fwd and lib.thinkdiff_int8_wide_bwd
            and lib.thinkdiff_s8_gemm_qx)
