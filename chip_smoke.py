"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises and the exit code is
non-zero:
  1. device   — a CUDA card is required (there is no CPU fallback); prints
                its name and the nvidia-smi name and power limit;
  2. build    — compiles the CUDA kernels from csrc/ (one nvcc per source,
                all started together) into build/;
  3. kernels  — each hand-written kernel against its plain PyTorch version
                at the serving shapes, bf16, tolerance printed, with the
                median of 20 timed runs after 3 warm-ups for the kernel, the
                plain version and, where one PyTorch call computes the same
                function, that call (library_ms; the port never calls it);
                the least time the card could take (bound_ms) comes from the
                bytes and operations of the inputs;
  4. dense slice — configs/qwen2_vl_embed_ccsbu.yaml with the static-batch
                overrides (8 slots, no chunked prefill, no prefill-ahead, no
                pipelined EOS): 8 requests through MllamaVllmGenerateModel
                .forward, the one path whose prefill runs the flash kernel;
  5. paged slice — the same YAML as written (256 slots, prefill_chunk 128,
                preadmit_wave 64, eos_lag 2, exact nucleus sampler) on 512
                requests of one 448x448 image, each stopped at a seeded
                length from N(80, 40) clipped to [8, 256];
  6. gumbel slice — the YAML with sampler gumbel and 64 slots, 128
                requests: the fused sampler serves first tokens and decode;
  7. profile  — one paged decode step at 256 slots under torch.profiler:
                device-busy share and the top kernels.
Every slice runs Qwen2-VL-2B at full width and depth on seeded random
weights (w8a8 LM with fused projections, weight-only int8 vision) and the
stand-in tokenizer, on the engine's default device. Each checks output
shapes, finiteness, vocabulary range and stop lengths, that the kernels of
its path launched (counts set to 0 just before, read just after), and a
teacher-forced forward over one request that reproduces its served hidden
states. The last two lines are a JSON object with per-kernel results and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parent / "configs" / "qwen2_vl_embed_ccsbu.yaml"
# the dense static-batch serving slice of the precompute configuration
DENSE_OVERRIDES = {"max_num_seqs": 8, "enable_chunked_prefill": False,
                   "prefill_chunk": 0, "preadmit_wave": 0, "eos_lag": 0}
GUMBEL_OVERRIDES = {"sampler": "gumbel", "max_num_seqs": 64}
CHUNK = 32  # decode steps between scheduler passes (generate_many's default)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
TPU_KERNELS = {
    "flash_attention_fwd": ("cuda", "thinkdiff_torch/csrc/flash_fwd.cu",
                            "thinkdiff_tpu/ops/flash_attention.py:64"),
    "s8_matmul": ("cuda", "thinkdiff_torch/csrc/s8_gemm.cu",
                  "thinkdiff_tpu/ops/int8_matmul.py:291"),
    "rmsnorm": ("triton", "thinkdiff_torch/ops/norms.py",
                "thinkdiff_tpu/ops/norms.py:27"),
    "paged_attention": ("cuda", "thinkdiff_torch/csrc/paged_decode.cu",
                        "thinkdiff_tpu/ops/paged_attention.py:77"),
    "fused_lm_sample": ("cuda", "thinkdiff_torch/csrc/fused_sample.cu",
                        "thinkdiff_tpu/ops/fused_sample.py:75"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def time_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """Median device milliseconds of ``fn`` (synchronized around each run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, kind: str):
    """The least time for the work: bytes at the HBM rate or operations at
    the peak rate of their type, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def randn(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", f"{name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return name, smi


def phase_build():
    from thinkdiff_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    info = kernels.build_info()
    say("build", f"CUDA kernels {info['path']}: nvcc {info['seconds']:.1f} s "
        f"(one process per source, in parallel), load "
        f"{time.perf_counter() - t0:.1f} s")
    # ptxas -v: registers and shared memory of each kernel
    entry = None
    for line in str(info["log"]).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            name = re.search(r"(flash_fwd_kernelILi\d+|s8_gemm_kernel|"
                             r"paged_decode_kernel|fused_sample_tiles|"
                             r"fused_sample_reduce)", entry)
            say("build", f"{name.group(1) if name else entry}: {m.group(1)} "
                f"registers, {m.group(2)} B smem")


def check(name, shape, run, plain, ok, tol_text, work, library=None,
          main=False):
    """Kernel vs plain on the same inputs, then the three timings; ``work``
    is (bytes, operations, operand type) of the function. Returns the
    shape's record."""
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {shape}: non-finite output")
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    if not bool(ok(err, ref.float()).all()):
        raise AssertionError(f"{name} {shape}: max |err| {max_err} outside "
                             f"{tol_text}")
    ms, plain_ms = time_ms(run), time_ms(plain)
    lib_ms = time_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(*work)
    say("kernels", f"{name} {shape}: max|err| {max_err:.3g} within "
        f"{tol_text}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
        + f", bound {b_ms:.4f} ms ({b_by}: {work[0] / 1e6:.1f} MB, "
        f"{work[1] / 1e9:.2f} G {work[2]} ops)")
    return {"shape": shape, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "main": main}


def kernels_flash(results):
    import torch.nn.functional as F

    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)

    tol = "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)"
    ok = lambda e, r: e <= 2e-2 + 2e-2 * r.abs()
    # vision tower: a vision_batch of 32 images of 1024 patches, 16 heads of 80
    q, k, v = (randn((32, 16, 1024, 80), s) for s in (1, 2, 3))
    results.append(check(
        "flash_attention_fwd", "vision B32 H16 S1024 D80",
        lambda: flash_attention(q, k, v, None, None, False, 80 ** -0.5),
        lambda: mha_reference(q, k, v, None, None, False, 80 ** -0.5),
        ok, tol, (nbytes(q, k, v, q), 4 * q.numel() * 1024, "bf16"),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=80 ** -0.5),
        main=True))
    # LM one-shot prefill (dense slice): causal + key-padding bias, GQA 12:2
    q = randn((8, 12, 512, 128), 4)
    k, v = randn((8, 2, 512, 128), 5), randn((8, 2, 512, 128), 6)
    lens = torch.tensor([512, 480, 300, 290, 280, 270, 260, 100], device="cuda")
    valid = torch.arange(512, device="cuda")[None] < lens[:, None]
    bias = (1.0 - valid.float())[:, None, None, :] * -1e30
    causal = torch.ones(512, 512, dtype=torch.bool, device="cuda").tril()
    mask = torch.where(causal[None, None] & valid[:, None, None, :], 0.0,
                       -1e30).to(torch.bfloat16)
    pairs = 8 * 12 * 512 * 513 // 2  # causal (query, key) pairs
    results.append(check(
        "flash_attention_fwd", "lm prefill B8 Hq12 Hkv2 T512 D128 causal+pad",
        lambda: flash_attention(q, k, v, bias, None, True, 128 ** -0.5),
        lambda: mha_reference(q, k, v, bias, None, True, 128 ** -0.5),
        ok, tol, (nbytes(q, k, v, q, bias), 4 * pairs * 128, "bf16"),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=128 ** -0.5, enable_gqa=True)))


def kernels_s8(results):
    from thinkdiff_torch.ops.int8_matmul import s8_matmul, s8_matmul_reference
    from thinkdiff_torch.ops.quant import _absmax_quant_rows, quantize_weight

    # every w8a8 projection of the 2B LM at the dense slice's decode (R=8),
    # the paged slice's decode (R=256) and a 32 x 128 prefill chunk (R=4096)
    for r in (8, 256, 4096):
        for kk, n, proj in ((1536, 2048, "qkv"), (1536, 1536, "o"),
                            (1536, 17920, "gate_up"), (8960, 1536, "down")):
            xq, sx = _absmax_quant_rows(randn((r, kk), 7, torch.float32))
            qw = quantize_weight(randn((kk, n), 8, torch.float32) * 0.02)
            wq = qw["q"].t().contiguous().t()  # QDense's load-time layout
            wq_rm = qw["q"].contiguous()
            scale = qw["scale"]

            def library(xq=xq, sx=sx, wq_rm=wq_rm, scale=scale):
                acc = torch._int_mm(xq, wq_rm)
                return (acc.float() * sx[:, None] * scale[None]).to(
                    torch.bfloat16)

            y = torch.empty((r, n), dtype=torch.bfloat16, device="cuda")
            results.append(check(
                "s8_matmul", f"{proj} R{r} K{kk} N{n}",
                lambda xq=xq, sx=sx, wq=wq, s=scale: s8_matmul(xq, sx, wq, s),
                lambda xq=xq, sx=sx, wq=wq, s=scale: s8_matmul_reference(
                    xq, sx, wq, s),
                lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
                (nbytes(xq, sx, wq, scale, y), 2 * r * kk * n, "int8"),
                library=library if r >= 32 else None,
                main=(r, proj) == (256, "gate_up")))


def kernels_rmsnorm(results):
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    for r in (256, 4096):
        x, scale = randn((r, 1536), 9) * 3.0, randn((1536,), 10)
        results.append(check(
            "rmsnorm", f"R{r} D1536",
            lambda x=x, s=scale: rmsnorm(x, s, 1e-6),
            lambda x=x, s=scale: rmsnorm_reference(x, s, 1e-6),
            lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
            (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
            library=lambda x=x, s=scale: F.rms_norm(x, (1536,), s, 1e-6),
            main=r == 256))


def kernels_paged(results):
    from thinkdiff_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    # the 2B decode step at 256 slots: H12 / Hkv2 / D128, 64-token pages,
    # ragged lengths 1..600, pages from a shuffled free list, garbage in the
    # trash page and past every slot's length
    slots, h, hkv, d, page = 256, 12, 2, 128, 64
    rs = np.random.RandomState(SEED)
    lengths = np.concatenate([[1, 64, 65, 600], rs.randint(1, 601, slots - 4)])
    npages = -(-lengths // page)
    mp = int(npages.max())
    ids = rs.permutation(np.arange(1, 1 + npages.sum() + 8))
    table = np.zeros((slots, mp), np.int32)
    o = 0
    for s, n in enumerate(npages):
        table[s, :n] = ids[o:o + n]
        o += n
    pool = len(ids) + 1
    k, v = randn((pool, hkv, page, d), 11), randn((pool, hkv, page, d), 12)
    k[0], v[0] = 3e3, -3e3
    for s, n in enumerate(lengths):
        if n % page:
            last = int(table[s, npages[s] - 1])
            k[last, :, n % page:], v[last, :, n % page:] = 1e3, -1e3
    q = randn((slots, h, d), 13)
    table_t = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    tokens = int(lengths.sum())
    work = (tokens * hkv * d * 2 * 2 + nbytes(q, q, table_t, lens),
            4 * h * d * tokens, "bf16")
    results.append(check(
        "paged_attention", f"S{slots} H{h} Hkv{hkv} D{d} page{page} "
        f"lengths 1..600 ({tokens} tokens, {int(npages.sum())} pages)",
        lambda: paged_attention(q, k, v, table_t, lens),
        lambda: paged_attention_reference(q, k, v, table_t, lens),
        lambda e, ref: e <= 4e-3 + 1e-2 * ref.abs(),
        "4e-3 + 1e-2*|ref| (kernel and plain each round to bf16: up to one "
        "ulp apart, 2^-8 at |ref| < 1; f32 softmax summed in another order)",
        work, main=True))


def kernels_fused_sample(results):
    from thinkdiff_torch.ops.fused_sample import (
        fused_lm_sample, fused_lm_sample_reference, gumbel_noise,
        pack_tied_embedding)

    # the 2B tied-embedding pack, from a seeded N(0, 0.02) table; batch 64
    # is the gumbel slice's decode step and first-token group (64 slots),
    # 8 a small power-of-two first-token group (one partly filled row tile),
    # 256 the shipped configuration's decode step
    d, v = 1536, 151936
    pack = pack_tied_embedding(randn((v, d), 14, torch.float32) * 0.02,
                               [151643, 151645])
    vp = pack["qt"].shape[0]
    seed = torch.tensor([2024, -77], dtype=torch.int32, device="cuda")
    for b in (64, 8, 256):
        x = randn((b, d), 15)
        blocked = (torch.arange(b, device="cuda") % 4 == 0).float()
        noise = gumbel_noise(seed, b, vp)
        work = (nbytes(pack["qt"], pack["scale"], pack["pad_bias"],
                       pack["eos_bias"], x, blocked) + b * 8, 2 * b * d * vp,
                "int8")
        for temp, use_noise in ((0.0, False), (0.6, True)):
            results.append(check(
                "fused_lm_sample", f"B{b} D{d} V{v} (Vp {vp}) tied 2B pack, "
                f"noise {'on, T 0.6' if use_noise else 'off'}",
                lambda x=x, blk=blocked, t=temp, nz=use_noise: fused_lm_sample(
                    x, pack, blk, seed, temperature=t, noise=nz),
                lambda x=x, blk=blocked, t=temp, nz=use_noise, nn=noise:
                    fused_lm_sample_reference(x, pack, blk, temperature=t,
                                              noise=nn if nz else None),
                lambda e, ref: e == 0,
                "ids identical" + (" (same keyed Gumbel noise)" if use_noise
                                   else ""),
                work, main=b == 64 and use_noise))


def phase_kernels():
    results = {name: [] for name in TPU_KERNELS}
    kernels_flash(results["flash_attention_fwd"])
    kernels_s8(results["s8_matmul"])
    kernels_rmsnorm(results["rmsnorm"])
    kernels_paged(results["paged_attention"])
    kernels_fused_sample(results["fused_lm_sample"])
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Serving slices
# ---------------------------------------------------------------------------

def load_weights():
    """Seeded random Qwen2-VL-2B parameters in the shipped quantization."""
    import yaml

    from thinkdiff_torch.models.qwen2_vl import (
        Qwen2VLConfig, fuse_qwen2_params, init_params)
    from thinkdiff_torch.ops.quant import quantize_tree

    base_cfg = yaml.safe_load(CONFIG.read_text())["model"]
    vcfg = base_cfg["vllm_config"]
    modes = {"int8": True, "int8_dyn": "w8a8", "w8a8": "w8a8"}
    quant, vquant = modes[vcfg["quantization"]], modes[vcfg["vision_quantization"]]
    cfg = Qwen2VLConfig.qwen2_vl_2b(quant_int8=quant, fused_proj=bool(quant),
                                    vision_quant=vquant)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    params["lm"] = fuse_qwen2_params(quantize_tree(
        params["lm"], min_size=0, w8a8=quant == "w8a8"))
    params["vision"] = quantize_tree(params["vision"], min_size=0,
                                     w8a8=vquant == "w8a8")
    torch.cuda.synchronize()
    mode = {True: "weight-only int8", "w8a8": "w8a8", False: "bf16"}
    say("weights", f"Qwen2-VL-2B seeded random weights (LM {mode[quant]}, "
        f"vision {mode[vquant]}, fused projections) in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.num_layers} LM layers, "
        f"{cfg.vision.depth} vision blocks")
    return base_cfg, cfg, params


def build_model(base_cfg, cfg, params, overrides):
    """MllamaVllmGenerateModel over an engine built from the YAML's model
    section with ``overrides`` on its vllm_config, on the engine's default
    device (the card)."""
    import copy

    from thinkdiff_torch.engines.embed_engine import (
        EmbedEngine, MllamaVllmGenerateModel, engine_kwargs)
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer

    model_cfg = copy.deepcopy(base_cfg)
    model_cfg["vllm_config"].update(overrides)
    tok = StandInTokenizer()
    eos = [tok.eos_token_id, tok.convert_tokens_to_ids("<|im_end|>")]
    engine = EmbedEngine(cfg, params, tok, eos_ids=eos,
                         **engine_kwargs(model_cfg))
    if engine.device.type != "cuda":
        raise AssertionError(f"engine built on {engine.device}")
    return MllamaVllmGenerateModel(model_cfg, engine=engine)


def requests(n, seed):
    from PIL import Image

    rs = np.random.RandomState(seed)
    images = [Image.fromarray(rs.randint(0, 256, (448, 448, 3), np.uint8))
              for _ in range(n)]
    prompts = [f"describe picture {i} in one short sentence" for i in range(n)]
    return images, prompts


def serve(phase, model, n, lengths, expect):
    """One forward over n requests (stop lengths from ``lengths`` when
    given), with the launch counters set to 0 just before and read just
    after; checks the outputs and that every kernel in ``expect`` ran."""
    from thinkdiff_torch import kernels

    engine = model.engine
    cfg = engine.cfg
    images, prompts = requests(n, SEED)
    if lengths is not None:
        engine.stop_len_fn = lambda req, m: m >= lengths[req]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward({"answers": prompts, "images": images})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    engine.stop_len_fn = None

    keys = ["generated_texts", "input_prompts", "prompt_token_ids",
            "output_token_ids", "prompt_hidden_states", "hidden_states",
            "embedding_layer_name"]
    if list(out) != keys:
        raise AssertionError(f"forward keys {list(out)}")
    n_gen = 0
    for i in range(n):
        ids = out["output_token_ids"][i]
        hid, phid = out["hidden_states"][i], out["prompt_hidden_states"][i]
        n_gen += len(ids)
        want_len = None
        if lengths is not None:
            # the count-only stop hook is read at chunk boundaries: the
            # first token, then whole 32-step chunks until the length is
            # reached (the JAX engine's semantics)
            want_len = min(engine.max_tokens,
                           1 + CHUNK * -(-(int(lengths[i]) - 1) // CHUNK))
        if not 1 <= len(ids) <= engine.max_tokens or (
                want_len is not None and len(ids) != want_len
                and not any(t in engine.eos_ids for t in ids)):
            raise AssertionError(f"request {i}: {len(ids)} tokens, stop "
                                 f"length {lengths[i]} -> {want_len}")
        if tuple(hid.shape) != (len(ids), cfg.hidden_size) or tuple(
                phid.shape) != (len(out["prompt_token_ids"][i]), cfg.hidden_size):
            raise AssertionError(f"request {i}: hidden shapes {tuple(hid.shape)}"
                                 f" {tuple(phid.shape)}")
        if not (torch.isfinite(hid.float()).all()
                and torch.isfinite(phid.float()).all()):
            raise AssertionError(f"request {i}: non-finite hidden states")
        if not all(0 <= t < cfg.vocab_size for t in ids):
            raise AssertionError(f"request {i}: token id outside the vocabulary")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {phase}: {missing}")
    say(phase, f"{n} requests, {n_gen} generated tokens, prompt "
        f"{len(out['prompt_token_ids'][0])} tokens; forward {wall:.3f} s: "
        f"{n / wall:.2f} imgs/s, {n_gen / wall:.1f} generated tokens/s; peak "
        f"{peak_gib:.2f} GiB; launches {launches}")
    return out, images, launches, wall, n_gen


def phase_dense_slice(base_cfg, cfg, params):
    model = build_model(base_cfg, cfg, params, DENSE_OVERRIDES)
    out, images, launches, _, _ = serve(
        "dense slice", model, 8, None,
        ["flash_attention_fwd", "s8_matmul", "rmsnorm"])
    ph = model.engine.last_phase_times
    say("dense slice", f"vision {ph['vision']:.3f} s, prefill "
        f"{ph['prefill']:.3f} s, decode {ph['decode']:.3f} s")
    teacher_forcing_check("dense slice", model.engine, out, images, 0)
    return launches


def stop_lengths(n, seed):
    """The engine bench's length law: N(80, 40) clipped to [8, 256]."""
    rs = np.random.RandomState(seed)
    return np.clip(rs.normal(80, 40, n).astype(int), 8, 256)


def phase_paged_slice(base_cfg, cfg, params):
    model = build_model(base_cfg, cfg, params, {})
    engine = model.engine
    vc = model.cfg["vllm_config"]
    say("paged slice", f"YAML as written: max_num_seqs {vc['max_num_seqs']}, "
        f"prefill_chunk {engine.prefill_chunk}, preadmit_wave "
        f"{engine.preadmit_wave}, eos_lag {engine.eos_lag}, sampler "
        f"{engine.sampler}, temperature {engine.temperature}, top_p "
        f"{engine.top_p}, max_tokens {engine.max_tokens}")
    n = 2 * engine.max_num_seqs
    lengths = stop_lengths(n, SEED + 1)
    out, images, launches, wall, n_gen = serve(
        "paged slice", model, n, lengths,
        ["flash_attention_fwd", "s8_matmul", "rmsnorm", "paged_attention"])
    say("paged slice", f"stop lengths mean {lengths.mean():.1f}, max "
        f"{lengths.max()}; last_phase_stats {engine.last_phase_stats}")
    # prompts are all one length, so the initial fill takes requests
    # 0..slots-1 (longest-first, stable); request n - 1 was admitted later
    teacher_forcing_check("paged slice", engine, out, images, n - 1)
    return launches, engine, {"imgs_per_s": n / wall,
                              "tokens_per_s": n_gen / wall}


def phase_gumbel_slice(base_cfg, cfg, params):
    model = build_model(base_cfg, cfg, params, GUMBEL_OVERRIDES)
    engine = model.engine
    if engine._fused_sampler_pack() is None:
        raise AssertionError("gumbel slice: the fused sampler is off")
    n = 2 * engine.max_num_seqs
    lengths = stop_lengths(n, SEED + 2)
    out, images, launches, _, _ = serve(
        "gumbel slice", model, n, lengths,
        ["flash_attention_fwd", "s8_matmul", "rmsnorm", "paged_attention",
         "fused_lm_sample"])
    stats = engine.last_phase_stats
    decode = stats["chunks"] * CHUNK  # one launch per decode step
    first = launches["fused_lm_sample"] - decode
    if first <= 0:
        raise AssertionError(f"gumbel slice: {launches['fused_lm_sample']} "
                             f"fused launches, {decode} decode steps: none "
                             "for first tokens")
    say("gumbel slice", f"fused_lm_sample launches: {decode} decode steps + "
        f"{first} first-token groups; last_phase_stats {stats}")
    teacher_forcing_check("gumbel slice", engine, out, images, n - 1)
    return launches


def teacher_forcing_check(phase, engine, out, images, i):
    """One causal forward (flash kernel, no cache) over request i's prompt
    and generated tokens must reproduce the hidden states the engine
    returned for the prompt (prefill) and for each generated token (decode
    over the KV cache)."""
    from thinkdiff_torch.engines.embed_engine import (
        patchify_normalize, resize_image_uint8)
    from thinkdiff_torch.models.qwen2_vl import (
        get_mrope_position_ids, vision_cos_sin, vision_rot_pos_emb)

    cfg, vcfg = engine.cfg, engine.cfg.vision
    merge = vcfg.spatial_merge_size
    prompt_ids = out["prompt_token_ids"][i]
    # generated token j+1 was produced by feeding token j; stop before a
    # sampled image-pad id, which would read as an image span
    fed = out["output_token_ids"][i][:-1]
    if cfg.image_token_id in fed:
        fed = fed[: fed.index(cfg.image_token_id)]
    ids = np.asarray(prompt_ids + fed)
    pixels, (h, w) = resize_image_uint8(images[i], vcfg.patch_size * merge,
                                        engine.min_pixels, engine.max_pixels)
    grid = (1, h // vcfg.patch_size, w // vcfg.patch_size)
    with torch.inference_mode():
        cos, sin = vision_cos_sin(vision_rot_pos_emb(np.asarray([grid]), merge),
                                  vcfg.head_dim)
        pixels = torch.as_tensor(pixels[None].copy(), device="cuda")
        patches = patchify_normalize(pixels, vcfg.patch_size, merge,
                                     vcfg.temporal_patch_size).to(vcfg.dtype)
        img = engine.vision(patches, torch.as_tensor(cos, device="cuda"),
                            torch.as_tensor(sin, device="cuda"))[0]
        pos, _ = get_mrope_position_ids(ids, [grid], cfg.image_token_id, merge)
        is_img = torch.as_tensor(ids == cfg.image_token_id, device="cuda")
        full = torch.zeros((1, len(ids), cfg.hidden_size), dtype=cfg.dtype,
                           device="cuda")
        full[0, is_img] = img
        _, hidden, _ = engine.lm(
            input_ids=torch.as_tensor(ids, device="cuda")[None],
            position_ids=torch.as_tensor(pos, device="cuda")[:, None],
            image_embeds=full, image_mask=is_img[None].int(),
            compute_logits=False)
    want = hidden[0].float().cpu()
    # prompt positions come from the prefill, the rest from decode steps
    got = torch.cat([out["prompt_hidden_states"][i].float(),
                     out["hidden_states"][i][1:1 + len(fed)].float()])
    cos_sim = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    lp = len(prompt_ids)
    # bf16 activations through 32 vision blocks and 28 w8a8 layers, on two
    # attention paths (flash over the whole sequence vs prefill chunks and
    # decode steps over the cache) and another vision batch size: per-token
    # directions agree to within a few percent, where a wrong position,
    # cache slot, page or token alignment would decorrelate them
    if float(cos_sim.min()) < 0.98:
        raise AssertionError(f"{phase} teacher forcing: min cosine "
                             f"{float(cos_sim.min())}")
    say(phase, f"teacher-forced forward over request {i}'s {len(ids)} tokens "
        f"matches the served hidden states: cosine min "
        f"{float(cos_sim.min()):.5f} (> 0.98), mean {float(cos_sim.mean()):.5f};"
        f" prompt min {float(cos_sim[:lp].min()):.5f}, decode min "
        f"{float(cos_sim[lp:].min()):.5f}; max |err| "
        f"{float((got - want).abs().max()):.3g}")


def phase_profile(engine, n_slots=256, steps=8):
    """One paged decode step at 256 slots: wall time per step, device-busy
    share (kernel time over wall time) and the kernels that take it."""
    from torch.autograd import DeviceType

    cfg = engine.cfg
    rs = np.random.RandomState(SEED + 3)
    prompt = 283
    lengths = prompt + np.array([rs.randint(1, int(n) + 1)
                                 for n in stop_lengths(n_slots, SEED + 4)])
    page = engine.kv_page_size
    npages = -(-(lengths + steps) // page)
    mp = int(npages.max())
    table = np.zeros((n_slots, mp), np.int32)
    nxt = 1
    for s, k in enumerate(npages):
        table[s, :k] = np.arange(nxt, nxt + k)
        nxt += k
    shape = (nxt, cfg.num_kv_heads, page, cfg.head_dim)
    pools = [(randn(shape, 20 + i), randn(shape, 60 + i))
             for i in range(cfg.num_layers)]
    dev = engine.device
    table_t = torch.from_numpy(table).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def run(k):
        cache_len = torch.from_numpy(lengths).to(dev)
        tokens = torch.randint(1, 150000, (n_slots,), device=dev)
        pos = cache_len.clone()
        for _ in range(k):
            tokens, _ = engine._decode_step(pools, tokens, cache_len, pos,
                                            None, gen, page_table=table_t)
            cache_len, pos = cache_len + 1, pos + 1

    with torch.inference_mode():
        run(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    say("profile", f"paged decode step at {n_slots} slots (context "
        f"{int(lengths.mean())} mean, {int(npages.sum())} pages): "
        f"{wall_ms:.2f} ms per step unprofiled; device kernel time "
        + (f"{busy_ms:.2f} ms per step, busy {busy_ms / wall_ms:.0%}"
           if by_name else "not measured (no device events in the trace)"))
    for name, us in top:
        say("profile", f"  {us / 1e3 / steps:.3f} ms/step  {name[:100]}")
    del pools


def main() -> int:
    name, _ = phase_device()
    t_start = time.perf_counter()
    phase_build()
    results = phase_kernels()
    base_cfg, cfg, params = load_weights()
    phase_dense_slice(base_cfg, cfg, params)
    launches, paged_engine, rates = phase_paged_slice(base_cfg, cfg, params)
    phase_profile(paged_engine)
    del paged_engine
    torch.cuda.empty_cache()
    # each kernel's launches on its main path: the paged slice (the shipped
    # configuration) for kernels #1-#4, the gumbel slice for the sampler
    launches["fused_lm_sample"] = phase_gumbel_slice(
        base_cfg, cfg, params)["fused_lm_sample"]
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"paged slice {rates['imgs_per_s']:.2f} imgs/s, "
        f"{rates['tokens_per_s']:.1f} generated tokens/s")
    report = []
    for kname, (route, source, replaces) in TPU_KERNELS.items():
        rows = results[kname]
        main_row = next(r for r in rows if r["main"])
        report.append({
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "timed_shape": main_row["shape"],
            "shapes": [{k: v for k, v in r.items() if k != "main"}
                       for r in rows],
        })
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
