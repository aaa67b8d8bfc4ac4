"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device  — a CUDA card is required (there is no CPU fallback); prints
               its name and the nvidia-smi name and power limit;
  2. build   — compiles the CUDA kernels from csrc/ with nvcc into build/;
  3. kernels — each hand-written kernel against its plain PyTorch version
               at the serving slice's shapes, bf16, tolerance printed, with
               the median of 20 timed runs after 3 warm-ups for both;
  4. slice   — Qwen2-VL-2B at full width and depth on seeded random
               weights (w8a8 LM with fused projections, weight-only int8
               vision), served through MllamaVllmGenerateModel.forward on 8
               requests of one 448x448 image and a short prompt each, with
               the configs/qwen2_vl_embed_ccsbu.yaml sampling settings. It
               checks output shapes, finiteness and vocabulary range, that
               every kernel's launch counter rose during the run, and that
               a teacher-forced forward over one request's prompt and
               generated tokens reproduces the decode hidden states.
The last two lines are a JSON object with per-kernel results and
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
SLICE_OVERRIDES = {"max_num_seqs": 8, "enable_chunked_prefill": False,
                   "prefill_chunk": 0, "preadmit_wave": 0, "eos_lag": 0}
N_REQUESTS = 8
SEED = 0


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
    say("build", f"CUDA kernels {info['path']}: nvcc {info['seconds']:.1f} s, "
        f"load {time.perf_counter() - t0:.1f} s")
    # ptxas -v: registers and shared memory of each kernel
    entry = None
    for line in str(info["log"]).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            name = re.search(r"(flash_fwd_kernelILi\d+|s8_gemm_kernel)", entry)
            say("build", f"{name.group(1) if name else entry}: {m.group(1)} "
                f"registers, {m.group(2)} B smem")


def check(name, shape, run, plain, ok, tol_text):
    """Kernel vs plain on the same inputs; returns the shape's record."""
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
    say("kernels", f"{name} {shape}: max|err| {max_err:.3g} within "
        f"{tol_text}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"shape": shape, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms}


def phase_kernels():
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)
    from thinkdiff_torch.ops.int8_matmul import s8_matmul, s8_matmul_reference
    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference
    from thinkdiff_torch.ops.quant import _absmax_quant_rows, quantize_weight

    flash_tol = "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)"
    flash_ok = lambda e, r: e <= 2e-2 + 2e-2 * r.abs()
    ulp_tol = "1 bf16 ulp"
    ulp_ok = lambda e, r: e <= bf16_ulp(r)
    results = {"flash_attention_fwd": [], "s8_matmul": [], "rmsnorm": []}

    # vision tower: 8 images of 1024 patches, 16 heads of 80
    q, k, v = (randn((8, 16, 1024, 80), s) for s in (1, 2, 3))
    results["flash_attention_fwd"].append(check(
        "flash_attention_fwd", "vision B8 H16 S1024 D80",
        lambda: flash_attention(q, k, v, None, None, False, 80 ** -0.5),
        lambda: mha_reference(q, k, v, None, None, False, 80 ** -0.5),
        flash_ok, flash_tol))
    # LM prefill: causal + key-padding bias, GQA 12:2, D=128
    q = randn((8, 12, 512, 128), 4)
    k, v = randn((8, 2, 512, 128), 5), randn((8, 2, 512, 128), 6)
    lens = torch.tensor([512, 480, 300, 290, 280, 270, 260, 100], device="cuda")
    valid = torch.arange(512, device="cuda")[None] < lens[:, None]
    bias = (1.0 - valid.float())[:, None, None, :] * -1e30
    results["flash_attention_fwd"].append(check(
        "flash_attention_fwd", "lm prefill B8 Hq12 Hkv2 T512 D128 causal+pad",
        lambda: flash_attention(q, k, v, bias, None, True, 128 ** -0.5),
        lambda: mha_reference(q, k, v, bias, None, True, 128 ** -0.5),
        flash_ok, flash_tol))

    # every w8a8 projection of the 2B LM at decode (R=8) and prefill (R=4096)
    for r in (8, 4096):
        for kk, n, proj in ((1536, 2048, "qkv"), (1536, 1536, "o"),
                            (1536, 17920, "gate_up"), (8960, 1536, "down")):
            xq, sx = _absmax_quant_rows(randn((r, kk), 7, torch.float32))
            qw = quantize_weight(randn((kk, n), 8, torch.float32) * 0.02)
            wq = qw["q"].t().contiguous().t()  # QDense's load-time layout
            results["s8_matmul"].append(check(
                "s8_matmul", f"{proj} R{r} K{kk} N{n}",
                lambda: s8_matmul(xq, sx, wq, qw["scale"]),
                lambda: s8_matmul_reference(xq, sx, wq, qw["scale"]),
                ulp_ok, ulp_tol))

    x, scale = randn((4096, 1536), 9) * 3.0, randn((1536,), 10)
    results["rmsnorm"].append(check(
        "rmsnorm", "R4096 D1536",
        lambda: rmsnorm(x, scale, 1e-6),
        lambda: rmsnorm_reference(x, scale, 1e-6), ulp_ok, ulp_tol))
    return results


def slice_engine():
    import yaml

    from thinkdiff_torch.engines.embed_engine import (
        EmbedEngine, MllamaVllmGenerateModel, engine_kwargs)
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models.qwen2_vl import (
        Qwen2VLConfig, fuse_qwen2_params, init_params)
    from thinkdiff_torch.ops.quant import quantize_tree

    model_cfg = yaml.safe_load(CONFIG.read_text())["model"]
    model_cfg["vllm_config"].update(SLICE_OVERRIDES)
    vcfg = model_cfg["vllm_config"]
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
    tok = StandInTokenizer()
    eos = [tok.eos_token_id, tok.convert_tokens_to_ids("<|im_end|>")]
    engine = EmbedEngine(cfg, params, tok, eos_ids=eos, device="cuda",
                         **engine_kwargs(model_cfg))
    del params
    torch.cuda.synchronize()
    mode = {True: "weight-only int8", "w8a8": "w8a8", False: "bf16"}
    say("slice", f"Qwen2-VL-2B built on seeded random weights (LM "
        f"{mode[quant]}, vision {mode[vquant]}, fused projections) in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.num_layers} LM layers, "
        f"{cfg.vision.depth} vision blocks")
    return MllamaVllmGenerateModel(model_cfg, engine=engine), cfg


def phase_slice():
    from PIL import Image

    from thinkdiff_torch import kernels

    model, cfg = slice_engine()
    engine = model.engine
    rs = np.random.RandomState(SEED)
    images = [Image.fromarray(rs.randint(0, 256, (448, 448, 3), np.uint8))
              for _ in range(N_REQUESTS)]
    prompts = [f"describe picture {i} in one short sentence"
               for i in range(N_REQUESTS)]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward({"answers": prompts, "images": images})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    keys = ["generated_texts", "input_prompts", "prompt_token_ids",
            "output_token_ids", "prompt_hidden_states", "hidden_states",
            "embedding_layer_name"]
    if list(out) != keys:
        raise AssertionError(f"forward keys {list(out)}")
    n_gen = 0
    for i in range(N_REQUESTS):
        ids = out["output_token_ids"][i]
        hid, phid = out["hidden_states"][i], out["prompt_hidden_states"][i]
        n_gen += len(ids)
        if not 1 <= len(ids) <= 256:
            raise AssertionError(f"request {i}: {len(ids)} tokens")
        if tuple(hid.shape) != (len(ids), cfg.hidden_size) or tuple(
                phid.shape) != (len(out["prompt_token_ids"][i]), cfg.hidden_size):
            raise AssertionError(f"request {i}: hidden shapes {tuple(hid.shape)}"
                                 f" {tuple(phid.shape)}")
        if not (torch.isfinite(hid.float()).all()
                and torch.isfinite(phid.float()).all()):
            raise AssertionError(f"request {i}: non-finite hidden states")
        if not all(0 <= t < cfg.vocab_size for t in ids):
            raise AssertionError(f"request {i}: token id outside the vocabulary")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the slice: {missing}")
    ph = engine.last_phase_times
    say("slice", f"{N_REQUESTS} requests, {n_gen} generated tokens, prompt "
        f"{len(out['prompt_token_ids'][0])} tokens; vision {ph['vision']:.3f} s, "
        f"prefill {ph['prefill']:.3f} s, decode {ph['decode']:.3f} s, forward "
        f"{wall:.3f} s; {n_gen / wall:.1f} generated tokens/s; peak "
        f"{peak_gib:.2f} GiB; launches {launches}")
    teacher_forcing_check(engine, out, images[0])
    return launches


def teacher_forcing_check(engine, out, image):
    """One causal forward (flash kernel, no cache) over request 0's prompt
    and generated tokens must reproduce the hidden states the engine
    returned for the prompt (prefill) and for each generated token (decode
    over the KV cache)."""
    from thinkdiff_torch.engines.embed_engine import (
        patchify_normalize, resize_image_uint8)
    from thinkdiff_torch.models.qwen2_vl import (
        get_mrope_position_ids, vision_cos_sin, vision_rot_pos_emb)

    cfg, vcfg = engine.cfg, engine.cfg.vision
    merge = vcfg.spatial_merge_size
    prompt_ids = out["prompt_token_ids"][0]
    # generated token j+1 was produced by feeding token j; stop before a
    # sampled image-pad id, which would read as an image span
    fed = out["output_token_ids"][0][:-1]
    if cfg.image_token_id in fed:
        fed = fed[: fed.index(cfg.image_token_id)]
    ids = np.asarray(prompt_ids + fed)
    pixels, (h, w) = resize_image_uint8(image, vcfg.patch_size * merge,
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
    got = torch.cat([out["prompt_hidden_states"][0].float(),
                     out["hidden_states"][0][1:1 + len(fed)].float()])
    cos_sim = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    lp = len(prompt_ids)
    # bf16 activations through 32 vision blocks and 28 w8a8 layers, on two
    # attention paths (flash over the whole sequence vs decode steps over
    # the cache) and another vision batch size: per-token directions agree
    # to within a few percent, where a wrong position, cache slot or token
    # alignment would decorrelate them
    if float(cos_sim.min()) < 0.98:
        raise AssertionError(f"teacher forcing: min cosine {float(cos_sim.min())}")
    say("slice", f"teacher-forced forward over {len(ids)} tokens matches the "
        f"served hidden states: cosine min {float(cos_sim.min()):.5f} (> 0.98),"
        f" mean {float(cos_sim.mean()):.5f}; prompt min "
        f"{float(cos_sim[:lp].min()):.5f}, decode min "
        f"{float(cos_sim[lp:].min()):.5f}; max |err| "
        f"{float((got - want).abs().max()):.3g}")


def main() -> int:
    name, _ = phase_device()
    phase_build()
    results = phase_kernels()
    launches = phase_slice()
    meta = {
        "flash_attention_fwd": ("cuda", "thinkdiff_torch/csrc/flash_fwd.cu",
                                "thinkdiff_tpu/ops/flash_attention.py:64"),
        "s8_matmul": ("cuda", "thinkdiff_torch/csrc/s8_gemm.cu",
                      "thinkdiff_tpu/ops/int8_matmul.py:291"),
        "rmsnorm": ("triton", "thinkdiff_torch/ops/norms.py",
                    "thinkdiff_tpu/ops/norms.py:27"),
    }
    report = []
    for kname, (route, source, replaces) in meta.items():
        rows = results[kname]
        main_row = max(rows, key=lambda r: r["plain_ms"])  # largest shape
        report.append({
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "timed_shape": main_row["shape"], "shapes": rows,
        })
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
