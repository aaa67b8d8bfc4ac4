"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises and the exit code is
non-zero:
  1. device   — a CUDA card is required (there is no CPU fallback); prints
                its name and the nvidia-smi name and power limit;
  2. build    — compiles the CUDA kernels from csrc/ (one nvcc per source,
                all started together) into build/;
  3. kernels  — each of the twelve hand-written kernels against its plain
                PyTorch version at the shapes of the paths that run it, bf16,
                tolerance printed, with the median of 20 timed runs after 3
                warm-ups for the kernel, the plain version and, where one
                PyTorch call computes the same function, that call
                (library_ms; the port never calls it), each run timed by CUDA
                events around the call, wrapper included; the kernel's device
                time alone (device_ms) from torch.profiler; the least time the
                card could take (bound_ms) comes from the bytes and
                operations of the inputs. The flash backward (dq, dk/dv) is
                checked on T5's self- and cross-attention of a packed batch
                (pad query rows that see no key, poisoned), contiguous and
                as the T5 layer hands them over (head-transposed views; no
                operand copy, dq/dk/dv views of (B, T, H, D) memory), and a
                GQA D=128 case, with the forward's lse; the s8 input
                gradient on every projection; the weight-only GEMV on every
                flan-t5-xxl layer shape at 1, 8, 16, 17 and 32 rows and
                every plan its planner picks at q and wi, and the paged
                decode at 256 and 64 slots, a long-context skew and the
                7B's 7 heads a kv head, both also with a cold L2
                (cold_ms) and checked to be one device launch a call
                (torch.profiler); the wide
                weight-only GEMM and its input gradient at the flan-t5-xxl
                FFN's 1024 rows, at lvlm-text's kv_fused shape (411 rows,
                beside the port's bf16-copy route there), in f32 and at 33
                rows; the fused sampler at the 2B tied pack's 8, 64 and 256
                rows and the 7B untied pack's 16, noise off and on, also
                with a cold L2; the quantize-in-kernel s8 GEMM at 1024
                rows; both checked to be one device launch a call; the
                flash forward at FLUX.1-dev's joint attention (B1 H24
                D128, T4224 and the ragged T4507) and CLIP-L's causal
                layer (B1 H12 T77 D64), and RMSNorm at FLUX's q/k norm
                (24 x 4224 rows of 128), each also with a cold L2 and
                checked to be one device launch a call; the flash forward
                at BLIP-2's ViT-g (B1 and B32, H16 T257 D88, projection
                views, cold L2, one launch a call) and at the flan-t5-xxl
                encoder (B32 H64 T128 D64, bidirectional relative bias +
                kv_mask), RMSNorm at the encoder's 4096 rows of 4096; the
                flash forward at CogVideoX-5b's joint attention (B1 H48 D64,
                T17776 and T1576, against mha_reference two heads at a
                time, planted faults, cold L2, one launch a call); the
                flash forward at the CoBSAT scorer's CLIP-L ViT (B32 H16
                T257 D64, cold L2, one launch a call) and, with dq and
                dk/dv, at a Llama-2-7B LoRA step's B4 H32 T512 D128 causal,
                and RMSNorm at its 2048 rows of 4096;
  4. train-w8a8 — the LVLM aligner's training step: configs/
                train_thinkdiff_lvlm_ccsbu.yaml's model and run sections with
                bench.py's overrides (w8a8 frozen flan-t5-xxl decoder at full
                width and depth, fused projections, CE chunk 128, Qwen2-VL-7B
                width 3584) on bench.py's packed batches (4 rows x 256/256,
                seed 0): 16 batches, one warm pass, two timed passes; losses
                and gradient norms finite, projector updated, every kernel's
                launches equal to the count derived from the config; a
                2-layer copy's loss and projector gradients against the same
                step on the CPU's plain versions; 10 steps on one batch at
                lr 1e-3 must lower the loss; one step under torch.profiler;
     calibrate — SmoothQuant calibration of the same w8a8 flan-t5-xxl
                decoder (full width and depth): calibrate_w8a8 over 4 of
                bench.py's packed batches (launches, input_scales changed,
                seconds), then the gradient check on a 2-layer copy
                calibrated alike;
  5. train-yaml — the shipped YAML as written (bf16 frozen T5, unfused,
                CE chunk 32) on 4 padded batches of 32 (bench.py's buckets);
  6. ops      — the ops no model path runs, through their entry points:
                int8_matmul_wide with its autograd backward, s8_matmul_qx;
  7. dense slice — configs/qwen2_vl_embed_ccsbu.yaml with the static-batch
                overrides (8 slots, no chunked prefill, no prefill-ahead, no
                pipelined EOS): 8 requests through MllamaVllmGenerateModel
                .forward, the one path whose prefill runs the flash kernel;
  8. dense-int8 — the dense slice with quantization int8 (the LM
                weight-only): its decode steps run the GEMV;
  9. paged slice — the same YAML as written (256 slots, prefill_chunk 128,
                preadmit_wave 64, eos_lag 2, exact nucleus sampler) on 512
                requests of one 448x448 image, each stopped at a seeded
                length from N(80, 40) clipped to [8, 256];
 10. profile  — one paged decode step at 256 slots under torch.profiler:
                device-busy share and the top kernels;
 11. gumbel slice — the YAML with sampler gumbel and 64 slots, 128
                requests: the fused sampler serves first tokens and decode;
 12. cli      — stages 1 and 2 from their entry points. Stage 1: 256
                448x448 JPEGs in wids-indexed shards through the precompute
                bootstrap, task and runner_process_data over
                configs/qwen2_vl_embed_ccsbu.yaml as written (the task's
                shard size set to 2e8), the paged slice's model injected and its stop lengths;
                every sample's embeddings checked (bf16, finite, rows,
                compact .pth) and one read back through the teacher-forced
                check. Stage 2: thinkdiff_torch.train.main over
                configs/train_thinkdiff_lvlm_ccsbu.yaml as written (2B width,
                the shards, 2 epochs of 4 steps), then resumed from
                checkpoint_0.pth: epoch 1's steps and lr equal, losses within
                2.2e-4 relative, projector cosine >= 0.995;
     native   — between the two stages, on stage 1's 256 JPEGs: the C++
                batch decode (data/native.py) to 224² against the PIL
                processor within JAX's bounds, both paths' imgs/s; where
                the machine lacks jpeglib.h or libjpeg it prints
                "native: unavailable (<reason>)" and times the PIL path
                (where they exist, a library that does not build fails);
     ddp      — then both stages again on several ranks, each a process
                of its own (chip_smoke.py --ddp-child) started by python -m
                torch.distributed.run: stage 2 at world 1 with an NCCL
                group (losses, projector bit for bit the cli run's, its
                launches equal); at two ranks on the one card over gloo
                (NCCL refuses a shared card), no --job-id, the batches each
                rank took saved, against the world-1 run on their
                concatenation in this process (each step's loss within
                2.2e-4 relative and gradient norm ratio 0.995-1.005; the
                projector rank 0 saved, each leaf cosine >= 0.995 and norm
                ratio 0.995-1.005), one job directory, checkpoints by rank
                0 only, the last step profiled (the all-reduce's share);
                resumed at two ranks from checkpoint_0.pth; with two cards
                or more also at two cards over NCCL; stage 1 at two ranks
                (each its own 2B engine, 256 slots): shards from r x 100000
                on, disjoint, every key of the world-1 run once, every
                embedding checked, one sample a rank read back, #1-#4
                launched on each rank. Two ranks sharing one card measure
                correctness, not scaling;
 13. lvlm-text — this slice's main path: configs/test_thinkdiff_lvlm_ccsbu_
                image_text.yaml (Qwen2-VL-7B, w8a8 LM, bf16 vision, T 0.6,
                top_p 0.9, 128 tokens, ignore_eos) with the frozen flan-t5-xxl
                decoder weight-only int8 at full depth:
                MllamaT5EmbedDecoderWithEngine.generate on 16 requests of one
                448x448 image (VLM -> hidden states -> projector -> 32 greedy
                T5 steps each), the GEMV's launches against the count derived
                from the config, a teacher-forced T5 pass against the GEMV's
                plain version, then get_text on 8 text-only prompts;
 14. lvlm-flux — stage 3 into an image: lvlm-text's model through
                get_embed on one request ("both": 411 tokens, then the
                path's output_embed: 128), the VLM side then freed;
                FLUX.1-dev (19 + 38 blocks, bf16), CLIP-L and the FLUX VAE
                from seeded random weights on the card;
                ThinkDiffPipeline.generate with the YAML's run section as
                written (1024², 28 steps, guidance 3.5, seed 42) and the
                pooled embedding of "" through a CLIP stand-in tokenizer;
                image (1, 1024, 1024, 3) finite in [0, 1] and not constant,
                final latents finite, the path's launches (counts set to 0
                before get_embed) against get_embed_launches +
                flux_launches, one full-shape forward at both joint lengths
                with every kernel call held against its plain version and
                the velocity against the plain forward's, planted faults
                shown to fail that check, the PNG read back equal, one
                profiled denoise step;
 15. clip-flux — ThinkDiff-CLIP inference from its CLIs, on lvlm-flux's
                FLUX pipeline: test_blip_vision_t5_decoder_flux.main over
                configs/test_thinkdiff_clip_image_text.yaml as written
                (1024², 28 steps, guidance 3.5, seed 42) with one 448x448
                JPEG as run.image_path, the CLIP model (BLIP-2 ViT-g 39 x
                1408, projector, flan-t5-xxl bf16) from seeded random
                weights injected where build_model would read files: image
                finite in [0, 1] and not constant, the PNG read back equal,
                the path's launches against clip_flux_launches, one ViT-g
                forward with every flash call held against mha_reference and
                its tokens against the plain forward, the FLUX velocity check
                at T4161 with its planted faults; then the _flux_text CLI
                over configs/test_thinkdiff_clip_two_images.yaml on two
                images (T4226);
 16. lvlm-flux-clis — the six remaining LVLM FLUX CLIs' main() over the
                LVLM inference YAML as written but for their inputs and 4
                FLUX steps, on lvlm-flux's pipeline, the LVLM model rebuilt
                as lvlm-text builds it and the CLIP model's flan-t5-xxl
                encoder as the text embedder: the multi-image CLI (two
                448x448 images, 1024²), the single-image exporter, the
                replay CLI on its export with extra T5 text, the text-only
                embed probe, the CoBSAT multi-image exporter (one case of
                two images) and batch exporter (two cases in one batch),
                and the replay of one array of each;
                every run's launches against get_embed_launches +
                flux_launches (+ the T5 encoder's), images and PNGs, exports
                read back, the peak with all three models on the card;
 17. clip-video — ThinkDiff-CLIP into CogVideoX-5b from its CLI:
                test_blip_vision_t5_decoder_cogvideo.main over
                configs/test_thinkdiff_clip_video_text.yaml with what the
                script reads and the YAML lacks (run.image_path one 448x448
                JPEG, run.text_input the YAML's question, run.num_frames 13
                latent frames): 49 frames of 480x720, 15 DDIM steps (the
                YAML's 50 cut for time, VIDEO_STEPS) of two forwards (42
                blocks x 3072, bf16, seeded N(0, 0.02)), the 3D
                VAE tiled at (32, 48) latents (9 tiles); on clip-flux's CLIP
                model, its T5 encoder as the text embedder: frames uint8
                and not constant, latents finite, the video read back by
                VideoReader, launches against cogvideo_launches, one
                forward at T17776 (the 226-token budget) with every flash
                call held against mha_heads and the velocity against the
                plain forward, planted faults (a key tile skipped, the
                112-row tails of keys and queries) failing that check, one
                profiled denoise step, the VAE's seconds and the peak;
 18. clip-train — thinkdiff_torch.train.main over
                configs/train_thinkdiff_clip.yaml as written (ViT-g,
                flan-t5-xxl bf16 encoder 24 + decoder 24, batch 32,
                max_txt_len 128) on 256 seeded 448x448 JPEGs with captions in
                cc_sbu shards, 2 epochs of 4 steps, the flan-t5 stand-in
                tokenizer: losses and gradient norms finite, the projector
                updated, launches against clip_train_launches, a 2-layer
                full-width copy (ViT 2 blocks, T5 2 + 2) on 4 samples
                against the same step on the CPU's plain versions, 10 steps
                on one batch at lr 1e-3 lower the loss, one profiled step;
                then ddp clip: two steps of the same YAML at two ranks on
                the one card (gloo), both T5 stacks cut to 12 layers (two
                full ranks would not fit one card), against the world-1
                run on the concatenated batches, the ddp limits; every
                cc_sbu loader's path (the C++ decode where the library
                builds) checked from its log line;
 19. cobsat  — the CoBSAT CLIP scorer at CLIP-L's full width (bf16,
                seeded): 32 448x448 images against 2 x 8 candidates, the
                launches, every flash call against mha_reference, the
                embeddings against the plain attention (with two
                yardsticks), then the score_cobsat CLI on PNGs;
 20. lora    — Llama-2-7B's geometry in bf16 with LoRA r 8 on q/v: the
                merged logits at init equal the base's, 4 AdamW steps at
                B4 T512 (launches, ms a step, peak), the full-depth loss and
                adapter gradients against the plain versions (printed, with
                SDPA's beside them), and the gradient check on a 2-layer
                copy.
Every serving slice runs at full width and depth on seeded random weights
and the stand-in tokenizer, on the engine's default device: Qwen2-VL-2B
(w8a8 LM with fused projections, weight-only int8 vision) in 7-12, 7B in 13.
Each checks output shapes, finiteness, vocabulary range and stop lengths,
that the kernels of its path launched (counts set to 0 just before, read
just after), and a teacher-forced forward over one request. The last two
lines are a JSON object with per-kernel results (launches of #1-#3 and
#5-#7 from the train-w8a8 timed passes, #4 from the paged slice, #8 from
the gumbel slice, #9 from lvlm-text, #10-#12 from the ops phase; each
kernel's launches in the cli phase's two stages, in lvlm-flux, clip-flux
(the single-image CLI's path), lvlm-flux-clis (the multi-image CLI's
path), clip-video and clip-train beside them, and the ddp phase's per
rank: ddp_train_launches (two ranks, gloo), ddp_stage1_launches,
ddp_world1_launches, ddp_clip_launches; calibrate_launches,
cobsat_launches and lora_launches) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parent / "configs" / "qwen2_vl_embed_ccsbu.yaml"
LVLM_CONFIG = (Path(__file__).resolve().parent / "configs"
               / "test_thinkdiff_lvlm_ccsbu_image_text.yaml")
# the one override of the LVLM YAML: the frozen flan-t5-xxl decoder in
# weight-only int8 (the layout in which the JAX package's decode runs its
# GEMV), seeded random weights (no checkpoint is in the repository)
LVLM_OVERRIDES = {"quantize_frozen": "int8", "load_pretrained": False}
LVLM_REQUESTS, LVLM_TEXT_ONLY = 16, 8
T5_STEPS = 32
# teacher-forced T5 pass, kernels vs int8_matmul's plain version: per-position
# logits cosine at least this
T5_TF_COS_MIN = 0.99
TRAIN_CONFIG = (Path(__file__).resolve().parent / "configs"
                / "train_thinkdiff_lvlm_ccsbu.yaml")
# bench.py's operating point (bench.py:155-192)
BENCH_OVERRIDES = {"load_pretrained": False, "quantize_frozen": "int8_dyn",
                   "chunked_ce": 128, "vlm_hidden_size": 3584,
                   "t5_config": {"fused_proj": True, "dropout_rate": 0.0}}
BENCH_ROWS, BENCH_CAP, BENCH_BATCHES = 4, 256, 16
# gradient check of the 2-layer copy against the CPU's plain versions. Each
# side quantizes its own bf16 activations and gradients to int8 per row, so
# an element one rounding apart moves one quantum: that noise bounds the
# agreement. The loss limit is three times the largest relative difference
# of ``gradient_draws`` (5 draws, model seeds 5-9 and packed rows of seeds
# 0-4, each as shipped and with every activation scale one f32 ulp up;
# NVIDIA H100 80GB HBM3, 700.00 W, flash forward of the mma.sync kernel):
# as shipped 3.7e-7, 2.29e-5, 3.99e-5, 2.54e-5, 2.8e-7; scales one ulp up
# 1.41e-5, 5.29e-5, 7.36e-5, 1.42e-5, 2.56e-5. Gradient cosine 0.99595 at
# worst over those ten, 0.99654 for draw 0 (the check's own)
GRAD_LOSS_TOL, GRAD_COS_MIN = 2.2e-4, 0.995
# cosine does not see a gradient's scale: each leaf's gradient norm, card
# over CPU, must also lie in this band. Measured 0.99947-1.00154 over the
# five leaves (same card); a band of about three times that spread still
# catches any scale fault in the wiring above half a percent
GRAD_NORM_RATIO = (0.995, 1.005)
# the dense static-batch serving slice of the precompute configuration
DENSE_OVERRIDES = {"max_num_seqs": 8, "enable_chunked_prefill": False,
                   "prefill_chunk": 0, "preadmit_wave": 0, "eos_lag": 0}
GUMBEL_OVERRIDES = {"sampler": "gumbel", "max_num_seqs": 64}
CHUNK = 32  # decode steps between scheduler passes (generate_many's default)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
# flash backward tolerance, a fraction of each gradient's largest magnitude:
# the kernels round P and dS to bf16 for their products and the gradients
# to bf16; measured at most 0.0075 (dk/dv of the cross-attention; NVIDIA
# H100 80GB HBM3, 700 W), so twice that
BWD_TOL = 1.5e-2
# the forward's lse against the plain logsumexp: measured 7.6e-6 (a few
# f32 ulps at |lse| ~ 30-60, the sums of exp taken in another order)
LSE_TOL = 3e-5
TPU_KERNELS = {
    "flash_attention_fwd": ("cuda", "thinkdiff_torch/csrc/flash_fwd.cu",
                            "thinkdiff_tpu/ops/flash_attention.py:64"),
    "s8_matmul": ("cuda", "thinkdiff_torch/csrc/s8_gemm.cu",
                  "thinkdiff_tpu/ops/int8_matmul.py:291"),
    "rmsnorm": ("cuda", "thinkdiff_torch/csrc/rmsnorm.cu",
                "thinkdiff_tpu/ops/norms.py:27"),
    "paged_attention": ("cuda", "thinkdiff_torch/csrc/paged_decode.cu",
                        "thinkdiff_tpu/ops/paged_attention.py:77"),
    "fused_lm_sample": ("cuda", "thinkdiff_torch/csrc/fused_sample.cu",
                        "thinkdiff_tpu/ops/fused_sample.py:75"),
    "flash_attention_dq": ("cuda", "thinkdiff_torch/csrc/flash_bwd.cu",
                           "thinkdiff_tpu/ops/flash_attention.py:359"),
    "flash_attention_dkv": ("cuda", "thinkdiff_torch/csrc/flash_bwd.cu",
                            "thinkdiff_tpu/ops/flash_attention.py:438"),
    "s8_matmul_bwd": ("cuda", "thinkdiff_torch/csrc/s8_gemm_bwd.cu",
                      "thinkdiff_tpu/ops/int8_matmul.py:371"),
    "int8_matmul": ("cuda", "thinkdiff_torch/csrc/int8_gemv.cu",
                    "thinkdiff_tpu/ops/int8_matmul.py:26"),
    "int8_matmul_wide_fwd": ("cuda", "thinkdiff_torch/csrc/int8_wide.cu",
                             "thinkdiff_tpu/ops/int8_matmul.py:116"),
    "int8_matmul_wide_bwd": ("cuda", "thinkdiff_torch/csrc/int8_wide.cu",
                             "thinkdiff_tpu/ops/int8_matmul.py:137"),
    "s8_matmul_qx": ("cuda", "thinkdiff_torch/csrc/s8_gemm_qx.cu",
                     "thinkdiff_tpu/ops/int8_matmul.py:445"),
}
# the kernels no model path of either package runs: their launches come
# from the ops phase, which calls each op's entry point once
OP_KERNELS = ("int8_matmul_wide_fwd", "int8_matmul_wide_bwd", "s8_matmul_qx")
# the kernels whose launches come from the training step
TRAIN_KERNELS = ("flash_attention_fwd", "s8_matmul", "rmsnorm",
                 "flash_attention_dq", "flash_attention_dkv", "s8_matmul_bwd")


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


def device_ms(fn, runs: int = 20) -> float:
    """Device milliseconds of ``fn`` per run: the kernels it launches, summed
    by torch.profiler over ``runs`` back-to-back runs. Unlike ``time_ms``
    this leaves out the host's time to enqueue them, which is longer than
    the kernel for the small ones. A trace that caught no kernel, or a
    number of kernels that is not a multiple of ``runs`` (seen now and then
    on an H100: some events lost), is taken again, up to three times."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times and len(times) % runs == 0:
            break
    return sum(times) / runs / 1e3


# bytes read between two timed calls to evict the 50 MB L2, as the decode
# path finds its weights and pages: streamed from HBM, with the L2 holding
# the clean lines of other weights (a written buffer would leave 50 MB of
# dirty lines, whose write-back the timed kernel would pay for)
FLUSH_BYTES = 128 << 20


def cold_ms(fn, kernel: str, runs: int = 20) -> float:
    """Device milliseconds of the kernels named ``kernel`` that ``fn``
    launches, with the L2 cache flushed before every call (a bf16
    matrix-vector product reads FLUSH_BYTES and writes 16 KB), summed by
    torch.profiler over ``runs`` calls."""
    from torch.autograd import DeviceType

    flush_w = torch.ones((FLUSH_BYTES // 2 // 8192, 8192), dtype=torch.bfloat16,
                         device="cuda")
    flush_v = torch.ones((8192,), dtype=torch.bfloat16, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost some of the kernels is taken again
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                torch.mv(flush_w, flush_v)
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times and len(times) % runs == 0:
            break
    del flush_w, flush_v
    if not times:
        raise RuntimeError(f"cold_ms: no {kernel} launch in the trace")
    # a trace that kept losing events: the mean of the launches it kept
    per_call = max(1, round(len(times) / runs))
    return sum(times) / len(times) * per_call / 1e3


def expect_one_launch(phase: str, label: str, fn, kernel: str) -> None:
    """Fail unless one call of ``fn`` (after a warm call) puts exactly one
    operation on the card, torch.profiler's count: the kernel named
    ``kernel`` (no copy, fill, second pass or allocation's memset). A trace
    with no device event at all (torch.profiler lost them: seen on an H100,
    once three traces in a row) is taken again after a pause, up to five
    traces, and the retakes are printed."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):  # a trace that caught no event is taken again
        if attempt:
            say(phase, f"{label}: trace {attempt} caught no device event; "
                "taken again")
            time.sleep(1.0)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    if len(names) != 1 or kernel not in names[0]:
        raise AssertionError(f"{label}: {len(names)} device operations a "
                             f"call, expected one {kernel}: {names}")
    say(phase, f"{label}: one device launch a call ({names[0][:60]})")


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
    # ptxas -v: registers, static shared memory and spills of each kernel
    # (the flash kernels and RMSNorm take only dynamic shared memory), and
    # any warning (a wgmma pipeline that ptxas serializes says so here)
    entry, stack, spill = None, "0", "0"
    for line in str(info["log"]).splitlines():
        if "ptxas" in line and "warning" in line.lower():
            say("build", line.strip()[:300])
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, stack, spill = m.group(1), "0", "0"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = m.group(1), m.group(2)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry:
            name = re.search(r"(flash_fwd_kernelILi\d+ELi\d+ELi\d|"
                             r"rmsnorm_\w{1,48}|s8_wgmma_kernelILi\d+ELi\d+E|"
                             r"s8_split_sum|"
                             r"paged_decode_kernelILb\dE|"
                             r"fused_sample_kernelILi\d+ELb\dE|"
                             r"flash_bwd_d\w+?_kernelILi\d+E(?:Li\d)?|"
                             r"int8_gemv_kernelILi\d+ELb\d+ELb\d|"
                             r"int8_wide_kernelILi\d+ELi\dELb\dELb\dELb\d|"
                             r"s8_gemm_qx_kernelILi\d+ELi\d+ELb\dELb\d)", entry)
            say("build", f"{name.group(1) if name else entry}: {m.group(1)} "
                f"registers, {m.group(2) or 0} B static smem, {stack} B "
                f"stack frame, {spill} B spill stores")


def check(name, shape, run, plain, ok, tol_text, work, library=None,
          main=False, cold=None):
    """Kernel vs plain on the same inputs, then the three timings; ``work``
    is (bytes, operations, operand type) of the function; ``cold`` names
    the kernel whose device time is also taken with a cold L2
    (``cold_ms``). Returns the shape's record."""
    outs, refs = run(), plain()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    max_err = max_rel = 0.0
    for out, ref in zip(outs, refs):
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name} {shape}: non-finite output")
        err = (out.float() - ref.float()).abs()
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, float(err.max() / ref.float().abs().max()
                                     .clamp_min(1e-30)))
        if not bool(ok(err, ref.float()).all()):
            raise AssertionError(f"{name} {shape}: max |err| "
                                 f"{float(err.max())} outside {tol_text}")
    ms, plain_ms = time_ms(run), time_ms(plain)
    dev_ms = device_ms(run)
    lib_ms = time_ms(library) if library is not None else None
    lib_dev = device_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(*work)
    cold_dev = cold_ms(run, cold) if cold else None
    say("kernels", f"{name} {shape}: max|err| {max_err:.3g} ({max_rel:.3g} "
        f"of max|ref|) within {tol_text}; kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms"
        + (f", cold L2 {cold_dev:.4f} ms = {b_ms / cold_dev:.0%} of the "
           "bound" if cold else "")
        + f"), plain {plain_ms:.4f} ms, library "
        + (f"{lib_ms:.4f} ms (device {lib_dev:.4f} ms)" if lib_ms is not None
           else "none")
        + f", bound {b_ms:.4f} ms ({b_by}: {work[0] / 1e6:.1f} MB, "
        f"{work[1] / 1e9:.2f} G {work[2]} ops)")
    return {"shape": shape, "max_abs_err": max_err, "ms": ms,
            "device_ms": dev_ms, "cold_device_ms": cold_dev,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": b_by,
            "main": main}


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
                                                       scale=80 ** -0.5)))
    # the same as the vision block hands it over: (B, H, S, D) views of the
    # fused (B, S, 3, H, 80) qkv projection (models/qwen2_vl.py VisionBlock)
    qkv = randn((32, 1024, 3, 16, 80), 1)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    results.append(check(
        "flash_attention_fwd", "vision strided B32 H16 S1024 D80 (fused qkv "
        "slices)",
        lambda: flash_attention(q, k, v, None, None, False, 80 ** -0.5),
        lambda: mha_reference(q, k, v, None, None, False, 80 ** -0.5),
        ok, tol, (nbytes(q, k, v, q), 4 * q.numel() * 1024, "bf16"),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=80 ** -0.5)))
    del qkv, q, k, v
    kernels_flash_t5_decode(results, ok, tol)
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


# FLUX's joint attention (q/k RMS-normed, D128, scale 128^-0.5): logits
# of std ~1 spread the softmax over ~T/e keys, so |out| ~ sqrt(e/T) ~ 0.025
# and the absolute floor of the other flash rows (2e-2) would pass a kernel
# that lost a tile. These rows are held at a limit scaled to the output:
# 2e-2 * max|ref| (4.0e-3 / 3.8e-3 at T4224 / T4507 on these inputs, where
# the kernel errs 9.8e-4, one bf16 ulp of the largest outputs), and the
# limit is shown to reject the faults it is there for (flash_flux_faults:
# 0.085-0.178 on the card)
FLUX_FLASH_REL = 2e-2


def flux_flash_limit(ref: torch.Tensor) -> float:
    return FLUX_FLASH_REL * float(ref.float().abs().max())


def mha_heads(q, k, v, *args, heads=2):
    """``mha_reference`` (f32) over ``heads`` heads at a time, for unmasked
    calls whose whole score tensor would not fit (CogVideoX-5b's B1 H48
    T17776: 61 GB of f32 scores; two heads take 2.5 GB)."""
    from thinkdiff_torch.ops.flash_attention import mha_reference

    return torch.cat([mha_reference(q[:, i:i + heads], k[:, i:i + heads],
                                    v[:, i:i + heads], *args)
                      for i in range(0, q.shape[1], heads)], dim=1)


def flash_flux_faults(q, k, v, sm_scale, limit, plain=None):
    """Faults planted in the plain version at a joint shape: one 128-key
    tile skipped (keys 2048-2175, or the last whole tile where T is
    shorter) and, where T is no multiple of 128, the ragged tail dropped.
    Each must err beyond ``limit`` against the sound plain version
    (``plain``, mha_reference by default); returns {fault: max |err|}."""
    from thinkdiff_torch.ops.flash_attention import mha_reference

    plain = plain or mha_reference
    t = k.shape[2]
    ref = plain(q, k, v, None, None, False, sm_scale).float()
    tile = min(16, t // 128 - 1)
    keep = {f"tile {tile} skipped": torch.cat([
        torch.arange(128 * tile), torch.arange(128 * tile + 128, t)])}
    if t % 128:
        keep["ragged tail dropped"] = torch.arange(t - t % 128)
    errs = {}
    for fault, idx in keep.items():
        idx = idx.to(k.device)
        out = plain(q, k[:, :, idx], v[:, :, idx], None, None, False,
                    sm_scale)
        errs[fault] = float((out.float() - ref).abs().max())
        if not errs[fault] > limit:
            raise AssertionError(f"flash T{t}: the planted fault {fault!r} "
                                 f"errs {errs[fault]:.3g}, within the limit "
                                 f"{limit:.3g}")
    return errs


def kernels_flash_flux(results):
    """The flash forward at the shapes of LVLM inference into FLUX: FLUX.1-
    dev's joint attention (B1, 24 heads of 128, unmasked) over 128 aligned
    tokens + a 1024² image's 4096 (T4224) and over embedding_type "both"'s
    411 + 4096 (T4507, no multiple of a tile), held at FLUX_FLASH_REL *
    max|ref| with the planted faults shown to fail it, and CLIP-L's causal
    layer (B1, 12 heads of 64, T77); q/k/v as the modules hand them over:
    head-transposed views of (B, T, H, D) projections. Each also with a
    cold L2 and checked to be one device launch a call."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)

    for t, h, d, causal, label in (
            (4224, 24, 128, False, "flux joint B1 H24 T4224 D128"),
            (4507, 24, 128, False, "flux joint ragged B1 H24 T4507 D128"),
            (77, 12, 64, True, "clip-l B1 H12 T77 D64 causal")):
        q, k, v = (randn((1, t, h, d), s).transpose(1, 2)
                   for s in (95, 96, 97))
        pairs = h * (t * (t + 1) // 2 if causal else t * t)
        run = lambda q=q, k=k, v=v, c=causal, d=d: flash_attention(
            q, k, v, None, None, c, d ** -0.5)
        plain = lambda q=q, k=k, v=v, c=causal, d=d: mha_reference(
            q, k, v, None, None, c, d ** -0.5)
        if causal:
            tol = "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)"
            ok = lambda e, r: e <= 2e-2 + 2e-2 * r.abs()
        else:
            limit = flux_flash_limit(plain())
            tol = (f"{FLUX_FLASH_REL:g} * max|ref| = {limit:.3g} (P rounded "
                   "to bf16; bf16 output)")
            ok = lambda e, r, limit=limit: e <= limit
        results.append(check(
            "flash_attention_fwd", label + " (projection views)", run, plain,
            ok, tol, (nbytes(q, k, v, q), 4 * pairs * d, "bf16"),
            library=lambda q=q, k=k, v=v, c=causal, d=d:
                F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                               scale=d ** -0.5),
            cold="flash_fwd"))
        if not causal:
            faults = flash_flux_faults(q, k, v, d ** -0.5, limit)
            results[-1]["planted_fault_errs"] = faults
            say("kernels", f"{label}: planted faults in the plain version "
                "err " + ", ".join(f"{f} {e:.3g}" for f, e in faults.items())
                + f", each beyond the limit {limit:.3g}")
        expect_one_launch("kernels", label, run, "flash_fwd")
        del q, k, v


def kernels_flash_cogvideo(results):
    """The flash forward at CogVideoX-5b's joint attention (B1, 48 heads of
    64, unmasked, scale 1/8) over 226 text + 13 x 30 x 45 video tokens
    (T17776: 139 tiles of 128 rows, the last one 112) and over 226 + one
    latent frame's 1,350 (T1576, a 40-row tail); q/k/v as the block hands
    them over: head-transposed views of contiguous (B, T, H, D) tensors.
    Held at FLUX_FLASH_REL * max|ref| (q and k of std 1 give logits of std
    1, as FLUX's rows) against mha_reference two heads at a time
    (``mha_heads``), the planted faults shown to fail that limit; SDPA as
    the library call; cold L2; one device launch a call."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.flash_attention import flash_attention

    h, d = 48, 64
    for t in (17776, 1576):
        label = f"cogvideox joint B1 H{h} T{t} D{d}"
        q, k, v = (randn((1, t, h, d), s).transpose(1, 2)
                   for s in (113, 114, 115))
        run = lambda q=q, k=k, v=v: flash_attention(q, k, v, None, None,
                                                    False, d ** -0.5)
        plain = lambda q=q, k=k, v=v: mha_heads(q, k, v, None, None, False,
                                                d ** -0.5)
        limit = flux_flash_limit(plain())
        results.append(check(
            "flash_attention_fwd", label + " (views of contiguous (B, T, H, "
            "D))", run, plain, lambda e, r, limit=limit: e <= limit,
            f"{FLUX_FLASH_REL:g} * max|ref| = {limit:.3g} (P rounded to "
            "bf16; bf16 output)", (nbytes(q, k, v, q), 4 * h * t * t * d,
                                   "bf16"),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5), cold="flash_fwd"))
        faults = flash_flux_faults(q, k, v, d ** -0.5, limit, mha_heads)
        results[-1]["planted_fault_errs"] = faults
        say("kernels", f"{label}: planted faults in the plain version err "
            + ", ".join(f"{f} {e:.3g}" for f, e in faults.items())
            + f", each beyond the limit {limit:.3g}")
        expect_one_launch("kernels", label, run, "flash_fwd")
        del q, k, v
        torch.cuda.empty_cache()


def kernels_rmsnorm_flux(results):
    """RMSNorm at FLUX's per-head q/k norm: a single block's q over 4224
    tokens x 24 heads, rows of 128, in the (B, S, H, D) layout of the
    projection (no copy), with the f32 scale cast to bf16; cold L2 and one
    device launch a call."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    x = randn((1, 4224, 24, 128), 98) * 3.0
    scale = randn((128,), 99, torch.float32).to(torch.bfloat16)
    run = lambda: rmsnorm(x, scale, 1e-6)
    results.append(check(
        "rmsnorm", "flux q/k norm R101376 (24 x 4224) D128",
        run, lambda: rmsnorm_reference(x, scale, 1e-6),
        lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
        (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
        library=lambda: F.rms_norm(x, (128,), scale, 1e-6), cold="rmsnorm"))
    expect_one_launch("kernels", "rmsnorm flux q/k norm", run, "rmsnorm")


def kernels_flash_clip(results):
    """The flash forward at the shapes of ThinkDiff-CLIP: BLIP-2's ViT-g
    (16 heads of 88, T257 for a 224² image; B1 at inference, B32 in
    training), q/k/v as the block hands them over (head-transposed views of
    its three 1408-wide projections, no copy), each also with a cold L2 and
    checked to be one device launch a call; and the flan-t5-xxl encoder's
    self-attention (B32 H64 T128 D64, sm_scale 1, the bidirectional
    relative bias in the kernel's layout and a kv_mask of ragged caption
    halves) on views of its q/k/v projections."""
    import torch.nn.functional as F

    from thinkdiff_torch.models.t5 import relative_position_bucket
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, kernel_bias, mha_reference)

    tol = "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)"
    ok = lambda e, r: e <= 2e-2 + 2e-2 * r.abs()
    t, h, d = 257, 16, 88
    for b in (1, 32):
        q, k, v = (randn((b, t, h * d), s).reshape(b, t, h, d).transpose(1, 2)
                   for s in (100, 101, 102))
        run = lambda q=q, k=k, v=v: flash_attention(q, k, v, None, None,
                                                    False, d ** -0.5)
        label = f"vit-g B{b} H16 T257 D88"
        results.append(check(
            "flash_attention_fwd", label + " (projection views)", run,
            lambda q=q, k=k, v=v: mha_reference(q, k, v, None, None, False,
                                                d ** -0.5),
            ok, tol, (nbytes(q, k, v, q), 4 * b * h * t * t * d, "bf16"),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5), cold="flash_fwd"))
        expect_one_launch("kernels", label, run, "flash_fwd")
        del q, k, v
    b, t, h = 32, 128, 64
    heads = lambda x: x.reshape(b, t, h, 64).transpose(1, 2)
    q, k, v = (heads(randn((b, t, h * 64), s)) for s in (103, 104, 105))
    rel = torch.arange(t, device="cuda")
    buckets = relative_position_bucket(rel[None] - rel[:, None], True, 32, 128)
    table = randn((32, h), 106, torch.float32)
    bias = kernel_bias(table[buckets.long()].permute(2, 0, 1)[None])
    lens = torch.randint(4, t + 1, (b,), generator=torch.Generator(
        device="cuda").manual_seed(107), device="cuda")
    kv_mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).int()
    mask = torch.where(kv_mask[:, None, None, :] > 0, bias, -1e30).to(
        torch.bfloat16)
    run = lambda: flash_attention(q, k, v, bias, kv_mask, False, 1.0)
    results.append(check(
        "flash_attention_fwd", "t5 encoder B32 H64 T128 D64 bidirectional "
        "rel bias + kv_mask (projection views)", run,
        lambda: mha_reference(q, k, v, bias, kv_mask, False, 1.0),
        ok, tol, (nbytes(q, k, v, q, bias, kv_mask),
                  4 * h * int(lens.sum()) * t * 64, "bf16"),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0)))
    expect_one_launch("kernels", "t5 encoder self-attention", run, "flash_fwd")


def kernels_rmsnorm_clip(results):
    """RMSNorm at the flan-t5-xxl encoder's layer norms in ThinkDiff-CLIP
    training: 32 captions x 128 tokens, rows of 4096."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    x, scale = randn((4096, 4096), 108) * 3.0, randn((4096,), 109)
    results.append(check(
        "rmsnorm", "t5 encoder R4096 D4096",
        lambda: rmsnorm(x, scale, 1e-6),
        lambda: rmsnorm_reference(x, scale, 1e-6),
        lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
        (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
        library=lambda: F.rms_norm(x, (4096,), scale, 1e-6), cold="rmsnorm"))


def kernels_flash_t5_decode(results, ok, tol):
    """A greedy flan-t5-xxl step of lvlm-text (B1, 64 heads of 64, sm_scale
    1): self-attention over the t decoder rows (causal + the relative bias)
    and cross-attention of t rows over the 411 conditioning rows (kv_mask),
    q/k/v as the T5 layer hands them over: head-transposed views of the
    fused projections."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)

    heads = lambda x, t: x.reshape(1, t, 64, 64).transpose(1, 2)
    t = 16
    qkv = randn((1, t, 3 * 4096), 90)
    q, k, v = (heads(x, t) for x in qkv.split(4096, dim=-1))
    bias = randn((1, 64, t, t), 91, torch.float32) * 0.5
    causal = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    mask = torch.where(causal, bias, -1e30).to(torch.bfloat16)
    results.append(check(
        "flash_attention_fwd", f"t5 decode self B1 H64 T{t} D64 causal + rel "
        "bias (fused qkv views)",
        lambda: flash_attention(q, k, v, bias, None, True, 1.0),
        lambda: mha_reference(q, k, v, bias, None, True, 1.0),
        ok, tol, (nbytes(q, k, v, q, bias), 4 * 64 * t * (t + 1) // 2 * 64,
                  "bf16"),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0)))
    tk = 411
    kv = randn((1, tk, 2 * 4096), 92)
    k, v = (heads(x, tk) for x in kv.split(4096, dim=-1))
    kv_mask = (torch.arange(tk, device="cuda") < tk - 11).int()[None]
    for t in (16, 32):
        q = heads(randn((1, t, 4096), 93), t)
        mask = torch.where(kv_mask[:, None, None, :] > 0, 0.0, -1e30).to(
            torch.bfloat16)
        results.append(check(
            "flash_attention_fwd", f"t5 decode cross B1 H64 Tq{t} Tk{tk} D64 "
            "kv_mask (fused kv views)",
            lambda q=q: flash_attention(q, k, v, None, kv_mask, False, 1.0),
            lambda q=q: mha_reference(q, k, v, None, kv_mask, False, 1.0),
            ok, tol, (nbytes(q, k, v, q, kv_mask),
                      4 * 64 * t * (tk - 11) * 64, "bf16"),
            library=lambda q=q, mask=mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0)))


def host_us(fn, calls: int = 400) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work: calls
    back to back, one synchronize at the end (for a kernel shorter than its
    enqueue, the card waits on the host)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def flash_tile_sweep():
    """The forward kernel's tile configurations (block_q, block_k, ring
    stages) and RMSNorm's warps a row at the kernel table's shapes: device
    ms of each (torch.profiler) against the plain version, and the host
    time a call of the wrappers (flash attention, RMSNorm) and of their
    one-call yardsticks. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.flash_tile_sweep()"``."""
    from unittest import mock

    import torch.nn.functional as F

    from thinkdiff_torch.ops import flash_attention as fa
    from thinkdiff_torch.ops.norms import rmsnorm

    dec, enc = packed_segments()
    heads = lambda x, t: x.reshape(x.shape[0], t, -1, 64).transpose(1, 2)
    q, k, v = (randn((32, 16, 1024, 80), s) for s in (1, 2, 3))
    cases = [("vision B32 H16 S1024 D80", q, k, v,
              dict(sm_scale=80 ** -0.5))]
    for b in (1, 32):
        q, k, v = (randn((b, 257, 1408), s).reshape(b, 257, 16, 88)
                   .transpose(1, 2) for s in (100, 101, 102))
        cases.append((f"vit-g B{b} H16 T257 D88", q, k, v,
                      dict(sm_scale=88 ** -0.5)))
    q, k, v = (randn((4, 64, 256, 64), s) for s in (30, 31, 32))
    cases += [("t5 self B4 H64 T256", q, k, v, dict(
        bias=randn((1, 64, 256, 256), 34, torch.float32) * 0.5, causal=True,
        sm_scale=1.0, q_segment_ids=dec, kv_segment_ids=dec)),
        ("t5 cross B4 H64 256x256", q, k, v, dict(
            kv_mask=(enc > 0).int(), sm_scale=1.0, q_segment_ids=dec,
            kv_segment_ids=enc))]
    q = randn((8, 12, 512, 128), 4)
    k, v = randn((8, 2, 512, 128), 5), randn((8, 2, 512, 128), 6)
    lens = torch.tensor([512, 480, 300, 290, 280, 270, 260, 100], device="cuda")
    pad = ((torch.arange(512, device="cuda")[None] >= lens[:, None]).float()
           * -1e30)[:, None, None, :]
    cases.append(("lm prefill B8 Hq12 Hkv2 T512 D128", q, k, v,
                  dict(bias=pad, causal=True)))
    kv = randn((1, 411, 8192), 92)
    k, v = (heads(x, 411) for x in kv.split(4096, dim=-1))
    cases.append(("t5 decode cross Tq16 Tk411", heads(randn((1, 16, 4096), 93), 16),
                  k, v, dict(kv_mask=torch.ones((1, 411), dtype=torch.int32,
                                                device="cuda"), sm_scale=1.0)))
    for label, q, k, v, kw in cases:
        d = q.shape[-1]
        ref = fa.mha_reference(q, k, v, **kw)
        bias = kw.get("bias")
        mode = None if bias is None else "tile" if bias.shape[2] > 1 else "row"
        flags = (mode, "kv_mask" in kw, "q_segment_ids" in kw)
        chosen = fa.flash_fwd_tiles(q.shape[2], d, *flags)
        bk = 128 if d == 64 else 64  # the instantiated (D, block_k)
        for bq in (64, 128, 192) if d in (80, 88) else (64, 128):
            for st in (2, 3, 4, 6, 8):
                if fa.flash_fwd_smem(d, bq, bk, st, *flags) > fa.SMEM_LIMIT:
                    continue
                cfg = (bq, bk, st)
                with mock.patch.object(fa, "flash_fwd_tiles",
                                       lambda *a, c=cfg, **_: c):
                    run = lambda: fa.flash_attention(q, k, v, **kw)
                    err = float((run().float() - ref.float()).abs().max())
                    dev = device_ms(run)
                say("sweep", f"flash {label} block_q {bq} block_k {bk} "
                    f"stages {st}{' (chosen)' if cfg == chosen else ''}: "
                    f"device {dev:.4f} ms, max|err| {err:.3g}")
    from thinkdiff_torch.ops import norms

    for r, d in ((256, 1536), (4096, 1536), (16, 3584), (2048, 3584),
                 (1024, 4096)):
        x, scale = randn((r, d), 9) * 3.0, randn((d,), 10)
        ref = norms.rmsnorm_reference(x, scale)
        for w in (1, 2, 4, 8):
            with mock.patch.object(norms, "rmsnorm_warps",
                                   lambda *a, w=w: w):
                run = lambda: norms.rmsnorm(x, scale)
                err = float((run().float() - ref.float()).abs().max())
                dev = device_ms(run)
            say("sweep", f"rmsnorm R{r} D{d} warps a row {w}"
                f"{' (chosen)' if w == norms.rmsnorm_warps(r, d) else ''}: "
                f"device {dev:.4f} ms, max|err| {err:.3g}")
    q, k, v, kw = cases[-1][1:]
    x, scale = randn((256, 1536), 9), randn((1536,), 10)
    mask = torch.zeros((1, 1, 16, 411), dtype=torch.bfloat16, device="cuda")
    say("sweep", "host us a call (enqueue, back to back): flash t5 decode "
        f"cross {host_us(lambda: fa.flash_attention(q, k, v, **kw)):.1f}, "
        "SDPA same "
        f"{host_us(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)):.1f}"
        f"; rmsnorm R256 D1536 {host_us(lambda: rmsnorm(x, scale)):.1f}, "
        f"F.rms_norm same {host_us(lambda: F.rms_norm(x, (1536,), scale, 1e-6)):.1f}")


def flash_bwd_tile_sweep():
    """The backward kernels (#5 dq, #6 dk/dv) at the training shapes, device
    ms each (torch.profiler): 64 or 128 rows a dq CTA, the ring depths that
    fit, the masks dropped one at a time, and B1 against B4, so that the
    time a CTA takes and what it spends it on can be read (the tile rule of
    ``flash_bwd_tiles`` comes from it; the cross-attention gap to SDPA is
    still open). Run alone: ``python3 -c "import chip_smoke as c;
    c.phase_device(); c.flash_bwd_tile_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import flash_attention as fa

    names = ("bias", "kv_mask", "causal", "sm_scale", "q_segment_ids",
             "kv_segment_ids")
    cases = list(attention_cases())
    variants = []
    for label, q, k, v, do, kw in (cases[0], cases[1]):
        variants.append((label, q, k, v, do, kw))
        for drop in ("bias", "kv_mask", "q_segment_ids"):
            if kw[drop] is not None:
                kw2 = dict(kw, **{drop: None})
                if drop == "q_segment_ids":
                    kw2["kv_segment_ids"] = None
                variants.append((f"{label[:5]} without {drop}", q, k, v, do,
                                 kw2))
        one = {n: (x[:1] if isinstance(x, torch.Tensor) and x.shape[0] == 4
                   else x) for n, x in kw.items()}
        variants.append((f"{label[:5]} B1 (one wave)", q[:1], k[:1], v[:1],
                         do[:1], one))
    for label, q, k, v, do, kw in variants:
        args = [kw[n] for n in names]
        lse = fa._forward_cuda(q, k, v, *args, with_lse=True)[1]
        bargs = (q, k, v, *args, lse, do)
        mode = None if kw["bias"] is None else "tile"
        tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
        chosen = fa.flash_bwd_tiles(tq, tk, d, mode)
        want = fa.flash_attention_backward_reference(*bargs)
        sizes = [("dq", 0, (bq, 64), st) for bq in (64, 128)
                 for st in range(2, fa.MAX_STAGES + 1)]
        sizes += [("dkv", 1, (64, 64), st)
                  for st in range(2, fa.MAX_STAGES + 1)]
        for kernel, pick, (bq, bk), st in sizes:
            smem = fa.flash_bwd_smem(kernel, d, bq, bk, st, mode)
            if smem > fa.SMEM_LIMIT:
                continue
            cfg = list(chosen)
            cfg[pick] = (bq, bk, st)
            with mock.patch.object(fa, "flash_bwd_tiles",
                                   lambda *a, c=tuple(cfg), **_: c):
                got = fa.flash_attention_backward(*bargs)
                err = max(float((g.float() - w.float()).abs().max()
                                / w.float().abs().max())
                          for g, w in zip(got, want))
                _, delta = fa.flash_dq_cuda(*bargs)
                run = ((lambda: fa.flash_dq_cuda(*bargs)) if kernel == "dq"
                       else (lambda: fa.flash_dkv_cuda(*bargs, delta)))
                dev = device_ms(run, runs=50)
            say("sweep", f"flash {kernel} {label}: block_q {bq} block_k "
                f"{bk} stages {st}"
                f"{' (chosen)' if (bq, bk, st) == chosen[pick] else ''}: "
                f"device {dev:.4f} ms, max|err| {err:.3g} of max|ref|")


def kernel_ab(root: str = ".",
              parts=("flash", "rmsnorm", "flash_bwd", "s8", "wide", "gemv",
                     "paged", "sample", "qx")):
    """Device and event ms of the flash forward (#1), RMSNorm (#3), the
    flash backward (#5 and #6 each, and ``flash_attention_backward``, both
    at the training shapes, contiguous and in the T5 layout) and the w8a8
    GEMMs (#2, #7 at every ``s8_table_shapes`` shape, with the host time a
    call, ``host_us``) and the weight-only wide GEMMs (#10, #11 at every
    ``WIDE_TABLE`` shape, beside the one-call library route), the GEMV (#9
    at every ``T5_GEMV_SHAPES`` shape x R 1, 8, 16, 32) and the paged
    decode (#4 at every ``paged_shapes`` case), these two also with a cold
    L2 (``cold_ms``) and the host time a call, the fused sampler (#8 at
    every ``sample_cases`` shape, noise off and on: cold, its whole device
    time a call, event, host) and the quantize-in-kernel GEMM (#12 at
    ``kernels_s8_qx``'s shapes beside the port's pre-pass + #2), at the
    kernel table's shapes, through the package of
    the checkout at ``root``,
    so that two commits' kernels can be held against each other on one
    machine: unpack the other commit (``git archive``) into a git-ignored
    directory and alternate the two processes, e.g.
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.kernel_ab('build/parent')"``
    then ``c.kernel_ab('.')``, then again in the reverse order. ``parts``
    picks the kernels."""
    sys.path.insert(0, str(Path(root).resolve()))
    import thinkdiff_torch

    where = Path(thinkdiff_torch.__file__).resolve().parent.parent
    if "s8" in parts:
        for label, r, c, o, bwd in s8_table_shapes():
            run = s8_case(r, c, o, bwd)[0]
            say("ab", f"{where.name} {'s8_matmul_bwd' if bwd else 's8_matmul'}"
                f" {label}: device {device_ms(run, runs=50):.4f} ms, event "
                f"{time_ms(run):.4f} ms, host {host_us(run):.1f} us a call")
            del run
        torch.cuda.empty_cache()
    if "wide" in parts:
        for label, r, kk, n, bwd in WIDE_TABLE:
            run, _, library, _ = wide_case(r, kk, n, bwd)
            op = "int8_matmul_wide_bwd" if bwd else "int8_matmul_wide_fwd"
            say("ab", f"{where.name} {op} {label}: device "
                f"{device_ms(run, runs=50):.4f} ms, event {time_ms(run):.4f} "
                f"ms; library device {device_ms(library, runs=50):.4f} ms, "
                f"event {time_ms(library):.4f} ms")
            del run, library
        torch.cuda.empty_cache()
    if "gemv" in parts:
        for kk, n, proj in T5_GEMV_SHAPES:
            for r in (1, 8, 16, 32):
                run, _, _, work = gemv_case(r, kk, n)
                ab_bandwidth(where, f"int8_matmul {proj} R{r} K{kk} N{n}",
                             run, "int8_gemv", work)
                del run
        torch.cuda.empty_cache()
        for r in (8, 16, 32):
            dev, ev = gemv_t5_step(r)
            say("ab", f"{where.name} int8_matmul T5 step at R{r} (the 217 "
                f"GEMV calls of a greedy step back to back, 5.57 GB of "
                f"weights): device {dev:.3f} ms, event {ev:.3f} ms")
        torch.cuda.empty_cache()
    if "paged" in parts:
        from thinkdiff_torch.ops.paged_attention import paged_attention

        for label, slots, h, hkv, lengths in paged_shapes()[:3]:
            *ops, work = paged_case(slots, h, hkv, lengths)
            ab_bandwidth(where, f"paged_attention {label}",
                         lambda: paged_attention(*ops), "paged_decode", work)
            del ops
        torch.cuda.empty_cache()
    if "sample" in parts:
        kernel_ab_sample(where)
    if "qx" in parts:
        kernel_ab_qx(where)
    if "flash" in parts:
        kernel_ab_flash(where)
    if "rmsnorm" in parts:
        kernel_ab_rmsnorm(where)
    if "flash_bwd" in parts:
        kernel_ab_flash_bwd(where)


def gemv_t5_step(r: int, seed: int = 70):
    """(device ms, event ms) of one greedy flan-t5-xxl step's weight-only
    products at r decoder rows, back to back as the decode issues them: 24
    layers x (q, k, v, o, cross q, cross o, wi_0, wi_1, wo) + lm_head, 217
    calls over 5.57 GB of seeded int8 weights (no weight stays in the L2
    from one step to the next). Device time from torch.profiler (the GEMV
    kernels only run), event time around the whole sequence."""
    from thinkdiff_torch.ops.int8_matmul import int8_matmul

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ([(4096, 4096)] * 6 + [(4096, 10240)] * 2 + [(10240, 4096)]) * 24
    layers = []
    for kk, n in shapes + [(4096, 32128)]:
        w = torch.randint(-127, 128, (n, kk), dtype=torch.int8, device="cuda",
                          generator=g).t()  # QDense's layout
        layers.append((kk, w, torch.rand(n, device="cuda", generator=g) / 512))
    xs = {kk: randn((r, kk), seed + kk) for kk in (4096, 10240)}
    run = lambda: [int8_matmul(xs[kk], w, s) for kk, w, s in layers]
    out = device_ms(run, runs=3), time_ms(run, warmup=1, runs=5)
    del layers
    return out


def ab_bandwidth(where, label, run, kernel, work):
    """One ``kernel_ab`` line of a bandwidth kernel: device ms with a cold
    L2 and its share of the bound, warm device ms, event ms, host us."""
    cold = cold_ms(run, kernel)
    b_ms = bound_ms(*work)[0]
    say("ab", f"{where.name} {label}: cold device {cold:.4f} ms "
        f"({b_ms / cold:.0%} of the {b_ms:.4f} ms bound), warm device "
        f"{device_ms(run, runs=50):.4f} ms, event {time_ms(run):.4f} ms, "
        f"host {host_us(run):.1f} us a call")


def kernel_ab_sample(where):
    """``kernel_ab``'s fused-sampler lines: the weight (236-550 MB) never
    fits the L2, so cold is the path's case; device is every kernel a call
    (a pre-pass included), event and host a call besides."""
    from thinkdiff_torch.ops.fused_sample import fused_lm_sample

    seed = torch.tensor([2024, -77], dtype=torch.int32, device="cuda")
    for label, pack, b in sample_cases():
        x = randn((b, pack["qt"].shape[1]), 15)
        blocked = (torch.arange(b, device="cuda") % 4 == 0).float()
        b_ms = bound_ms(*sample_work(pack, x, blocked))[0]
        for nz in (False, True):
            run = (lambda nz=nz, pk=pack: fused_lm_sample(
                x, pk, blocked, seed, temperature=0.6 if nz else 0.0,
                noise=nz))
            cold = cold_ms(run, "fused_sample")
            say("ab", f"{where.name} fused_lm_sample {label}, noise "
                f"{'on' if nz else 'off'}: cold device {cold:.4f} ms "
                f"({b_ms / cold:.0%} of the {b_ms:.4f} ms bound), device "
                f"{device_ms(run, runs=50):.4f} ms (every kernel a call), "
                f"event {time_ms(run):.4f} ms, host {host_us(run):.1f} us a "
                "call")
    torch.cuda.empty_cache()


def sample_sweep():
    """The fused sampler's plans at every ``sample_cases`` shape, noise off
    and on: rings of 3, 5 and the deepest (stages a ring; two rings a
    CTA), cold device ms each (``cold_ms``), each plan's ids checked
    identical to ``sample_plan``'s own. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.sample_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import fused_sample as fs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = torch.tensor([2024, -77], dtype=torch.int32, device="cuda")
    for label, pack, b in sample_cases():
        vp, d = pack["qt"].shape
        x = randn((b, d), 15)
        blocked = (torch.arange(b, device="cuda") % 4 == 0).float()
        chosen = fs.sample_plan(b, d, vp, sms)
        n, tiles = chosen[:2]
        fit = [st for st in range(2, fs.SAMPLE_MAX_STAGES + 1)
               if fs.sample_smem(n, tiles, st) <= fs.SMEM_LIMIT]
        for nz in (False, True):
            run = (lambda nz=nz: fs.fused_lm_sample(
                x, pack, blocked, seed, temperature=0.6 if nz else 0.0,
                noise=nz))
            want = run()
            for stages in sorted({3, 5, max(fit)} & set(fit)):
                cfg = (n, tiles, stages, chosen[3])
                with mock.patch.object(fs, "sample_plan",
                                       lambda *a, c=cfg: c):
                    same = torch.equal(run(), want)
                    cold = cold_ms(run, "fused_sample_kernel")
                say("sweep", f"sample {label} noise {'on' if nz else 'off'}"
                    f" stages {stages}"
                    f"{' (plan)' if cfg == chosen else ''}: cold device "
                    f"{cold:.4f} ms, {'identical' if same else 'DIFFERS'}")
    torch.cuda.empty_cache()


def kernel_ab_qx(where):
    """``kernel_ab``'s lines of #12 at ``kernels_s8_qx``'s shapes, beside
    the port's pre-pass + #2 (the route #12 replaces)."""
    from thinkdiff_torch.ops import int8_matmul as im
    from thinkdiff_torch.ops.quant import _absmax_quant_rows

    x = randn((1024, 4096), 66) * 3.0
    for n in (4096, 20480):
        w, s = int8_weight(4096, n, 65)
        for label, run in (
                ("s8_matmul_qx", lambda: im.s8_matmul_qx(x, w, s)),
                ("pre-pass + s8_matmul", lambda: im.s8_matmul(
                    *_absmax_quant_rows(x), w, s))):
            say("ab", f"{where.name} {label} R1024 K4096 N{n}: device "
                f"{device_ms(run, runs=50):.4f} ms, event {time_ms(run):.4f} "
                f"ms, host {host_us(run):.1f} us a call")
        del w
    torch.cuda.empty_cache()


def kernel_ab_flash(where):
    from thinkdiff_torch.ops.flash_attention import flash_attention

    dec, enc = packed_segments()
    heads = lambda x, t: x.reshape(x.shape[0], t, -1, 64).transpose(1, 2)
    cases = []
    q, k, v = (randn((32, 16, 1024, 80), s) for s in (1, 2, 3))
    cases.append(("vision B32 H16 S1024 D80", q, k, v,
                  dict(sm_scale=80 ** -0.5)))
    qkv = randn((32, 1024, 3, 16, 80), 1)
    cases.append(("vision strided (fused qkv slices)",
                  *(qkv[:, :, i].transpose(1, 2) for i in range(3)),
                  dict(sm_scale=80 ** -0.5)))
    q, k, v = (randn((4, 64, 256, 64), s) for s in (30, 31, 32))
    cases.append(("train self B4 H64 T256 D64", q, k, v, dict(
        bias=randn((1, 64, 256, 256), 34, torch.float32) * 0.5, causal=True,
        sm_scale=1.0, q_segment_ids=dec, kv_segment_ids=dec)))
    cases.append(("train cross B4 H64 256x256 D64", q, k, v, dict(
        kv_mask=(enc > 0).int(), sm_scale=1.0, q_segment_ids=dec,
        kv_segment_ids=enc)))
    q, k, v = (randn(s, i) for s, i in (((4, 16, 256, 128), 40),
                                         ((4, 4, 256, 128), 41),
                                         ((4, 4, 256, 128), 42)))
    cases.append(("GQA B4 Hq16 Hkv4 T256 D128 causal", q, k, v,
                  dict(causal=True)))
    q = randn((8, 12, 512, 128), 4)
    k, v = randn((8, 2, 512, 128), 5), randn((8, 2, 512, 128), 6)
    lens = torch.tensor([512, 480, 300, 290, 280, 270, 260, 100], device="cuda")
    pad = ((torch.arange(512, device="cuda")[None] >= lens[:, None]).float()
           * -1e30)[:, None, None, :]
    cases.append(("lm prefill B8 Hq12 Hkv2 T512 D128 causal+pad", q, k, v,
                  dict(bias=pad, causal=True)))
    qkv = randn((1, 16, 3 * 4096), 90)
    q, k, v = (heads(x, 16) for x in qkv.split(4096, dim=-1))
    cases.append(("t5 decode self B1 H64 T16", q, k, v, dict(
        bias=randn((1, 64, 16, 16), 91, torch.float32) * 0.5, causal=True,
        sm_scale=1.0)))
    kv = randn((1, 411, 8192), 92)
    k, v = (heads(x, 411) for x in kv.split(4096, dim=-1))
    kv_mask = (torch.arange(411, device="cuda") < 400).int()[None]
    for t in (16, 32):
        cases.append((f"t5 decode cross B1 H64 Tq{t} Tk411", heads(
            randn((1, t, 4096), 93), t), k, v,
            dict(kv_mask=kv_mask, sm_scale=1.0)))
    for label, q, k, v, kw in cases:
        run = lambda: flash_attention(q, k, v, **kw)
        say("ab", f"{where.name} flash {label}: device "
            f"{device_ms(run, runs=50):.4f} ms, event {time_ms(run):.4f} ms")


def kernel_ab_rmsnorm(where):
    from thinkdiff_torch.ops.norms import rmsnorm

    for r, d in ((256, 1536), (4096, 1536), (16, 3584), (2048, 3584),
                 (1024, 4096)):
        x, scale = randn((r, d), 9) * 3.0, randn((d,), 10)
        run = lambda: rmsnorm(x, scale, 1e-6)
        say("ab", f"{where.name} rmsnorm R{r} D{d}: device "
            f"{device_ms(run, runs=50):.4f} ms, event {time_ms(run):.4f} ms")


def kernel_ab_flash_bwd(where):
    from thinkdiff_torch.ops import flash_attention as fa

    names = ("bias", "kv_mask", "causal", "sm_scale", "q_segment_ids",
             "kv_segment_ids")
    for label, q, k, v, do, kw in attention_cases():
        args = [kw[n] for n in names]
        lse = fa._forward_cuda(q, k, v, *args, with_lse=True)[1]
        bargs = (q, k, v, *args, lse, do)
        delta = fa.flash_dq_cuda(*bargs)[1]
        for part, run in (
                ("dq", lambda: fa.flash_dq_cuda(*bargs)),
                ("dkv", lambda: fa.flash_dkv_cuda(*bargs, delta)),
                ("backward", lambda: fa.flash_attention_backward(*bargs))):
            say("ab", f"{where.name} flash {part} {label}: device "
                f"{device_ms(run, runs=50):.4f} ms, event "
                f"{time_ms(run):.4f} ms")


# the w8a8 projections of the 2B LM (serving) and of the 7B LM (lvlm-text):
# (K, N, name)
S8_2B = ((1536, 2048, "qkv"), (1536, 1536, "o"), (1536, 17920, "gate_up"),
         (8960, 1536, "down"))
S8_7B = ((3584, 4608, "qkv"), (3584, 3584, "o"), (3584, 37888, "gate_up"),
         (18944, 3584, "down"))


def s8_table_shapes():
    """(label, rows, contraction, output columns, input gradient) of every
    w8a8 call in PERF.md's table: the training projections forward and
    backward, the 2B serving projections at R8, R256 and R4096, the 7B
    decode at R16."""
    shapes = []
    for r, kk, n, proj in TRAIN_PROJECTIONS:
        shapes.append((f"train {proj} R{r} K{kk} N{n}", r, kk, n, False))
        shapes.append((f"train {proj} dx R{r} K{kk} N{n}", r, n, kk, True))
    for r in (8, 256, 4096):
        shapes += [(f"2B {proj} R{r} K{kk} N{n}", r, kk, n, False)
                   for kk, n, proj in S8_2B]
    shapes += [(f"7B {proj} R16 K{kk} N{n}", 16, kk, n, False)
               for kk, n, proj in S8_7B]
    return shapes


def s8_case(r, c, o, bwd, seed=40):
    """Seeded operands of a w8a8 call with an (r, o) output over a
    contraction of c: (kernel, plain version, ``torch._int_mm`` + scales,
    (bytes, operations, "int8")). Forward: xq (r, c), the weight (c, o) in
    QDense's load-time layout. Input gradient: gq (r, c), the weight's (o,
    c) row-major training copy."""
    from thinkdiff_torch.ops.int8_matmul import (
        s8_matmul, s8_matmul_bwd, s8_matmul_bwd_reference,
        s8_matmul_reference)
    from thinkdiff_torch.ops.quant import _absmax_quant_rows, quantize_weight

    aq, sa = _absmax_quant_rows(randn((r, c), seed + 1, torch.float32))
    out = torch.empty((r, o), dtype=torch.bfloat16, device="cuda")
    if bwd:
        w = quantize_weight(randn((o, c), seed, torch.float32) * 0.02)["q"]
        w_t = w.t().contiguous()
        return (lambda: s8_matmul_bwd(aq, sa, w),
                lambda: s8_matmul_bwd_reference(aq, sa, w),
                lambda: (torch._int_mm(aq, w_t).float()
                         * sa[:, None]).to(torch.bfloat16),
                (nbytes(aq, sa, w, out), 2 * r * c * o, "int8"))
    qw = quantize_weight(randn((c, o), seed, torch.float32) * 0.02)
    w_rm, scale = qw["q"], qw["scale"]
    w = w_rm.t().contiguous().t()  # QDense's load-time layout
    return (lambda: s8_matmul(aq, sa, w, scale),
            lambda: s8_matmul_reference(aq, sa, w, scale),
            lambda: (torch._int_mm(aq, w_rm).float() * sa[:, None]
                     * scale[None]).to(torch.bfloat16),
            (nbytes(aq, sa, w, scale, out), 2 * r * c * o, "int8"))


def s8_gemm_sweep(labels=None):
    """The w8a8 kernel's plans (``s8_gemm_plan``) at ``s8_table_shapes``
    (those whose label contains one of ``labels``, or all): device ms
    (torch.profiler) of both tile widths at every split of the contraction
    that leaves none empty, up to 16, at the deepest ring and at 3 stages,
    each output checked identical to the plan's own, beside
    ``torch._int_mm`` + scales. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.s8_gemm_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, r, c, o, bwd in s8_table_shapes():
        if labels and not any(x in label for x in labels):
            continue
        run, _, library, work = s8_case(r, c, o, bwd)
        want = run()
        chosen = im.s8_gemm_plan(r, c, o, sms)
        steps = -(-c // im.S8_BLOCK_K)
        say("sweep", f"s8 {label}: plan {chosen}, bound "
            f"{bound_ms(*work)[0]:.4f} ms, _int_mm + scales device "
            f"{device_ms(library) if r >= 32 else float('nan'):.4f} ms")
        splits = sorted({-(-steps // -(-steps // z))
                         for z in range(1, min(steps, 16) + 1)})
        for bn in (128, 256):
            deepest = max(st for st in range(2, im.S8_MAX_STAGES + 1)
                          if im.s8_gemm_smem(chosen[0], bn, st)
                          <= im.SMEM_LIMIT)
            for stages in sorted({deepest, 3}):
                for split in splits:
                    cfg = (chosen[0], bn, stages, split)
                    with mock.patch.object(im, "s8_gemm_plan",
                                           lambda *a, c=cfg: c):
                        same = torch.equal(run(), want)
                        dev = device_ms(run)
                    say("sweep", f"s8 {label} block_n {bn} stages {stages} "
                        f"split {split}{' (plan)' if cfg == chosen else ''}: "
                        f"device {dev:.4f} ms, "
                        f"{'identical' if same else 'DIFFERS'}")
        del run, library
        torch.cuda.empty_cache()


def kernels_s8(results):
    # every w8a8 projection of the 2B LM at the dense slice's decode (R=8),
    # the paged slice's decode (R=256) and a 32 x 128 prefill chunk
    # (R=4096), and of the 7B LM at lvlm-text's decode (R=16) and prefill
    # (R=2048)
    for model, rows, projs in (("2B", (8, 256, 4096), S8_2B),
                               ("7B", (16, 2048), S8_7B)):
        for r in rows:
            for kk, n, proj in projs:
                run, plain, library, work = s8_case(r, kk, n, False, seed=7)
                results.append(check(
                    "s8_matmul", f"{model} {proj} R{r} K{kk} N{n}", run, plain,
                    lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp", work,
                    library=library if r >= 32 else None))
                del run, plain, library


def kernels_rmsnorm(results):
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    # the 2B LM (D1536) at the paged decode step and a prefill chunk batch,
    # the 7B LM of lvlm-text (D3584) at its decode step (16 requests) and a
    # 16 x 128 prefill chunk
    for r, d in ((256, 1536), (4096, 1536), (16, 3584), (2048, 3584)):
        x, scale = randn((r, d), 9) * 3.0, randn((d,), 10)
        results.append(check(
            "rmsnorm", f"R{r} D{d}",
            lambda x=x, s=scale: rmsnorm(x, s, 1e-6),
            lambda x=x, s=scale: rmsnorm_reference(x, s, 1e-6),
            lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
            (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
            library=lambda x=x, s=scale, d=d: F.rms_norm(x, (d,), s, 1e-6)))


def paged_case(slots, h, hkv, lengths, seed=11, page=64):
    """Seeded operands of a paged decode step: bf16 pools with each slot's
    pages from a shuffled free list, garbage in the trash page and past
    every slot's length; (q, k, v, table, lengths, (bytes, operations,
    "bf16")): each live token's K and V read once, q read, out written."""
    d = 128
    rs = np.random.RandomState(seed)
    lengths = np.asarray(lengths)
    npages = -(-lengths // page)
    mp = int(npages.max())
    ids = rs.permutation(np.arange(1, 1 + npages.sum() + 8))
    table = np.zeros((slots, mp), np.int32)
    o = 0
    for s, n in enumerate(npages):
        table[s, :n] = ids[o:o + n]
        o += n
    pool = len(ids) + 1
    k, v = (randn((pool, hkv, page, d), seed),
            randn((pool, hkv, page, d), seed + 1))
    k[0], v[0] = 3e3, -3e3
    for s, n in enumerate(lengths):
        if n % page:
            last = int(table[s, npages[s] - 1])
            k[last, :, n % page:], v[last, :, n % page:] = 1e3, -1e3
    q = randn((slots, h, d), seed + 2)
    table_t = torch.from_numpy(table).cuda()
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    tokens = int(lengths.sum())
    work = (tokens * hkv * d * 2 * 2 + nbytes(q, q, table_t, lens),
            4 * h * d * tokens, "bf16")
    return q, k, v, table_t, lens, work


def paged_shapes():
    """(label, slots, heads, kv heads, lengths) of the paged decode's table:
    the 2B step at 256 slots (ragged 1..600), at the gumbel slice's 64, a
    long-context skew (4 of 64 slots at MP x 64 = 2048 tokens, the rest
    1..128), the 7B's geometry (28 heads over 4 kv heads: G 7)."""
    rs = np.random.RandomState(SEED)
    s256 = np.concatenate([[1, 64, 65, 600], rs.randint(1, 601, 252)])
    s64 = rs.randint(1, 601, 64)
    skew = np.concatenate([[2048] * 4, rs.randint(1, 129, 60)])
    g7 = rs.randint(1, 601, 64)
    return (("S256 H12 Hkv2 lengths 1..600", 256, 12, 2, s256),
            ("S64 H12 Hkv2 lengths 1..600", 64, 12, 2, s64),
            ("S64 H12 Hkv2 skew: 4 x 2048, 60 x 1..128", 64, 12, 2, skew),
            ("S64 H28 Hkv4 (G 7) lengths 1..600", 64, 28, 4, g7))


def kernels_paged(results):
    from thinkdiff_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    # tolerance: kernel and plain each round to bf16 (up to one ulp apart,
    # 2^-8 at |ref| < 1); the f32 softmax summed in another order
    for i, (label, slots, h, hkv, lengths) in enumerate(paged_shapes()):
        q, k, v, table, lens, work = paged_case(slots, h, hkv, lengths)
        results.append(check(
            "paged_attention", f"{label} ({int(lengths.sum())} tokens)",
            lambda: paged_attention(q, k, v, table, lens),
            lambda: paged_attention_reference(q, k, v, table, lens),
            lambda e, ref: e <= 4e-3 + 1e-2 * ref.abs(),
            "4e-3 + 1e-2*|ref| (kernel and plain each round to bf16: up to "
            "one ulp apart, 2^-8 at |ref| < 1; f32 softmax summed in another "
            "order)", work, main=i == 0, cold="paged_decode"))
        if i == 0:
            # as the model calls it: int64 lengths (cache_len + 1)
            lens64 = lens.long()
            expect_one_launch("kernels", f"paged_attention {label}",
                              lambda: paged_attention(q, k, v, table, lens64),
                              "paged_decode_kernel")
        del q, k, v
    torch.cuda.empty_cache()


def sample_cases():
    """(label, pack, rows) of every fused-sampler shape the paths give it:
    the 2B tied-embedding pack (a seeded N(0, 0.02) table) at 64 rows (the
    gumbel slice's decode step and first-token group), 8 (a small first-
    token group) and 256 (the shipped configuration's decode step); the
    7B's untied w8a8 lm_head (seeded int8 weight, column scales and input
    scales; D3584, V152064: the opt-in ``sampler: gumbel`` of the LVLM
    inference YAML) at its 16 requests."""
    from thinkdiff_torch.ops.fused_sample import (
        pack_lm_head, pack_tied_embedding)

    eos = [151643, 151645]
    d, v = 1536, 151936
    pack = pack_tied_embedding(randn((v, d), 14, torch.float32) * 0.02, eos)
    cases = [(f"B{b} D{d} V{v} (Vp {pack['qt'].shape[0]}) tied 2B pack",
              pack, b) for b in (64, 8, 256)]
    d, v = 3584, 152064
    g = torch.Generator(device="cuda").manual_seed(16)
    q = torch.randint(-127, 128, (d, v), dtype=torch.int8, device="cuda",
                      generator=g)
    scale = torch.rand(v, device="cuda", generator=g) / 2048 + 1e-4
    iscale = torch.rand(d, device="cuda", generator=g) + 0.5
    pack7 = pack_lm_head(q, scale, input_scale=iscale, eos_ids=eos)
    del q
    cases.append((f"B16 D{d} V{v} (Vp {pack7['qt'].shape[0]}) untied 7B pack",
                  pack7, 16))
    return cases


def sample_work(pack, x, blocked):
    """(bytes, operations, "int8") of one fused-sampler call."""
    vp, d = pack["qt"].shape
    b = x.shape[0]
    return (nbytes(pack["qt"], pack["scale"], pack["pad_bias"],
                   pack["eos_bias"], pack["inv_input"], x, blocked) + b * 8,
            2 * b * d * vp, "int8")


def kernels_fused_sample(results):
    from thinkdiff_torch.ops.fused_sample import (
        fused_lm_sample, fused_lm_sample_reference, gumbel_noise)

    seed = torch.tensor([2024, -77], dtype=torch.int32, device="cuda")
    for label, pack, b in sample_cases():
        vp, d = pack["qt"].shape
        x = randn((b, d), 15)
        blocked = (torch.arange(b, device="cuda") % 4 == 0).float()
        noise = gumbel_noise(seed, b, vp)
        for temp, use_noise in ((0.0, False), (0.6, True)):
            run = (lambda x=x, blk=blocked, t=temp, nz=use_noise, pk=pack:
                   fused_lm_sample(x, pk, blk, seed, temperature=t, noise=nz))
            results.append(check(
                "fused_lm_sample", f"{label}, noise "
                f"{'on, T 0.6' if use_noise else 'off'}", run,
                lambda x=x, blk=blocked, t=temp, nz=use_noise, nn=noise,
                pk=pack: fused_lm_sample_reference(
                    x, pk, blk, temperature=t, noise=nn if nz else None),
                lambda e, ref: e == 0,
                "ids identical" + (" (same keyed Gumbel noise)" if use_noise
                                   else ""),
                sample_work(pack, x, blocked), main=b == 64 and use_noise,
                cold="fused_sample_kernel"))
            expect_one_launch("kernels", f"fused_lm_sample {label}", run,
                              "fused_sample_kernel")
        del noise
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Kernels at the training shapes (bench.py's packed batch: B4, T 256/256)
# ---------------------------------------------------------------------------

def packed_segments():
    """dec/enc segment ids (4, 256) of bench.py's first packed batch."""
    from thinkdiff_torch.data.synthetic import build_batches_packed

    (b,), _ = build_batches_packed(np.random.RandomState(SEED), 1, BENCH_ROWS,
                                   BENCH_CAP, BENCH_CAP, 8, 32128)
    return (torch.from_numpy(b["dec_segments"]).cuda(),
            torch.from_numpy(b["enc_segments"]).cuda())


def attention_cases():
    """(label, q, k, v, dO, kwargs) of the training step's attentions at
    bench.py's point (64 heads of 64, sm_scale 1), contiguous and as the T5
    layer hands them to the kernels (head-transposed views of the fused
    qkv / kv_fused projections, dO the head-transposed view of a contiguous
    (B, T, H*D) gradient), and one GQA D=128 case."""
    dec, enc = packed_segments()
    b, t = dec.shape
    q, k, v, do = (randn((b, 64, t, 64), s) for s in (30, 31, 32, 33))
    bias = randn((1, 64, t, t), 34, torch.float32) * 0.5  # relative bias
    self_kw = dict(bias=bias, kv_mask=None, causal=True, sm_scale=1.0,
                   q_segment_ids=dec, kv_segment_ids=dec)
    cross_kw = dict(bias=None, kv_mask=(enc > 0).int(), causal=False,
                    sm_scale=1.0, q_segment_ids=dec, kv_segment_ids=enc)
    yield ("self B4 H64 T256 D64 causal+rel bias+packed segments", q, k, v,
           do, self_kw)
    yield ("cross B4 H64 256x256 D64 kv_mask+packed segments (pad rows see "
           "no key)", q, k, v, do, cross_kw)
    heads = lambda x: x.reshape(b, t, 64, 64).transpose(1, 2)
    qkv = randn((b, t, 3 * 4096), 39)
    do_t5 = heads(randn((b, t, 4096), 33))
    yield ("self, T5 layout (fused qkv views, strided dO)",
           *(heads(x) for x in qkv.split(4096, dim=-1)), do_t5, self_kw)
    kv = randn((b, t, 2 * 4096), 40)
    yield ("cross, T5 layout (q, kv_fused views, strided dO)",
           heads(randn((b, t, 4096), 41)),
           *(heads(x) for x in kv.split(4096, dim=-1)), do_t5, cross_kw)
    q, do = randn((b, 16, t, 128), 35), randn((b, 16, t, 128), 36)
    k, v = randn((b, 4, t, 128), 37), randn((b, 4, t, 128), 38)
    yield ("GQA B4 Hq16 Hkv4 T256 D128 causal", q, k, v, do,
           dict(bias=None, kv_mask=None, causal=True, sm_scale=128 ** -0.5,
                q_segment_ids=None, kv_segment_ids=None))


def kernels_attention_train(results):
    for i, (label, q, k, v, do, kw) in enumerate(attention_cases()):
        check_attention(results, "train " + label, q, k, v, do, kw,
                        main=i == 0)


def check_attention(results, label, q, k, v, do, kw, main=False):
    """The flash forward (#1) with its lse, and the backward's dq (#5) and
    dk/dv (#6), on one training attention against their plain versions,
    with SDPA as the library yardstick; views of (B, T, H, D) memory are
    checked to be taken without copies, and pad query rows to add
    nothing."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops import flash_attention as fa

    names = ("bias", "kv_mask", "causal", "sm_scale", "q_segment_ids",
             "kv_segment_ids")
    # flash forward: as the serving rows; backward: the kernels round P and
    # dS to bf16 for their products and dq/dk/dv to bf16 (2^-8 relative
    # each) where the plain version keeps f32
    fwd_tol = "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)"
    bwd_tol = f"{BWD_TOL:g} * max|ref| per tensor (P, dS rounded to bf16)"
    bwd_ok = lambda e, r: e <= BWD_TOL * r.abs().max()
    args = [kw[n] for n in names]
    ok = fa._allowed(q, k, kw["kv_mask"], kw["causal"],
                     kw["q_segment_ids"], kw["kv_segment_ids"])
    full = (q.shape[0], 1, q.shape[2], k.shape[2])
    ok = torch.ones(full, dtype=torch.bool, device="cuda") if ok is None \
        else ok.expand(full)
    pairs = int(ok.sum()) * q.shape[1]
    dead = ~ok.any(-1)                                   # (B, 1, Tq)
    d = q.shape[-1]
    side = nbytes(*[x for x in (kw["bias"], kw["kv_mask"],
                                kw["q_segment_ids"], kw["kv_segment_ids"])
                    if x is not None])
    lse_bytes = q.shape[0] * q.shape[1] * q.shape[2] * 4
    mask = torch.where(ok, 0.0, -1e30)
    if kw["bias"] is not None:
        mask = mask + kw["bias"]
    mask = mask.to(torch.bfloat16)
    gqa = q.shape[1] != k.shape[1]

    out, lse = fa._forward_cuda(q, k, v, *args, with_lse=True)
    lse_ref = fa.logsumexp_reference(q, k, *args)
    lse_err = float((lse - lse_ref).abs().max())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash forward lse {label}: max |err| "
                             f"{lse_err} > {LSE_TOL:g}")
    say("kernels", f"flash_attention_fwd lse {label}: max|err| "
        f"{lse_err:.3g} within {LSE_TOL:g} of the plain logsumexp")
    results["flash_attention_fwd"].append(check(
        "flash_attention_fwd", label,
        lambda: fa._forward_cuda(q, k, v, *args, with_lse=True)[0],
        lambda: fa.mha_reference(q, k, v, *args),
        lambda e, r: e <= 2e-2 + 2e-2 * r.abs(), fwd_tol,
        (nbytes(q, k, v, q) + side + lse_bytes, 4 * pairs * d, "bf16"),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=kw["sm_scale"],
            enable_gqa=gqa),
        main=main))

    # the SDPA backward (dq, dk and dv in one call) as the yardstick
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                          scale=kw["sm_scale"],
                                          enable_gqa=gqa)
    library = lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                          retain_graph=True)
    bargs = (q, k, v, *args, lse, do)
    _, delta = fa.flash_dq_cuda(*bargs)
    results["flash_attention_dq"].append(check(
        "flash_attention_dq", label,
        lambda: fa.flash_dq_cuda(*bargs)[0],
        lambda: fa.flash_dq_reference(*bargs)[0], bwd_ok, bwd_tol,
        (nbytes(q, k, v, do, q) + side + 2 * lse_bytes, 6 * pairs * d,
         "bf16"), library=library, main=main))
    results["flash_attention_dkv"].append(check(
        "flash_attention_dkv", label,
        lambda: fa.flash_dkv_cuda(*bargs, delta),
        lambda: fa.flash_dkv_reference(*bargs, delta), bwd_ok, bwd_tol,
        (nbytes(q, k, v, do, k, v) + side + 2 * lse_bytes,
         8 * pairs * d, "bf16"), library=library, main=main))
    if "T5 layout" in label:
        # the training path's layout: no copy of q, k, v or dO (the
        # backward allocates dq, dk, dv and delta, nothing more), and
        # dq/dk/dv come back as views of (B, T, H, D) memory
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fa.flash_attention_backward(q, k, v, *args, lse, do)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        outs = nbytes(*got) + lse_bytes
        if not (all(g.transpose(1, 2).is_contiguous() for g in got)
                and extra <= outs + 65536):
            raise AssertionError(
                f"flash backward {label}: {extra} B allocated for "
                f"{outs} B of outputs, layouts "
                f"{[tuple(g.stride()) for g in got]}")
        say("kernels", f"flash backward {label}: {extra} B allocated for "
            f"{outs} B of dq, dk, dv and delta (no operand copy); dq, dk, "
            "dv are views of (B, T, H, D) memory")
    if dead.any():
        # pad query rows: finite, dq 0, and dk/dv bit-identical whether
        # their dO is poisoned or zero
        poisoned = torch.where(dead[..., None], torch.full_like(do, 1e4),
                               do)
        zeroed = do * (~dead)[..., None].to(do.dtype)
        a = fa.flash_attention_backward(q, k, v, *args, lse, poisoned)
        z = fa.flash_attention_backward(q, k, v, *args, lse, zeroed)
        torch.cuda.synchronize()
        if not (all(torch.isfinite(x.float()).all() for x in a)
                and float((a[0].float() * dead[..., None]).abs().max()) == 0
                and torch.equal(a[1], z[1]) and torch.equal(a[2], z[2])):
            raise AssertionError(f"flash backward {label}: pad rows leak")
        say("kernels", f"flash backward {label}: {int(dead.sum())} pad "
            "query rows per head with dO poisoned (1e4): gradients "
            "finite, dq 0 there, dk/dv bit-identical to zeroed dO")


TRAIN_PROJECTIONS = ((1024, 4096, 12288, "qkv"),
                     (1024, 4096, 4096, "o, q"),
                     (1024, 4096, 8192, "kv_fused"),
                     (1024, 4096, 20480, "wi_fused"),
                     (1024, 10240, 4096, "wo"),
                     (512, 4096, 32128, "lm_head chunk"))


def kernels_s8_train(results):
    # every w8a8 projection of the xxl decoder at the packed batch's 1024
    # rows, the lm_head at a CE chunk's 512 rows: forward (#2) and input
    # gradient (#7, identical to its float64 plain version)
    for r, kk, n, proj in TRAIN_PROJECTIONS:
        main = proj == "wi_fused"
        run, plain, library, work = s8_case(r, kk, n, False)
        results["s8_matmul"].append(check(
            "s8_matmul", f"train {proj} R{r} K{kk} N{n}", run, plain,
            lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp", work,
            library=library, main=main))
        run, plain, library, work = s8_case(r, n, kk, True)
        results["s8_matmul_bwd"].append(check(
            "s8_matmul_bwd", f"{proj} R{r} K{kk} N{n}", run, plain,
            lambda e, ref: e == 0, "identical", work, library=library,
            main=main))
        del run, plain, library


def kernels_rmsnorm_train(results):
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    x, scale = randn((1024, 4096), 43) * 3.0, randn((4096,), 44)
    results["rmsnorm"].append(check(
        "rmsnorm", "train R1024 D4096",
        lambda: rmsnorm(x, scale, 1e-6),
        lambda: rmsnorm_reference(x, scale, 1e-6),
        lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
        (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
        library=lambda: F.rms_norm(x, (4096,), scale, 1e-6), main=True))


# the weight-only layers of the flan-t5-xxl decoder: (K, N) of q/k/v/o and
# cross q/o, wi_0/wi_1, wo, and the untied lm_head (32128 = 128 * 251)
T5_GEMV_SHAPES = ((4096, 4096, "q, k, v, o"), (4096, 10240, "wi_0, wi_1"),
                  (10240, 4096, "wo"), (4096, 32128, "lm_head"))
# the weight-only layers of the Qwen2-VL-2B LM that the dense-int8 slice's
# decode step runs at R8 (fused projections): qkv, o, gate_up, and the down
# projection, whose plan splits K (two ranges of 32-column units)
DENSE_GEMV_SHAPES = ((1536, 2048, "2B qkv"), (1536, 1536, "2B o"),
                     (1536, 17920, "2B gate_up"), (8960, 1536, "2B down"))


def int8_weight(kk, n, seed):
    """A seeded int8 weight in QDense's layout (the transpose view of an
    (N, K) row-major copy) and its per-column scale."""
    from thinkdiff_torch.ops.quant import quantize_weight

    qw = quantize_weight(randn((kk, n), seed, torch.float32) * 0.05)
    return qw["q"].t().contiguous().t(), qw["scale"]


def gemv_case(r, kk, n, seed=61):
    """Seeded operands of a GEMV call at r rows (bf16 x and y, the weight in
    QDense's layout): (kernel, plain version, one PyTorch call (bf16 copy
    of the weight, ``matmul``, the scale), (bytes, operations, "bf16"))."""
    from thinkdiff_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference)

    w, s = int8_weight(kk, n, seed - 1)
    x = randn((r, kk), seed)
    y = torch.empty((r, n), dtype=torch.bfloat16, device="cuda")
    return (lambda: int8_matmul(x, w, s),
            lambda: int8_matmul_reference(x, w, s),
            lambda: torch.matmul(x, w.to(torch.bfloat16)) * s.to(torch.bfloat16),
            (kk * n + nbytes(x, s, y), 2 * r * kk * n, "bf16"))


def gemv_sweep(rows=(1, 8, 16, 17, 32)):
    """The GEMV's unit widths and splits of K at ``T5_GEMV_SHAPES``: device
    ms with a cold L2 (``cold_ms``) of every width and split the plan weighs
    ("width x K ranges"), against ``gemv_plan``'s choice ("*") and the
    bound. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.gemv_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kk, n, proj in T5_GEMV_SHAPES:
        for r in rows:
            run, _, _, work = gemv_case(r, kk, n)
            chosen = im.gemv_plan(r, kk, n, sms)
            line = []
            for block_n in im.GEMV_BLOCKS:
                steps = -(-kk // (im.GEMV_STAGE_BYTES // block_n))
                tiles = -(-n // block_n)
                stages = max(st for st in range(2, im.GEMV_MAX_STAGES + 1)
                             if im.gemv_smem(r, False, st, block_n)
                             <= im.SMEM_LIMIT)
                for splits in (1, 2, 3, 4, 6, 8):
                    per = -(-steps // splits)
                    if -(-steps // per) != splits:
                        continue
                    units = tiles * splits
                    plan = (block_n, per, stages, min(units, sms))
                    with mock.patch.object(im, "gemv_plan",
                                           lambda *a, c=plan: c):
                        ms = cold_ms(run, "int8_gemv")
                    line.append(f"{block_n}x{splits}"
                                f"{'*' if plan == chosen else ''} {ms:.4f}")
            say("sweep", f"gemv {proj} R{r}: bound {bound_ms(*work)[0]:.4f} "
                "ms; cold ms " + ", ".join(line))
            del run
        torch.cuda.empty_cache()


def gemv_split_stress(root=".", calls=50):
    """The GEMV's split plans where CTAs share SMs: lm_head at two CTAs an
    SM with 2-4 K ranges, and the q/k/v/o and 2B down shapes at more CTAs
    than SMs, rings of 2 and 3 stages, R8 and R16; each plan ``calls``
    times alone, then ``calls`` times on each of two streams at once
    (their kernels co-resident). Counts the calls outside 1 bf16 ulp of
    the plain version and those whose bits differ from the plan's first
    call, through the package of the checkout at ``root`` (as
    ``kernel_ab``). Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.gemv_split_stress()"``."""
    sys.path.insert(0, str(Path(root).resolve()))
    from unittest import mock

    import thinkdiff_torch
    from thinkdiff_torch.ops import int8_matmul as im

    where = Path(thinkdiff_torch.__file__).resolve().parent.parent
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [(4096, 32128, (128, per, st, 2 * sms))
             for per in (16, 11, 8) for st in (2, 3)]
    plans += [(kk, n, (bn, per, st, ctas)) for st in (2, 3)
              for kk, n, bn, per, ctas in (
                  (4096, 4096, 32, 3, 300), (4096, 4096, 64, 4, 256),
                  (4096, 4096, 128, 2, 256), (8960, 1536, 32, 9, 96),
                  (8960, 1536, 32, 3, 2 * sms))]
    bad_total = 0
    for r in (8, 16):
        for kk, n, plan in plans:
            w, s = int8_weight(kk, n, 71)
            x = randn((r, kk), 72)
            ref = im.int8_matmul_reference(x, w, s).float()
            tol = bf16_ulp(ref) + 1e-5 * ref.abs().max()
            with mock.patch.object(im, "gemv_plan", lambda *a, c=plan: c):
                first = im.int8_matmul(x, w, s)
                outs = [im.int8_matmul(x, w, s) for _ in range(calls)]
                streams = [torch.cuda.Stream() for _ in range(2)]
                for st in streams:
                    st.wait_stream(torch.cuda.current_stream())
                for _ in range(calls):
                    for st in streams:
                        with torch.cuda.stream(st):
                            outs.append(im.int8_matmul(x, w, s))
                torch.cuda.synchronize()
            bad = sum(not bool(((o.float() - ref).abs() <= tol).all())
                      for o in [first] + outs)
            other = sum(not torch.equal(o, first) for o in outs)
            bad_total += bad
            say("stress", f"{where.name} int8_matmul R{r} K{kk} N{n} plan "
                f"{plan}: {bad} of {len(outs) + 1} calls outside 1 bf16 ulp, "
                f"{other} with other bits than the first")
            del w, s, x, outs
    say("stress", f"{where.name} int8_matmul split plans: {bad_total} calls "
        "outside 1 bf16 ulp in all")
    torch.cuda.empty_cache()
    return bad_total


def paged_sweep():
    """The paged decode's unit sizes at ``paged_shapes``: device ms with a
    cold L2 of every whole number of pages a unit, against ``paged_plan``'s
    choice ("*") and the bound. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.paged_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import paged_attention as pa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, slots, h, hkv, lengths in paged_shapes():
        q, k, v, table, lens, work = paged_case(slots, h, hkv, lengths)
        mp = table.shape[1]
        chosen = pa.paged_plan(slots, hkv, mp, 64, sms)
        run = lambda: pa.paged_attention(q, k, v, table, lens)
        line = []
        for ppu in sorted({1, 2, 3, 4, 5, 6, 8, 10, 16, mp}
                          & set(range(1, mp + 1))):
            with mock.patch.object(pa, "paged_plan", lambda *a, c=ppu: c):
                ms = cold_ms(run, "paged_decode")
            line.append(f"{ppu}{'*' if ppu == chosen else ''} {ms:.4f}")
        say("sweep", f"paged {label}: bound {bound_ms(*work)[0]:.4f} ms; "
            "pages a unit: cold ms " + ", ".join(line))
        del q, k, v
    torch.cuda.empty_cache()


def kernels_int8_gemv(results):
    from unittest import mock

    from thinkdiff_torch.ops import int8_matmul as im

    # a greedy T5 step at R = t decoder rows (1..32); bf16 in and out. The
    # products are exact, so kernel and plain differ by f32 summation order
    # and one bf16 rounding each: 1 bf16 ulp, plus 1e-5 of the largest
    # output where an output near zero has a smaller ulp than that order
    ok = lambda e, ref: e <= bf16_ulp(ref) + 1e-5 * ref.abs().max()
    tol = "1 bf16 ulp (+1e-5 max|ref| near 0)"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kk, n, proj in T5_GEMV_SHAPES:
        for r in (1, 8, 16, 17, 32):
            run, plain, library, work = gemv_case(r, kk, n)
            results.append(check(
                "int8_matmul", f"{proj} R{r} K{kk} N{n}", run, plain, ok, tol,
                work, library=library, main=proj == "wi_0, wi_1" and r == 8,
                cold="int8_gemv"))
            if r == 8 and proj in ("q, k, v, o", "lm_head"):
                expect_one_launch("kernels", f"int8_matmul {proj} R8 (plan "
                                  f"{im.gemv_plan(8, kk, n, sms)})", run,
                                  "int8_gemv_kernel")
            del run, plain, library
    for kk, n, proj in DENSE_GEMV_SHAPES:
        run, plain, library, work = gemv_case(8, kk, n)
        results.append(check(
            "int8_matmul", f"{proj} R8 K{kk} N{n}", run, plain, ok, tol, work,
            library=library, cold="int8_gemv"))
        plan = im.gemv_plan(8, kk, n, sms)
        if plan[1] < -(-kk // (im.GEMV_STAGE_BYTES // plan[0])):
            expect_one_launch("kernels", f"int8_matmul {proj} R8 (plan {plan}, "
                              "split K)", run, "int8_gemv_kernel")
        del run, plain, library
    for kk, n, proj in T5_GEMV_SHAPES + DENSE_GEMV_SHAPES:
        if proj not in ("q, k, v, o", "wi_0, wi_1", "lm_head", "2B down"):
            continue
        # every plan the shape can get over R 1..32, at the R it is chosen;
        # at lm_head, a split at two CTAs an SM (a 3-stage ring of 128
        # columns fits twice), the co-residence the planner never picks
        plans = {}
        if proj == "lm_head":
            plans[(128, 16, 3, 2 * sms)] = 8
        else:
            for r in range(1, im.GEMV_ROWS + 1):
                plans.setdefault(im.gemv_plan(r, kk, n, sms), r)
        for plan, r in plans.items():
            run, plain, _, _ = gemv_case(r, kk, n, seed=63)
            ref = plain()
            chosen = plan == im.gemv_plan(r, kk, n, sms)
            reps = 1 if chosen else 20  # a race shows now and then
            with mock.patch.object(im, "gemv_plan", lambda *a, c=plan: c):
                outs = [run() for _ in range(reps)]
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs()
            if not bool(ok(err, ref.float()).all()) or not all(
                    torch.equal(o, outs[0]) for o in outs):
                raise AssertionError(f"int8_matmul {proj} R{r} plan {plan}: "
                                     f"max |err| {float(err.max())}, or "
                                     f"{reps} calls' bits differ")
            say("kernels", f"int8_matmul {proj} plan ({plan[0]} columns, "
                f"{plan[1]} stages a unit, ring {plan[2]}, {plan[3]} CTAs), "
                + (f"chosen at R{r}" if chosen else f"R{r}, {reps} calls")
                + f": max|err| {float(err.max()):.3g} within {tol}")
            del run, plain, outs
    torch.cuda.empty_cache()


# the wide weight-only GEMM's shapes: (label, rows, K, N, input gradient,
# dtype). The flan-t5-xxl FFN at bench.py's 1024 training rows, forward
# and input gradient; lvlm-text's cross-attention kv_fused over the 411
# conditioning rows, the forward a weight-only QDense above 32 rows could
# route to #10 (today a bf16 copy of the weight and torch.matmul)
WIDE_TABLE = (("wi R1024 K4096 N10240", 1024, 4096, 10240, False),
              ("wo R1024 K10240 N4096", 1024, 10240, 4096, False),
              ("wi dx R1024 K4096 N10240", 1024, 4096, 10240, True),
              ("wo dx R1024 K10240 N4096", 1024, 10240, 4096, True),
              ("kv_fused R411 K4096 N8192", 411, 4096, 8192, False))


def wide_case(r, kk, n, bwd, dtype=torch.bfloat16, seed=62):
    """Seeded operands of a wide weight-only call (the weight in QDense's
    layout): (kernel, plain version, one PyTorch call of the same function
    (the port's current route above 32 rows for the forward: a bf16 copy
    of the weight, torch.matmul, the scale), (bytes, operations, "bf16"))."""
    from thinkdiff_torch.ops import int8_matmul as im

    w, s = int8_weight(kk, n, seed)
    if bwd:
        g = randn((r, n), seed + 2, dtype)
        return (lambda: im.int8_matmul_wide_bwd(g, w, s, dtype),
                lambda: im.int8_matmul_wide_bwd_reference(g, w, s, dtype),
                lambda: torch.matmul((g.float() * s).to(torch.bfloat16),
                                     w.to(torch.bfloat16).t()).to(dtype),
                (kk * n + nbytes(g, s) + r * kk * g.element_size(),
                 2 * r * kk * n, "bf16"))
    x = randn((r, kk), seed + 1, dtype)
    return (lambda: im.int8_matmul_wide_fwd(x, w, s),
            lambda: im.int8_matmul_wide_fwd_reference(x, w, s),
            lambda: (torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
                     * s.to(torch.bfloat16)).to(dtype),
            (kk * n + nbytes(x, s) + r * n * x.element_size(),
             2 * r * kk * n, "bf16"))


def kernels_int8_wide(results):
    # the plain versions round x and g * scale to bf16 as the kernels do.
    # Tolerance 2e-2 of max|ref|, the JAX test's. Beside the table: f32 in
    # and out, and a ragged row count
    tol = "2e-2 max|ref| (the JAX test's)"
    cases = [(label, r, kk, n, bwd, torch.bfloat16)
             for label, r, kk, n, bwd in WIDE_TABLE]
    cases += [("f32 R256 K4096 N4096", 256, 4096, 4096, False, torch.float32),
              ("f32 dx R256 K4096 N4096", 256, 4096, 4096, True, torch.float32),
              ("R33 K4096 N10240", 33, 4096, 10240, False, torch.bfloat16),
              ("dx R33 K4096 N10240", 33, 4096, 10240, True, torch.bfloat16)]
    for label, r, kk, n, bwd, dtype in cases:
        run, plain, library, work = wide_case(r, kk, n, bwd, dtype)
        name = "int8_matmul_wide_bwd" if bwd else "int8_matmul_wide_fwd"
        results[name].append(check(
            name, label, run, plain,
            lambda e, ref: e <= 2e-2 * ref.abs().max(), tol, work,
            library=library, main=label.startswith("wi ")
            or label.startswith("wi dx")))
        del run, plain, library
    torch.cuda.empty_cache()


def wide_sweep():
    """The wide kernel's plans at ``WIDE_TABLE``'s shapes: device ms
    (torch.profiler) of both tile widths at every ring depth that fits,
    each output checked identical to the plan's own, beside the bound and
    the one-call library route. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.wide_sweep()"``."""
    from unittest import mock

    from thinkdiff_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, r, kk, n, bwd in WIDE_TABLE:
        run, _, library, work = wide_case(r, kk, n, bwd)
        want = run()
        c, o = (n, kk) if bwd else (kk, n)
        chosen = im.wide_plan(r, c, o, sms, False, bwd)
        say("sweep", f"wide {label}: plan {chosen}, bound "
            f"{bound_ms(*work)[0]:.4f} ms, library device "
            f"{device_ms(library):.4f} ms")
        for bn in (128, 256):
            for stages in range(2, im.WIDE_MAX_STAGES + 1):
                if im.wide_smem(bn, stages, bwd) > im.SMEM_LIMIT:
                    continue
                cfg = (bn, stages)
                with mock.patch.object(im, "wide_plan", lambda *a, c=cfg: c):
                    same = torch.equal(run(), want)
                    dev = device_ms(run)
                say("sweep", f"wide {label} block_n {bn} stages {stages}"
                    f"{' (plan)' if cfg == chosen else ''}: device "
                    f"{dev:.4f} ms, {'identical' if same else 'DIFFERS'}")
        del run, library
        torch.cuda.empty_cache()


def kernels_s8_qx(results):
    from thinkdiff_torch.ops import int8_matmul as im
    from thinkdiff_torch.ops.quant import _absmax_quant_rows

    # x quantized per row in the kernel at bench.py's 1024 rows and
    # d_model 4096: the o/q projection (N 4096) and wi_fused (N 20480);
    # identical to the pre-pass chain. Library: the same chain in PyTorch
    # (absmax pre-pass, torch._int_mm, the scales)
    for n, proj in ((4096, "o, q"), (20480, "wi_fused")):
        w, s = int8_weight(4096, n, 65)
        w_rm = w.contiguous()
        x = randn((1024, 4096), 66) * 3.0
        y = torch.empty((1024, n), dtype=torch.bfloat16, device="cuda")

        def library(x=x, w_rm=w_rm, s=s):
            xq, sx = _absmax_quant_rows(x)
            return (torch._int_mm(xq, w_rm).float() * sx[:, None]
                    * s[None]).to(torch.bfloat16)

        row = check(
            "s8_matmul_qx", f"{proj} R1024 K4096 N{n}",
            lambda x=x, w=w, s=s: im.s8_matmul_qx(x, w, s),
            lambda x=x, w=w, s=s: im.s8_matmul_qx_reference(x, w, s),
            lambda e, ref: e == 0, "identical",
            (4096 * n + nbytes(x, s, y), 2 * 1024 * 4096 * n, "int8"),
            library=library, main=proj == "wi_fused")
        expect_one_launch("kernels", f"s8_matmul_qx {proj}",
                          lambda x=x, w=w, s=s: im.s8_matmul_qx(x, w, s),
                          "s8_gemm_qx_kernel")
        row["prepass_s8_ms"] = time_ms(lambda x=x, w=w, s=s: im.s8_matmul(
            *_absmax_quant_rows(x), w, s))
        say("kernels", f"s8_matmul_qx {proj}: the port's pre-pass + s8_matmul "
            f"(#2) {row['prepass_s8_ms']:.4f} ms")
        results.append(row)
        del w, w_rm


def phase_kernels():
    results = {name: [] for name in TPU_KERNELS}
    kernels_flash(results["flash_attention_fwd"])
    kernels_attention_train(results)
    kernels_s8(results["s8_matmul"])
    kernels_s8_train(results)
    kernels_flash_flux(results["flash_attention_fwd"])
    kernels_flash_clip(results["flash_attention_fwd"])
    kernels_flash_cogvideo(results["flash_attention_fwd"])
    kernels_rmsnorm(results["rmsnorm"])
    kernels_rmsnorm_train(results)
    kernels_rmsnorm_flux(results["rmsnorm"])
    kernels_rmsnorm_clip(results["rmsnorm"])
    kernels_paged(results["paged_attention"])
    kernels_fused_sample(results["fused_lm_sample"])
    kernels_int8_gemv(results["int8_matmul"])
    kernels_int8_wide(results)
    kernels_s8_qx(results["s8_matmul_qx"])
    kernels_cobsat(results["flash_attention_fwd"])
    kernels_lora(results)
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Training slices
# ---------------------------------------------------------------------------

def train_config(overrides):
    """The training YAML's model and run sections, with ``overrides`` on
    the model section (t5_config merged)."""
    import copy

    import yaml

    doc = yaml.safe_load(TRAIN_CONFIG.read_text())
    model = copy.deepcopy(doc["model"])
    for key, val in overrides.items():
        if key == "t5_config":
            model["t5_config"] = {**model.get("t5_config", {}), **val}
        else:
            model[key] = val
    return model, dict(doc["run"])


def check_finite(phase, metrics):
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).float().cpu()
    if not (torch.isfinite(losses).all() and torch.isfinite(norms).all()):
        raise AssertionError(f"{phase}: non-finite loss or gradient norm: "
                             f"{losses.tolist()} {norms.tolist()}")
    return losses, norms


def expect_launches(phase, launches, per_step, steps, kinds):
    want = {k: steps * per_step[k] for k in kinds}
    got = {k: launches[k] for k in kinds}
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != derived {want}")


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


def _grad_step(model, frozen, row, dev):
    """Loss and projector gradients of one step of ``model`` on ``row``
    with its trainable parameters copied to ``dev`` in f32: (loss,
    {leaf: gradient on the CPU}, seconds)."""
    from thinkdiff_torch.core.optim import tree_leaves, tree_map

    params = tree_map(lambda t: t.detach().to(dev, torch.float32,
                                              copy=True).requires_grad_(),
                      model.trainable_params())
    t0 = time.perf_counter()
    loss = model.loss_fn(params, frozen, {k: torch.from_numpy(v).to(dev)
                                          for k, v in row.items()})
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (float(loss.detach()),
            {n: g.float().cpu() for (n, _), g in zip(leaves, grads)},
            time.perf_counter() - t0)


def _two_layer_copy(model_cfg, seed, calibrate=None):
    """The w8a8 model cut to 2 decoder layers at full width (calibrated on
    the card with ``calibrate_w8a8(calibrate)`` when batches are given),
    and the same frozen T5 on the CPU (plain versions)."""
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder
    from thinkdiff_torch.models.bridge import load_params, tree_of
    from thinkdiff_torch.models.t5 import T5ForConditionalGeneration

    cfg = dict(model_cfg)
    cfg["t5_config"] = {**cfg["t5_config"], "num_decoder_layers": 2}
    model = MllamaT5EmbedDecoder(cfg, seed=seed)
    if calibrate is not None:
        model.calibrate_w8a8(calibrate)
    cpu_t5 = T5ForConditionalGeneration(model.t5_cfg, device="cpu")
    load_params(cpu_t5, tree_of(model.frozen["t5"], lambda _, t: t))
    return model, {"t5": cpu_t5}


def _ulp_up_quant_rows(x):
    """``_absmax_quant_rows`` with every scale one f32 ulp larger, and the
    rows quantized by it: the size of the disagreement between two devices
    whose scales round apart (the card multiplies by 1/127 where the CPU
    divides)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1), min=1e-30) / 127.0
    s = torch.nextafter(s, torch.full_like(s, float("inf")))
    q = torch.clamp(torch.round(x32 / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def gradient_draws(seeds=range(5)):
    """The gradient check's loss agreement over several draws: for each
    seed a 2-layer copy (model seed SEED + 5 + seed) and the first row of a
    packed batch drawn from that seed; the card's loss against the CPU's,
    as shipped and with the activation scales one ulp up. Prints one line a
    draw and returns the largest relative difference seen. Run alone:
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.gradient_draws()"``."""
    from unittest import mock

    from thinkdiff_torch.data.synthetic import build_batches_packed

    model_cfg, _ = train_config(BENCH_OVERRIDES)
    worst = 0.0
    for s in seeds:
        model, cpu = _two_layer_copy(model_cfg, SEED + 5 + s)
        (b,), _ = build_batches_packed(np.random.RandomState(s), 1, BENCH_ROWS,
                                       BENCH_CAP, BENCH_CAP, model.vlm_hidden,
                                       model.t5_cfg.vocab_size)
        row = {k: v[:1] for k, v in b.items()}
        lk, gk, _ = _grad_step(model, model.frozen, row, model.device)
        with mock.patch("thinkdiff_torch.ops.quant._absmax_quant_rows",
                        _ulp_up_quant_rows):
            lu, gu, _ = _grad_step(model, model.frozen, row, model.device)
        lp, gp, tp = _grad_step(model, cpu, row, torch.device("cpu"))
        rel, rel_ulp = abs(lk - lp) / abs(lp), abs(lu - lp) / abs(lp)
        worst = max(worst, rel, rel_ulp)
        say("grad-draws", f"seed {s}: loss card {lk:.7f}, card with scales "
            f"one ulp up {lu:.7f}, CPU plain {lp:.7f}: rel {rel:.3e} / "
            f"{rel_ulp:.3e}; cosine min {min(cosine(gk[n], gp[n]) for n in gk):.5f}"
            f" / {min(cosine(gu[n], gp[n]) for n in gu):.5f}; CPU {tp:.1f} s")
        del model, cpu
        torch.cuda.empty_cache()
    say("grad-draws", f"largest relative loss difference {worst:.3e} over "
        f"{len(seeds)} draws x 2")
    return worst


def gradient_check(model_cfg, batch, calibrate=None, phase="train-w8a8"):
    """A 2-layer copy of the w8a8 model at full width (equalized by
    ``calibrate_w8a8(calibrate)`` when batches are given): loss and
    projector gradients of one packed row on the card (the kernels)
    against the same step through the plain versions on the CPU."""
    model, cpu = _two_layer_copy(model_cfg, SEED + 5, calibrate)
    row = {k: v[:1] for k, v in batch.items()}
    lk, gk, _ = _grad_step(model, model.frozen, row, model.device)
    lp, gp, tp = _grad_step(model, cpu, row, torch.device("cpu"))
    del model, cpu
    rel = abs(lk - lp) / abs(lp)
    cos = {n: cosine(gk[n], gp[n]) for n in gk}
    ratio = {n: float(gk[n].double().norm() / gp[n].double().norm())
             for n in gk}
    lo, hi = GRAD_NORM_RATIO
    say(phase, f"gradient check, 2 decoder layers at full width"
        + (", calibrated," if calibrate is not None else ",") + " one "
        f"packed row ({int((row['labels'] >= 0).sum())} label tokens): loss "
        f"card {lk:.6f} vs CPU plain {lp:.6f} (rel {rel:.2e}, limit "
        f"{GRAD_LOSS_TOL:g}); projector gradient cosine "
        + ", ".join(f"{n} {c:.5f}" for n, c in cos.items())
        + f" (limit {GRAD_COS_MIN}); norm ratio card/CPU "
        + ", ".join(f"{n} {r:.5f}" for n, r in ratio.items())
        + f" (band {lo}-{hi}); CPU step {tp:.1f} s")
    if (rel > GRAD_LOSS_TOL or min(cos.values()) < GRAD_COS_MIN
            or not all(lo <= r <= hi for r in ratio.values())):
        raise AssertionError(f"{phase}: gradient check failed")
    return rel, min(cos.values())


def phase_profile_train(trainer, state, batch,
                        label="w8a8 training step (packed 4 x 256)"):
    """One training step under torch.profiler: device-busy share and the
    kernels that take the time."""
    from torch.autograd import DeviceType

    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    say("profile", f"{label}: {wall_ms:.1f} ms "
        "unprofiled; device kernel time "
        + (f"{busy_ms:.1f} ms, busy {busy_ms / wall_ms:.0%}" if by_name
           else "not measured (no device events in the trace)"))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("profile", f"  {us / 1e3:.3f} ms/step  {name[:100]}")


def phase_train_w8a8():
    from thinkdiff_torch import kernels
    from thinkdiff_torch.core.optim import tree_leaves
    from thinkdiff_torch.data.synthetic import build_batches_packed
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.models.aligner_lvlm import (
        MllamaT5EmbedDecoder, step_launches)

    model_cfg, run_cfg = train_config(BENCH_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MllamaT5EmbedDecoder(model_cfg, seed=SEED)
    trainer = Trainer(model, run_cfg)
    state = trainer.init_state()
    torch.cuda.synchronize()
    cfg = model.t5_cfg
    say("train-w8a8", f"flan-t5-xxl decoder {cfg.num_decoder_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads} heads, vocab "
        f"{cfg.vocab_size}, w8a8 fused, projector {model.vlm_hidden} -> "
        f"{cfg.d_model} ({model.cfg['mm_projector_type']}); model + trainer "
        f"on {trainer.device} in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    host = build_batches_packed(np.random.RandomState(SEED), BENCH_BATCHES,
                                BENCH_ROWS, BENCH_CAP, BENCH_CAP,
                                model.vlm_hidden, cfg.vocab_size)
    host, n_samples = host
    batches = [trainer.prepare_batch(b) for b in host]
    tokens = sum(int((b["labels"] >= 0).sum()) for b in host)
    before = {n: p.clone() for n, p in tree_leaves(state["params"])}
    warm = [trainer.train_step(state, b)[1] for b in batches]
    check_finite("train-w8a8 warm pass", warm)
    passes = 2
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_ms, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(passes):
        for b in batches:
            ts = time.perf_counter()
            state, m = trainer.train_step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            metrics.append(m)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    losses, norms = check_finite("train-w8a8", metrics)
    moved = {n: float((p - before[n]).abs().max())
             for n, p in tree_leaves(state["params"])}
    if min(moved.values()) == 0:
        raise AssertionError(f"train-w8a8: projector not updated: {moved}")
    per_step = step_launches(cfg, BENCH_CAP, int(model.cfg["chunked_ce"]))
    expect_launches("train-w8a8", launches, per_step, passes * len(batches),
                    TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rates = {"step_ms": statistics.median(step_ms),
             "samples_per_s": passes * n_samples / wall,
             "tokens_per_s": passes * tokens / wall, "peak_gib": peak}
    say("train-w8a8", f"{BENCH_BATCHES} packed batches ({BENCH_ROWS} x "
        f"{BENCH_CAP}/{BENCH_CAP}, {n_samples} samples, {tokens} label tokens "
        f"a pass), 1 warm + {passes} timed passes: step {rates['step_ms']:.1f} "
        f"ms median ({min(step_ms):.1f}-{max(step_ms):.1f}), "
        f"{rates['samples_per_s']:.2f} samples/s per GPU, "
        f"{rates['tokens_per_s']:.0f} label tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, grad norm {norms.min():.4g}-{norms.max():.4g}; "
        f"lr {metrics[-1]['lr']:.3g}; peak {peak:.2f} GiB")
    say("train-w8a8", f"launches over {passes * len(batches)} steps {dict((k, launches[k]) for k in TRAIN_KERNELS)}"
        f" = steps x derived per step {per_step} (block 0's self-attention "
        "and cross-attention query projection carry no gradient: 2n-1 "
        "backward attentions, 7n-3 s8 input gradients + one per CE chunk; "
        "every CE chunk's lm_head runs twice, forward and recompute)")
    rates["grad_rel"], rates["grad_cos"] = gradient_check(model_cfg, host[0])

    # overfit: 10 steps on one batch at a constant lr of 1e-3
    fit = Trainer(model, {"init_lr": 1e-3, "min_lr": 1e-3, "warmup_steps": 0,
                          "weight_decay": 0.05})
    fstate = fit.init_state()
    fl = [fit.train_step(fstate, batches[0])[1] for _ in range(10)]
    fl, _ = check_finite("overfit", fl)
    if not fl[-1] < fl[0]:
        raise AssertionError(f"overfit: loss did not fall: {fl.tolist()}")
    say("train-w8a8", "overfit, one batch, lr 1e-3, 10 steps: loss "
        + " ".join(f"{x:.4f}" for x in fl.tolist()))
    phase_profile_train(trainer, state, batches[0])
    return launches, rates


def phase_train_yaml():
    from thinkdiff_torch import kernels
    from thinkdiff_torch.data.synthetic import build_batches
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.models.aligner_lvlm import (
        MllamaT5EmbedDecoder, step_launches)

    model_cfg, run_cfg = train_config({})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MllamaT5EmbedDecoder(model_cfg, seed=SEED)
    trainer = Trainer(model, run_cfg)
    state = trainer.init_state()
    torch.cuda.synchronize()
    cfg = model.t5_cfg
    bs = 32
    host = build_batches(np.random.RandomState(SEED), 4, bs, model.vlm_hidden,
                         cfg.vocab_size)
    batches = [trainer.prepare_batch(b) for b in host]
    say("train-yaml", f"YAML as written: dtype {model.dtype}, quantization "
        f"{cfg.quant_int8 or 'none'}, fused {cfg.fused_proj}, chunked_ce "
        f"{model.cfg.get('chunked_ce', 32)}; built in "
        f"{time.perf_counter() - t0:.1f} s; 4 padded batches of {bs}, shapes "
        + ", ".join(f"S{b['embeds'].shape[1]}/T{b['labels'].shape[1]}"
                    for b in host))
    trainer.train_step(state, batches[0])  # first call: Triton builds
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(state, b)[1] for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    losses, _ = check_finite("train-yaml", metrics)
    expect_launches("train-yaml", launches, step_launches(cfg, 0, 32),
                    len(batches), ("flash_attention_fwd", "rmsnorm",
                                   "flash_attention_dq",
                                   "flash_attention_dkv"))
    if launches["s8_matmul"] or launches["s8_matmul_bwd"]:
        raise AssertionError("train-yaml: a bf16 model launched s8 kernels")
    say("train-yaml", f"4 steps in {wall:.2f} s ({wall / 4 * 1e3:.0f} ms a "
        f"step, {4 * bs / wall:.1f} samples/s); losses "
        + " ".join(f"{x:.4f}" for x in losses.tolist())
        + f"; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {launches}")
    return wall / 4 * 1e3


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


def phase_ops():
    """The ops no model path runs, through their entry points at the
    flan-t5-xxl training shapes, counts set to 0 just before and read just
    after: int8_matmul_wide forward and backward through autograd (#10,
    #11) and s8_matmul_qx (#12)."""
    from thinkdiff_torch import kernels
    from thinkdiff_torch.ops.int8_matmul import int8_matmul_wide, s8_matmul_qx

    w, s = int8_weight(4096, 10240, 67)
    x = randn((1024, 4096), 68).requires_grad_(True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = int8_matmul_wide(x, w, s)
    (y.float() ** 2).mean().backward()
    q = s8_matmul_qx(x.detach(), w, s)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if not (torch.isfinite(x.grad.float()).all() and torch.isfinite(
            q.float()).all()):
        raise AssertionError("ops: non-finite output or gradient")
    if any(launches[k] != 1 for k in OP_KERNELS):
        raise AssertionError(f"ops: launches {launches}")
    say("ops", "int8_matmul_wide forward + autograd backward and "
        "s8_matmul_qx at R1024 K4096 N10240: launches "
        + ", ".join(f"{k} {launches[k]}" for k in OP_KERNELS))
    return launches


def load_7b_weights(vcfg):
    """Seeded random Qwen2-VL-7B parameters in the LVLM YAML's layout: w8a8
    LM with fused projections, bf16 vision (the YAML quantizes only the
    LM)."""
    from thinkdiff_torch.models.qwen2_vl import (
        Qwen2VLConfig, fuse_qwen2_params, init_params)
    from thinkdiff_torch.ops.quant import quantize_tree

    modes = {"int8": True, "int8_dyn": "w8a8", "w8a8": "w8a8"}
    quant = modes[vcfg["quantization"]]
    vquant = modes.get(str(vcfg.get("vision_quantization", "")), False)
    cfg = Qwen2VLConfig.qwen2_vl_7b(quant_int8=quant, fused_proj=bool(quant),
                                    vision_quant=vquant)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = init_params(cfg, gen, device="cuda")
    params["lm"] = fuse_qwen2_params(quantize_tree(
        params["lm"], min_size=0, w8a8=quant == "w8a8"))
    if vquant:
        params["vision"] = quantize_tree(params["vision"], min_size=0,
                                         w8a8=vquant == "w8a8")
    return cfg, params


def t5_teacher_forcing(model, hid, ids):
    """One T5 pass over a sample's decoder inputs (start id, then its final
    ids but the last) through the kernels, and again with int8_matmul forced
    to its plain version by name: per-position logits cosine and argmax
    agreement, and the argmax against the ids the greedy decode chose."""
    from unittest import mock

    from thinkdiff_torch.ops.int8_matmul import int8_matmul_reference

    t5 = model.frozen["t5"]
    dec = torch.tensor([[0] + ids[:-1]], device="cuda")
    with torch.no_grad():
        proj = model.project(model.trainable, hid[None].to("cuda"))
        got = t5.decode_with_encoder_states(dec, proj)[0].float()
        with mock.patch("thinkdiff_torch.models.qdense.int8_matmul",
                        int8_matmul_reference):
            want = t5.decode_with_encoder_states(dec, proj)[0].float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("lvlm-text: non-finite T5 logits")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    served = float((got.argmax(-1).cpu() == torch.tensor(ids)).float().mean())
    return float(cos.min()), agree, served


def profile_t5_step(model, hid, ids):
    """One greedy T5 step (the decoder at len(ids) + 1 rows, recomputed
    from the start, as every step is) under torch.profiler: wall time,
    device-busy share and the kernels that take the time."""
    from torch.autograd import DeviceType

    t5 = model.frozen["t5"]
    dec = torch.tensor([[0] + ids], device="cuda")
    with torch.no_grad():
        proj = model.project(model.trainable, hid[None].to("cuda"))
        step = lambda: t5.decode_with_encoder_states(dec, proj)[:, -1].argmax(-1)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 4
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    say("profile", f"T5 greedy step at {dec.shape[1]} decoder rows, "
        f"conditioning {hid.shape[0]} rows: {wall_ms:.2f} ms unprofiled; "
        "device kernel time "
        + (f"{busy_ms:.2f} ms, busy {busy_ms / wall_ms:.0%}" if by_name
           else "not measured (no device events in the trace)"))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say("profile", f"  {us / 1e3:.3f} ms/step  {name[:100]}")
    say_total(by_name, "int8_gemv", "the GEMV (#9), every instantiation", 1)


def say_total(by_name, kernel, what, steps):
    """The profile's device time of every kernel named ``kernel``."""
    us = sum(v for k, v in by_name.items() if kernel in k)
    n = sum(1 for k in by_name if kernel in k)
    say("profile", f"  {us / 1e3 / steps:.3f} ms/step  {what} ({n} names)")


# ---------------------------------------------------------------------------
# The jobs from their entry points: stage 1 (precompute) and stage 2 (train)
# ---------------------------------------------------------------------------

CLI_DIR = Path(__file__).resolve().parent / "build" / "cli"
CLI_IMAGES = 256
# the 256 samples hold ~330 MB (a 283-token prompt and ~100 generated rows
# of 1536 bf16 a sample, and the JPEG), under one shard of the reference's
# 5e8 bytes: the phase sets the task's shard size to this, so that the
# writer rolls over and stage 2 reads several tars
CLI_SHARD_BYTES = 2e8
CLI_STAGE1_KERNELS = ("flash_attention_fwd", "s8_matmul", "rmsnorm",
                      "paged_attention")
CLI_STAGE2_KERNELS = ("flash_attention_fwd", "rmsnorm", "flash_attention_dq",
                      "flash_attention_dkv")
CLI_LOSS_TOL = 2.2e-4    # the gradient check's loss limit (PERF.md section 2)
CLI_COSINE = 0.995
CLI_PARTS = 8            # batches in each part of stage 2's step taken apart


def cli_image_index():
    """CLI_IMAGES 448x448 JPEGs (seeded) in wids-indexed image shards:
    (index path, the index's dataset)."""
    from thinkdiff_torch.data.tario import ShardWriter, write_wids_index
    from thinkdiff_torch.data.wids_reader import ShardListDataset

    images, _ = requests(CLI_IMAGES, SEED + 5)
    pattern = str(CLI_DIR / "images" / "%06d.tar")
    with ShardWriter(pattern, maxcount=100) as w:
        for i, im in enumerate(images):
            w.write({"__key__": f"{i:09d}", "jpg": im,
                     "json": {"caption": f"picture {i}"}})
        n = w.shard
    index = str(CLI_DIR / "images" / "index.json")
    write_wids_index([pattern % i for i in range(n)], index, "cli")
    return index, ShardListDataset(index)


def check_embed_shards(tars, width, expect=CLI_IMAGES):
    """Every sample of the stage-1 shards: bf16, finite embeddings whose rows
    equal the token counts, each .pth at most 1.01 x rows x width x 2 bytes
    plus torch.save's header; ``expect`` samples, each key once. Returns
    (samples, the last one read back, the keys)."""
    import io

    from thinkdiff_torch.data.tario import tar_sample_iterator

    one = io.BytesIO()
    torch.save(torch.zeros((1, width), dtype=torch.bfloat16), one)
    header = len(one.getvalue()) - width * 2
    n, last, keys = 0, None, set()
    for tar in tars:
        for raw in tar_sample_iterator(str(tar)):
            js = json.loads(raw["json"])
            sample = {"__key__": raw["__key__"], "json": js}
            for kind, ids in (("input", js["input_prompt_token_ids"]),
                              ("output", js["output_token_ids"])):
                data = raw[f"model.norm.{kind}_embed.pth"]
                e = torch.load(io.BytesIO(data), weights_only=True)
                rows = len(ids)
                if e.dtype != torch.bfloat16 or tuple(e.shape) != (rows, width):
                    raise AssertionError(f"{raw['__key__']} {kind}: {e.dtype} "
                                         f"{tuple(e.shape)}, {rows} tokens")
                if not torch.isfinite(e.float()).all():
                    raise AssertionError(f"{raw['__key__']} {kind}: non-finite")
                if len(data) > 1.01 * rows * width * 2 + header:
                    raise AssertionError(
                        f"{raw['__key__']} {kind}: {len(data)} bytes for "
                        f"{rows} x {width} bf16 (header {header})")
                sample[kind] = e
            keys.add(raw["__key__"])
            n, last = n + 1, sample
    if n != expect or len(keys) != n:
        raise AssertionError(f"stage 1: {n} samples, {len(keys)} keys, "
                             f"{expect} expected")
    return n, last, sorted(keys)


def cli_stage1(base_cfg, cfg, params):
    """The precompute bootstrap -> task -> runner_process_data over
    configs/qwen2_vl_embed_ccsbu.yaml as written (256 slots, batch 256),
    the dataset and output path overridden and the task's shard size set
    to CLI_SHARD_BYTES, with the seeded 2B model injected into the runner;
    the paged slice's stop lengths."""
    from thinkdiff_torch import kernels
    from thinkdiff_torch.scripts.common import (
        bootstrap, build_runner, parse_args)
    from thinkdiff_torch.tasks import image_text_process_data

    t0 = time.perf_counter()
    index, images = cli_image_index()
    embed_dir = CLI_DIR / "embed"
    args = parse_args("stage 1", [
        "--cfg-path", str(CONFIG), "--options",
        f"datasets.cc_sbu_mllama_vllm_process_wids.build_info.storage={index}",
        f'run.output_shard_path=["{embed_dir}", "%06d.tar", 0]'])
    run_cfg, task = bootstrap(args)
    model = build_model(base_cfg, cfg, params, {})
    runner = build_runner(run_cfg, task, model, task.build_datasets(run_cfg),
                          None, "runner_process_data")
    lengths = stop_lengths(CLI_IMAGES, SEED + 1)
    model.engine.stop_len_fn = lambda req, m: m >= lengths[req]
    say("cli", f"stage 1: {CLI_IMAGES} images of 448x448 written as JPEGs "
        f"into wids-indexed shards in {time.perf_counter() - t0:.2f} s; "
        f"batch {run_cfg.datasets_cfg['cc_sbu_mllama_vllm_process_wids']['batch_size']}"
        f", {model.max_num_seqs} slots, shard size {CLI_SHARD_BYTES:g} bytes")
    saved = image_text_process_data.SHARD_MAXSIZE
    image_text_process_data.SHARD_MAXSIZE = CLI_SHARD_BYTES
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = runner.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        image_text_process_data.SHARD_MAXSIZE = saved
    engine = model.engine
    engine.stop_len_fn = None
    tars = sorted(embed_dir.glob("*.tar"))
    mb = sum(t.stat().st_size for t in tars) / 1e6
    if stats["num_samples"] != CLI_IMAGES or stats["num_shards"] != len(tars) \
            or len(tars) < 2:
        raise AssertionError(f"cli stage 1: {stats}, tars {tars}")
    missing = [k for k in CLI_STAGE1_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"cli stage 1: kernels not launched: {missing}")
    n, last, keys = check_embed_shards(tars, engine.cfg.hidden_size)
    say("cli", f"stage 1: {n} samples into {len(tars)} shards, "
        f"{mb:.1f} MB, in {wall:.2f} s: {n / wall:.2f} imgs/s (image "
        f"shard reads and JPEG decode, serving and shard writing); every "
        f"embedding bf16, finite, rows = its tokens, each .pth within "
        f"1.01 x rows x width x 2 + header; launches {launches}")
    out = {"prompt_token_ids": [last["json"]["input_prompt_token_ids"]],
           "output_token_ids": [last["json"]["output_token_ids"]],
           "prompt_hidden_states": [last["input"]],
           "hidden_states": [last["output"]]}
    teacher_forcing_check("cli", engine, out,
                          [images[int(last["__key__"])]["jpg"]], 0)
    return {"dir": embed_dir, "tars": len(tars), "mb": mb,
            "imgs_per_s": n / wall, "launches": launches, "index": index,
            "keys": keys, "width": engine.cfg.hidden_size}


def cli_train(argv, record):
    """thinkdiff_torch.train.main(argv) with each train_step's step, lr,
    loss (left on the card) and host start time appended to ``record``,
    the launch counters set to 0 just before and read just after:
    (the runner, the launches)."""
    from thinkdiff_torch import kernels, train
    from thinkdiff_torch.engines.trainer import Trainer

    step = Trainer.train_step

    def recorded(self, state, batch, rng=None):
        t = time.perf_counter()
        state, m = step(self, state, batch, rng)
        record.append({"step": state["step"], "lr": m["lr"],
                       "loss": m["loss"], "t": t})
        return state, m

    Trainer.train_step = recorded
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        runner = train.main(argv)
        torch.cuda.synchronize()
        return runner, kernels.launch_counts()
    finally:
        Trainer.train_step = step


def cli_stage2_parts(runner):
    """Stage 2's step through the runner taken apart, in one process on the
    same shards and state: ms a batch of the epoch's loader alone (shard
    reads, .pth and JPEG decode, collation on its prefetch thread; timed
    after its first two batches, the first of which fills the shuffle
    buffer), of ``prepare_batch`` alone (pinned copies to the card), and of
    ``train_step`` alone on batches already there (synchronized at the end;
    and the host's time inside the calls). Returns them and the batches'
    shapes."""
    loader = iter(runner.train_loader(0))
    try:
        next(loader)
        next(loader)
        t0 = time.perf_counter()
        host = [next(loader) for _ in range(CLI_PARTS)]
        loader_ms = (time.perf_counter() - t0) * 1e3 / CLI_PARTS
    finally:
        loader.close()
    trainer, state = runner.trainer, runner.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = [trainer.prepare_batch(b) for b in host]
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3 / CLI_PARTS
    state, _ = trainer.train_step(state, dev[0], runner.seed)
    torch.cuda.synchronize()
    inside = 0.0
    t0 = time.perf_counter()
    for b in dev:
        t1 = time.perf_counter()
        state, _ = trainer.train_step(state, b, runner.seed)
        inside += time.perf_counter() - t1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / CLI_PARTS
    shapes = sorted({f"S{b['embeds'].shape[1]}/T{b['labels'].shape[1]}"
                     for b in host})
    return {"loader_ms": loader_ms, "prepare_ms": prepare_ms,
            "step_ms": step_ms, "dispatch_ms": inside * 1e3 / CLI_PARTS,
            "shapes": shapes}


def cli_stage2(stage1, yaml_step_ms):
    """thinkdiff_torch.train over configs/train_thinkdiff_lvlm_ccsbu.yaml as
    written, on stage 1's shards (2 epochs of 4 steps), then resumed from
    checkpoint_0.pth: epoch 1 again."""
    import gc

    out_dir = CLI_DIR / "train"
    storage = f"{stage1['dir']}/{{000000..{stage1['tars'] - 1:06d}}}.tar"
    argv = ["--cfg-path", str(TRAIN_CONFIG), "--options",
            "model.mllama_pretrained_model_name_or_path=Qwen/Qwen2-VL-2B-Instruct",
            f"datasets.llava_instruct_mllama_embed_2.build_info.storage={storage}",
            f"run.output_dir={out_dir}", "run.max_epoch=2",
            "run.iters_per_epoch=4"]
    runs = {}
    with standin_tokenizers():
        for name, extra in (("straight", []), ("resumed", [
                f"run.resume_ckpt_path={out_dir / 'straight' / 'checkpoint_0.pth'}"])):
            record = []
            t0 = time.perf_counter()
            runner, launches = cli_train(argv + extra + ["--job-id", name],
                                         record)
            wall = time.perf_counter() - t0
            losses = torch.stack([r["loss"] for r in record]).float().cpu()
            runs[name] = {"record": record, "losses": losses.tolist(),
                          "launches": launches, "wall": wall,
                          "dir": Path(runner.output_dir),
                          "d_vlm": runner.model.vlm_hidden,
                          "d_model": runner.model.t5_cfg.d_model,
                          "dtype": runner.model.dtype, "batch":
                          runner.config.datasets_cfg[
                              "llava_instruct_mllama_embed_2"]["batch_size"]}
            if not torch.isfinite(losses).all():
                raise AssertionError(f"cli stage 2 {name}: losses {losses}")
            if name == "straight":
                parts = cli_stage2_parts(runner)
            del runner
            gc.collect()
            torch.cuda.empty_cache()
    st, rs = runs["straight"], runs["resumed"]
    lines = [json.loads(x) for x in (st["dir"] / "log.txt").read_text().splitlines()]
    if [e["epoch"] for e in lines if "train_loss" in e] != [0, 1]:
        raise AssertionError(f"cli stage 2: log.txt {lines[1:]}")
    for tag in (0, 1):
        if not (st["dir"] / f"checkpoint_{tag}.pth").exists():
            raise AssertionError(f"cli stage 2: no checkpoint_{tag}.pth")
    missing = [k for k in CLI_STAGE2_KERNELS if st["launches"][k] == 0]
    if missing or st["launches"]["s8_matmul"]:
        raise AssertionError(f"cli stage 2: launches {st['launches']}")
    if len(st["record"]) != 8 or len(rs["record"]) != 4:
        raise AssertionError("cli stage 2: steps "
                             f"{len(st['record'])}, {len(rs['record'])}")
    again = st["record"][4:]
    for a, b, la, lb in zip(again, rs["record"], st["losses"][4:],
                            rs["losses"]):
        if a["step"] != b["step"] or a["lr"] != b["lr"] or \
                abs(lb - la) > CLI_LOSS_TOL * abs(la):
            raise AssertionError(f"cli resume: step {b['step']} lr {b['lr']} "
                                 f"loss {lb} against step {a['step']} lr "
                                 f"{a['lr']} loss {la}")
    ca = torch.load(st["dir"] / "checkpoint_1.pth", weights_only=True)["model"]
    cb = torch.load(rs["dir"] / "checkpoint_1.pth", weights_only=True)["model"]
    cos = {k: cosine(ca[k], cb[k]) for k in ca}
    if min(cos.values()) < CLI_COSINE:
        raise AssertionError(f"cli resume: projector cosines {cos}")
    rel = max(abs(lb - la) / abs(la)
              for la, lb in zip(st["losses"][4:], rs["losses"]))
    gaps = [b["t"] - a["t"] for run in (st, rs)
            for a, b in zip(run["record"], run["record"][1:])
            if b["step"] % 4 != 1]     # within an epoch
    step_ms = statistics.median(gaps) * 1e3
    say("cli", f"stage 2: train YAML as written ({st['dtype']}, projector "
        f"{st['d_vlm']} -> {st['d_model']}, batch {st['batch']}) on "
        f"{stage1['tars']} shards, 2 "
        f"epochs x 4 steps in {st['wall']:.1f} s (model build and each "
        f"epoch's shuffle-buffer fill included); {step_ms:.0f} ms a step "
        f"through the runner (median gap between steps within an epoch; "
        f"train-yaml's synthetic batches {yaml_step_ms:.0f}); losses "
        + " ".join(f"{x:.4f}" for x in st["losses"])
        + f"; launches {st['launches']}")
    say("cli", f"stage 2 resumed from checkpoint_0.pth: epoch 1 steps "
        f"{[r['step'] for r in rs['record']]}, lr equal, losses "
        + " ".join(f"{x:.4f}" for x in rs["losses"])
        + f" (max rel err {rel:.3g} <= {CLI_LOSS_TOL}); projector cosine "
        f"min {min(cos.values()):.6f} (>= {CLI_COSINE}) over "
        f"{len(cos)} leaves")
    say("cli", f"stage 2 taken apart over {CLI_PARTS} batches of the "
        f"straight run's loader (shapes {' '.join(parts['shapes'])}): loader "
        f"alone {parts['loader_ms']:.1f} ms a batch, prepare_batch alone "
        f"{parts['prepare_ms']:.1f} ms, train_step alone "
        f"{parts['step_ms']:.1f} ms a step ({parts['dispatch_ms']:.1f} ms of "
        f"host time inside the call); through the runner {step_ms:.0f} ms")
    return {"launches": st["launches"], "step_ms": step_ms,
            "losses": st["losses"], "dir": st["dir"]}


def phase_cli(base_cfg, cfg, params, yaml_step_ms):
    """The cli phase's two stages, then the ddp phase on their images and
    shards."""
    import shutil

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    try:
        stage1 = cli_stage1(base_cfg, cfg, params)
        torch.cuda.empty_cache()
        stage1["native"] = phase_native(stage1["index"])
        stage2 = cli_stage2(stage1, yaml_step_ms)
        torch.cuda.empty_cache()
        ddp = phase_ddp(stage1, stage2)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    return stage1, stage2, ddp


def build_lvlm_model():
    """The LVLM inference YAML's model with LVLM_OVERRIDES (Qwen2-VL-7B w8a8
    from seeded weights, the stand-in tokenizer, the frozen flan-t5-xxl
    decoder weight-only int8) on the card."""
    import copy

    import yaml

    from thinkdiff_torch.engines.embed_engine import EmbedEngine, engine_kwargs
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models.aligner_lvlm import (
        MllamaT5EmbedDecoderWithEngine)

    model_cfg = copy.deepcopy(yaml.safe_load(LVLM_CONFIG.read_text())["model"])
    model_cfg.update(LVLM_OVERRIDES)
    cfg, params = load_7b_weights(model_cfg["vllm_config"])
    tok = StandInTokenizer()
    eos = [tok.eos_token_id, tok.convert_tokens_to_ids("<|im_end|>")]
    engine = EmbedEngine(cfg, params, tok, eos_ids=eos,
                         **engine_kwargs(model_cfg))
    del params
    model = MllamaT5EmbedDecoderWithEngine(model_cfg, seed=SEED,
                                           engine=engine)
    torch.cuda.synchronize()
    return model


def phase_lvlm_text():
    """configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml with the frozen T5
    in weight-only int8: MllamaT5EmbedDecoderWithEngine.generate over
    LVLM_REQUESTS image requests (Qwen2-VL-7B, w8a8, 128 tokens each ->
    hidden states -> projector 3584 -> 4096 -> greedy flan-t5-xxl decode of
    32 steps per sample), then get_text on LVLM_TEXT_ONLY text-only raw
    prompts."""
    from thinkdiff_torch import kernels
    from thinkdiff_torch.models.aligner_lvlm import lvlm_text_launches

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_lvlm_model()
    engine, cfg = model.engine, model.engine.cfg
    vcfg = model.cfg["vllm_config"]
    t5c = model.t5_cfg
    say("lvlm-text", f"Qwen2-VL-7B ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, vocab "
        f"{cfg.vocab_size}, LM {vcfg['quantization']} fused, vision bf16; "
        f"temperature {engine.temperature}, top_p {engine.top_p}, "
        f"max/min tokens {engine.max_tokens}/{engine.min_tokens}, ignore_eos "
        f"{engine.ignore_eos}, prefill_chunk {engine.prefill_chunk}) + "
        f"projector {model.vlm_hidden} -> {t5c.d_model} + flan-t5-xxl "
        f"decoder {t5c.num_decoder_layers} layers, weight-only int8, fused "
        f"{t5c.fused_proj}; built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    results = []
    served = engine.generate
    engine.generate = lambda *a, **kw: results.append(served(*a, **kw)) \
        or results[-1]
    images, prompts = requests(LVLM_REQUESTS, SEED + 5)
    samples = {"images": images, "answers": prompts}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ids, t5_texts, vlm_texts = model.generate(
        samples, embedding_type="both", max_new_tokens=engine.max_tokens,
        t5_max_new_tokens=T5_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    res = results[-1]
    embed_lens = [len(p) + len(o) for p, o in zip(res.prompt_token_ids,
                                                  res.output_token_ids)]
    for i in range(LVLM_REQUESTS):
        hid = torch.cat([res.prompt_hidden_states[i], res.hidden_states[i]])
        if len(res.output_token_ids[i]) != engine.max_tokens:
            raise AssertionError(f"lvlm-text request {i}: "
                                 f"{len(res.output_token_ids[i])} VLM tokens")
        if tuple(hid.shape) != (embed_lens[i], cfg.hidden_size) or not \
                torch.isfinite(hid.float()).all():
            raise AssertionError(f"lvlm-text request {i}: hidden states "
                                 f"{tuple(hid.shape)} or non-finite")
        eos_t5 = int(model.cfg.get("t5_eos_token_id", 1))
        if not (1 <= len(ids[i]) <= T5_STEPS and eos_t5 not in ids[i][:-1]
                and all(0 <= t < t5c.vocab_size for t in ids[i])):
            raise AssertionError(f"lvlm-text request {i}: T5 ids {ids[i]}")
    want = lvlm_text_launches(t5c, embed_lens, T5_STEPS)
    if launches["int8_matmul"] != want:
        raise AssertionError(f"lvlm-text: int8_matmul launches "
                             f"{launches['int8_matmul']} != derived {want}")
    missing = [k for k in ("flash_attention_fwd", "s8_matmul", "rmsnorm")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"lvlm-text: kernels not launched: {missing}")
    ph = model.last_phase_times
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("lvlm-text", f"generate(embedding_type='both') on {LVLM_REQUESTS} "
        f"requests ({len(res.prompt_token_ids[0])} prompt + "
        f"{engine.max_tokens} generated tokens each): {wall:.2f} s; VLM "
        f"{ph['vlm']:.2f} s (engine: " + ", ".join(
            f"{k} {v:.2f}" for k, v in engine.last_phase_times.items())
        + f"), projector {ph['projector']:.3f} s, T5 decode {ph['t5']:.2f} s "
        f"({ph['t5_steps']} steps, {ph['t5'] / ph['t5_steps'] * 1e3:.2f} ms "
        f"a step); T5 lengths " + ",".join(str(len(i)) for i in ids)
        + f"; peak {peak:.2f} GiB")
    say("lvlm-text", f"int8_matmul launches {launches['int8_matmul']} = "
        f"derived {want} ({T5_STEPS} steps x {LVLM_REQUESTS} samples x the "
        "weight-only layers at <= 32 rows); launches " + str(launches))
    hid = torch.cat([res.prompt_hidden_states[0], res.hidden_states[0]])
    cos, agree, served_agree = t5_teacher_forcing(model, hid, ids[0])
    say("lvlm-text", f"teacher-forced T5 pass over request 0's {len(ids[0])} "
        f"ids, kernels vs int8_matmul's plain version: logits cosine min "
        f"{cos:.5f} (limit {T5_TF_COS_MIN}), argmax agreement {agree:.3f}; "
        f"kernel argmax vs the served greedy ids {served_agree:.3f}")
    if not cos >= T5_TF_COS_MIN:
        raise AssertionError("lvlm-text: teacher-forced T5 check failed")
    profile_t5_step(model, hid, ids[0][:15])

    prompts = [f"<|im_start|>user\nwrite a line about topic {i}<|im_end|>\n"
               f"<|im_start|>assistant\n" for i in range(LVLM_TEXT_ONLY)]
    t0 = time.perf_counter()
    texts = model.get_text(prompts, need_process=False,
                           max_new_tokens=engine.max_tokens)
    wall_text = time.perf_counter() - t0
    res = results[-1]
    if len(texts) != LVLM_TEXT_ONLY or any(
            len(o) != engine.max_tokens for o in res.output_token_ids):
        raise AssertionError("lvlm-text: get_text on text-only prompts")
    say("lvlm-text", f"get_text(need_process=False) on {LVLM_TEXT_ONLY} "
        f"text-only prompts ({len(res.prompt_token_ids[0])} prompt tokens): "
        f"{engine.max_tokens} tokens each in {wall_text:.2f} s")
    engine.generate = served
    return launches, {"wall_s": wall, "t5_ms_per_step":
                      ph["t5"] / ph["t5_steps"] * 1e3}, model


# ---------------------------------------------------------------------------
# LVLM inference into FLUX: aligned tokens -> a 1024² image
# ---------------------------------------------------------------------------

FLUX_DIR = Path(__file__).resolve().parent / "build" / "lvlm_flux"
# seeded random weights of FLUX.1-dev, CLIP-L and the FLUX VAE: every
# kernel and embedding N(0, 0.02) (HF's initializer_range), CLIP's position
# embedding N(0, 0.01), biases 0, LayerNorm / GroupNorm scales 1, and
# FLUX's q/k RMSNorm scales U(0.5, 1.5), so that a norm that left its scale
# out would show. A scale that let the trajectory go non-finite would fail
# the finiteness checks below
FLUX_INIT_STD = 0.02
# one transformer forward at full shape through the kernels against the
# same forward with the flash forward and RMSNorm replaced by their plain
# versions (mha_reference in f32, rmsnorm_reference): velocity cosine at
# least this, at both joint lengths. The same forward holds every kernel
# call against its plain version on the call's own inputs
# (FLUX_FLASH_REL * max|ref| for the flash forward, one bf16 ulp for
# RMSNorm). Measured on the card (NVIDIA H100 80GB HBM3, 700 W), get_embed's
# tokens, T4224 / T4507: sound 0.999878 / 0.999874 (the kernel rounds P to
# bf16 before PV, and both round the output to bf16); planted faults
# (flux_velocity_check) a uniform softmax 0.991090 / 0.985104, RMSNorm's
# scale left out 0.998470 / 0.997479, the keys cut to a tile multiple
# (T4507) 0.999857, each caught by the per-call check. The limit sits
# between the sound runs and the first two faults (4x the sound distance
# from 1, a third of the nearer fault's); no cosine can tell the cut tail
# from sound rounding, so that fault rests on the per-call check alone
FLUX_VEL_COS_MIN = 0.9995


class ClipStandInTokenizer:
    """CLIP-L's tokenizer surface for seeded runs without tokenizer files:
    BOS 49406, one id a word (from a hash, in 1..49405), EOS 49407, padded
    to ``max_length`` with EOS, as CLIP pads."""

    BOS, EOS = 49406, 49407

    def __call__(self, texts, padding="max_length", max_length=77,
                 truncation=True, return_tensors="np"):
        import zlib

        rows = []
        for t in texts:
            words = [1 + zlib.crc32(w.encode()) % (self.BOS - 1)
                     for w in t.split()]
            ids = ([self.BOS] + words)[:max_length - 1] + [self.EOS]
            rows.append(ids + [self.EOS] * (max_length - len(ids)))
        return {"input_ids": np.asarray(rows, np.int64)}

    def encode(self, text):
        """One text's ids, unpadded (the CoBSAT scorer pads with EOS)."""
        return [int(i) for i in self([text], max_length=77)["input_ids"][0]
                if i != self.EOS] + [self.EOS]


@torch.no_grad()
def init_random_(module, gen, std=FLUX_INIT_STD):
    """Seeded random weights in place on the module's device (see
    FLUX_INIT_STD)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("q_scale", "k_scale"):
            p.copy_(0.5 + torch.rand(p.shape, generator=gen, device=p.device))
        else:
            s = std / 2 if leaf == "position_embedding" else std
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * s)


def lvlm_flux_embeds(model):
    """lvlm-text's model (Qwen2-VL-7B engine + projector) on one 448x448
    request through get_embed, as the LVLM FLUX CLI calls it: with
    "both" (prompt + generated; the velocity check's second joint length),
    then with the YAML's embedding_type output_embed (its 128 generated
    tokens), the start of the lvlm-flux path: the launch counts are set to
    0 before it, and its launches must equal get_embed_launches. Returns
    ({embedding_type: (S, 4096)}, get_embed's launches)."""
    import yaml

    from thinkdiff_torch import kernels
    from thinkdiff_torch.models.aligner_lvlm import get_embed_launches

    run = yaml.safe_load(LVLM_CONFIG.read_text())["run"]
    images, prompts = requests(1, SEED + 9)
    samples = {"images": images, "answers": prompts}
    out = {}
    for etype in ("both", run["embedding_type"]):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        conds, res = model.get_embed(samples, embedding_type=etype,
                                     max_new_tokens=int(run["max_new_tokens"]))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        c = conds[0]
        if not (c.ndim == 2 and c.shape[1] == model.t5_cfg.d_model
                and torch.isfinite(c.float()).all()):
            raise AssertionError(f"lvlm-flux: get_embed({etype}) gave "
                                 f"{tuple(c.shape)} or non-finite")
        say("lvlm-flux", f"get_embed(embedding_type={etype!r}): "
            f"{tuple(c.shape)} {c.dtype} in {time.perf_counter() - t0:.2f} s "
            f"({len(res.prompt_token_ids[0])} prompt + "
            f"{len(res.output_token_ids[0])} generated tokens)")
        out[etype] = c
    want = get_embed_launches(model, [len(res.prompt_token_ids[0])],
                              int(run["max_new_tokens"]))
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"lvlm-flux: get_embed launches {launches} != "
                             f"derived {want}")
    say("lvlm-flux", f"get_embed({run['embedding_type']!r}) launches = "
        f"get_embed_launches {want}")
    return out, launches


def flux_forward(pipe, embeds, latents, pooled, sigma, attention, norm):
    """One transformer forward at full shape on ``embeds`` (S_txt rows)
    with ``attention`` and ``norm`` in place of the flash forward and
    RMSNorm at their call sites in models/flux.py. Returns the f32
    velocity."""
    from unittest import mock

    from thinkdiff_torch.models import flux as flux_mod

    cfg, model = pipe.sampler.cfg, pipe.sampler.transformer
    dev, side = pipe.sampler.device, math.isqrt(latents.shape[1]) * 2
    img_ids = torch.from_numpy(flux_mod.make_img_ids(side, side)).to(dev)
    args = (latents.to(cfg.dtype), embeds[None], pooled,
            torch.full((1,), sigma, device=dev), img_ids,
            torch.zeros((embeds.shape[0], 3), device=dev),
            torch.full((1,), 3.5, device=dev))
    with torch.no_grad(), \
            mock.patch.object(flux_mod, "flash_attention", attention), \
            mock.patch.object(flux_mod, "rmsnorm", norm):
        out = model(*args).float()
    if not torch.isfinite(out).all():
        raise AssertionError("flux forward: non-finite velocity")
    return out


def flux_velocity_check(pipe, embeds, latents, pooled, sigma,
                        phase="lvlm-flux"):
    """The FLUX forward of ``embeds`` through the kernels against its plain
    version (mha_reference, rmsnorm_reference): the velocity cosine, and
    each kernel call held against its plain version on the call's own
    inputs (the flash forward at FLUX_FLASH_REL * max|ref|, RMSNorm at one
    bf16 ulp: ``worst`` is each kernel's largest error over its limit, at
    most 1). Then the same with a fault planted in place of a kernel: a
    uniform softmax (the mean of v), the keys cut to a multiple of 128
    (where T is none), and RMSNorm with its scale left out. Every fault
    must fail the per-call check. Returns {run: {"cos": ..., "worst":
    {kernel: ...}}}."""
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)
    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    t = embeds.shape[0] + latents.shape[1]
    cut = t - t % 128
    want = flux_forward(pipe, embeds, latents, pooled, sigma, mha_reference,
                        rmsnorm_reference)
    faults = {
        "sound": (flash_attention, rmsnorm),
        "uniform softmax": (lambda q, k, v, *a: v.mean(
            dim=2, keepdim=True).expand(q.shape), rmsnorm),
        "RMSNorm scale left out": (flash_attention,
                                   lambda x, s, eps=1e-6: rmsnorm(
                                       x, torch.ones_like(s), eps)),
    }
    if cut != t:
        faults["keys cut to a tile multiple"] = (
            lambda q, k, v, *a: flash_attention(
                q, k[:, :, :cut], v[:, :, :cut], *a), rmsnorm)
    out = {}
    for run, (attention, norm) in faults.items():
        worst = {"flash": 0.0, "rmsnorm": 0.0}

        def attention_checked(q, k, v, *a, attention=attention):
            o = attention(q, k, v, *a)
            ref = mha_reference(q, k, v, *a).float()
            worst["flash"] = max(worst["flash"], float(
                (o.float() - ref).abs().max()) / flux_flash_limit(ref))
            return o

        def norm_checked(x, s, eps=1e-6, norm=norm):
            o = norm(x, s, eps)
            ref = rmsnorm_reference(x, s, eps)
            worst["rmsnorm"] = max(worst["rmsnorm"], float(
                ((o.float() - ref.float()).abs() / bf16_ulp(ref)).max()))
            return o

        got = flux_forward(pipe, embeds, latents, pooled, sigma,
                           attention_checked, norm_checked)
        out[run] = {"cos": cosine(got, want), "worst": worst}
        say(phase, f"velocity at joint length {t}, {run}: cosine "
            f"{out[run]['cos']:.6f} against the plain forward (limit "
            f"{FLUX_VEL_COS_MIN}); worst call of the flash forward "
            f"{worst['flash']:.3g}, of RMSNorm {worst['rmsnorm']:.3g} of "
            "its limit")
        caught = max(worst.values()) > 1.0
        if run == "sound" and (caught
                               or not out[run]["cos"] >= FLUX_VEL_COS_MIN):
            raise AssertionError(f"{phase}: velocity check failed {out}")
        if run != "sound" and not caught:
            raise AssertionError(f"{phase}: the planted fault {run!r} "
                                 f"passes the per-call check {out[run]}")
    return out


def profile_denoise_step(pipe, embeds, latents, pooled):
    """One Euler step of the transformer at full shape (the step's forward
    and its f32 update) under torch.profiler: wall time, device-busy share
    and the kernels that take the time."""
    from torch.autograd import DeviceType

    from thinkdiff_torch.models.flux import make_img_ids

    s = pipe.sampler
    img_ids = torch.from_numpy(make_img_ids(128, 128))
    txt_ids = torch.zeros((embeds.shape[0], 3))
    step = lambda: s.denoise(latents, embeds[None], pooled, img_ids, txt_ids,
                             [1.0, 0.96], 3.5)
    from torch.utils.flop_counter import FlopCounterMode

    # the step's matmul operations as PyTorch dispatches them (the
    # projections; the flash kernel is a library call it does not see)
    with FlopCounterMode(display=False) as fc:
        step()
    torch.cuda.synchronize()
    proj_flops = fc.get_total_flops()
    t0 = time.perf_counter()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    say("profile", f"FLUX denoise step, joint length "
        f"{embeds.shape[0] + 4096}: {wall_ms:.1f} ms unprofiled; device "
        "kernel time "
        + (f"{busy_ms:.1f} ms, busy {busy_ms / wall_ms:.0%}" if by_name
           else "not measured (no device events in the trace)"))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("profile", f"  {us / 1e3:.3f} ms/step  {name[:100]}")
    say_total(by_name, "flash_fwd", "the flash forward (#1)", 1)
    say_total(by_name, "rmsnorm", "RMSNorm (#3)", 1)
    say_total(by_name, "nvjet", "cuBLAS (the projections)", 1)
    say_total(by_name, "elementwise", "PyTorch's elementwise kernels", 1)
    say_total(by_name, "copy", "PyTorch's copies", 1)
    cfg = s.cfg
    t = embeds.shape[0] + 4096
    attn_flops = ((cfg.num_double_layers + cfg.num_single_layers)
                  * 4 * cfg.num_heads * t * t * cfg.head_dim)
    say("profile", f"  the step's work: projections {proj_flops / 1e12:.2f} "
        f"TFLOP (torch.utils.flop_counter), {bound_ms(0, proj_flops, 'bf16')[0]:.1f} "
        f"ms at the bf16 peak; joint attention {attn_flops / 1e12:.2f} TFLOP, "
        f"{bound_ms(0, attn_flops, 'bf16')[0]:.1f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "proj_tflop": proj_flops / 1e12}


def build_flux_pipe(phase):
    """FLUX.1-dev (19 + 38 blocks, hidden 3072, bf16), CLIP-L and the FLUX
    VAE on the card from seeded random weights, in a ThinkDiffPipeline with
    the CLIP stand-in tokenizer."""
    from thinkdiff_torch.engines.flux_sampler import FluxSampler
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline
    from thinkdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from thinkdiff_torch.models.flux import FluxConfig, FluxTransformer
    from thinkdiff_torch.models.flux_vae import VAEConfig, VAEDecoder

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    cfg = FluxConfig.flux_dev()
    transformer = FluxTransformer(cfg, device="cuda")
    init_random_(transformer, gen)
    clip_cfg = CLIPTextConfig.clip_l(dtype=torch.bfloat16)
    clip = CLIPTextEncoder(clip_cfg, device="cuda")
    init_random_(clip, gen)
    vae_cfg = VAEConfig.flux()
    vae = VAEDecoder(vae_cfg, device="cuda")
    init_random_(vae, gen)
    pipe = ThinkDiffPipeline(FluxSampler(cfg, transformer, vae_cfg, vae),
                             clip, ClipStandInTokenizer())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in transformer.parameters())
    say(phase, f"FLUX.1-dev ({cfg.num_double_layers} + "
        f"{cfg.num_single_layers} blocks, hidden {cfg.hidden_size}, "
        f"{n_params / 1e9:.2f} B params, bf16), CLIP-L ({clip_cfg.num_layers} "
        f"layers, bf16) and the FLUX VAE (bf16) from seeded random weights "
        f"(std {FLUX_INIT_STD}) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return pipe


def phase_lvlm_flux(embeds, embed_launches=None):
    """LVLM inference into FLUX with the LVLM YAML's run section as written
    (1024², 28 steps, guidance 3.5, seed 42): FLUX.1-dev (19 + 38 blocks,
    hidden 3072, bf16), CLIP-L and the FLUX VAE on the card from seeded
    random weights; the pooled embedding of "" through CLIP-L and the
    stand-in tokenizer; ThinkDiffPipeline.generate on get_embed's
    output_embed tokens; the image, launches, velocity and PNG checks; one
    profiled step. ``embed_launches``: get_embed's launches on this path
    (lvlm_flux_embeds), counted since the counts were set to 0 before it;
    the path's launches are then its and flux_launches' together. Without
    it (random tokens in place of get_embed's) the counts are set to 0
    here and hold the FLUX part only. Returns (the path's launches,
    rates, the pipeline: clip-flux runs on it)."""
    import shutil

    import yaml
    from PIL import Image

    from thinkdiff_torch import kernels
    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.models.aligner_lvlm import flux_launches

    run = yaml.safe_load(LVLM_CONFIG.read_text())["run"]
    hgt, wdt = int(run["image_height"]), int(run["image_width"])
    steps, guidance = int(run["num_inference_steps"]), float(run["guidance_scale"])
    seed = int(run["seed"])
    torch.cuda.reset_peak_memory_stats()
    pipe = build_flux_pipe("lvlm-flux")
    cfg, clip_cfg = pipe.sampler.cfg, pipe.clip_encoder.cfg

    times, final = {}, {}
    sampler = pipe.sampler

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t
            final[name] = out
            return out
        return wrapper

    sampler.denoise = timed("denoise", sampler.denoise)
    sampler.decode = timed("decode", sampler.decode)
    cond = embeds[run["embedding_type"]]
    torch.cuda.synchronize()
    if embed_launches is None:
        kernels.reset_launch_counts()
        embed_launches = kernels.launch_counts()
    t0 = time.perf_counter()
    pooled = pipe.pooled_from_prompt("", 1)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    images = pipe.generate(cond[None], prompt="", height=hgt, width=wdt,
                           num_steps=steps, guidance=guidance, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    del sampler.denoise, sampler.decode
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    lat = final["denoise"]
    if not torch.isfinite(lat).all():
        raise AssertionError("lvlm-flux: non-finite final latents")
    if tuple(images.shape) != (1, hgt, wdt, 3):
        raise AssertionError(f"lvlm-flux: image {tuple(images.shape)}")
    img = images.float()
    if not (torch.isfinite(img).all() and float(img.min()) >= 0.0
            and float(img.max()) <= 1.0 and float(img.std()) > 0.0):
        raise AssertionError("lvlm-flux: image not finite, outside [0, 1] "
                             "or constant")
    want = flux_launches(cfg, steps, clip_cfg.num_layers)
    got = {k: launches[k] - embed_launches[k] for k in want}
    path = {k: embed_launches[k] + want.get(k, 0) for k in launches}
    if launches != path:
        raise AssertionError(f"lvlm-flux: launches {launches} != get_embed's "
                             f"{embed_launches} + flux_launches {want}")
    if float(pooled.abs().max()) == 0.0:
        raise AssertionError("lvlm-flux: the pooled embedding is zeros")
    say("lvlm-flux", f"ThinkDiffPipeline.generate on {tuple(cond.shape)} "
        f"{run['embedding_type']} tokens, {hgt}x{wdt}, {steps} steps, "
        f"guidance {guidance}, seed {seed}: {wall:.2f} s; CLIP-L pooled "
        f"embedding of \"\" {clip_ms:.1f} ms; denoise {times['denoise']:.2f} "
        f"s ({times['denoise'] / steps * 1e3:.1f} ms a step); VAE decode "
        f"{times['decode']:.2f} s; image mean {float(img.mean()):.4f} std "
        f"{float(img.std()):.4f}; final latents |max| "
        f"{float(lat.abs().max()):.3f}; peak {peak:.2f} GiB")
    say("lvlm-flux", f"FLUX launches flash_attention_fwd "
        f"{got['flash_attention_fwd']}, rmsnorm {got['rmsnorm']} = "
        f"flux_launches {want}; the whole path (get_embed + FLUX) "
        f"{launches}")

    # the trajectory's first velocity at both joint lengths, kernels vs
    # plain, and the planted faults
    noise = sampler.noise(1, lat.shape[1], seed)
    coss = {etype: flux_velocity_check(pipe, e, noise, pooled, 1.0)
            for etype, e in embeds.items()}

    FLUX_DIR.mkdir(parents=True, exist_ok=True)
    path = FLUX_DIR / f"request0_seed{seed}.png"
    save_images(images, [str(path)])
    back = np.asarray(Image.open(path))
    if not np.array_equal(back, (images.cpu() * 255).to(torch.uint8)[0]
                          .numpy()):
        raise AssertionError("lvlm-flux: the PNG read back differs")
    say("lvlm-flux", f"PNG {path.stat().st_size} bytes written and read back "
        "equal")
    shutil.rmtree(FLUX_DIR)
    prof = profile_denoise_step(pipe, cond, noise, pooled)
    return launches, {"wall_s": wall, "clip_ms": clip_ms,
                      "denoise_s": times["denoise"],
                      "ms_per_step": times["denoise"] / steps * 1e3,
                      "vae_s": times["decode"], "peak_gib": peak,
                      "cos": coss, **prof}, pipe


# ---------------------------------------------------------------------------
# ThinkDiff-CLIP
# ---------------------------------------------------------------------------

CLIP_DIR = Path(__file__).resolve().parent / "build" / "clip"
CLIP_TRAIN_CONFIG = (Path(__file__).resolve().parent / "configs"
                     / "train_thinkdiff_clip.yaml")
CLIP_IMAGE_CONFIG = (Path(__file__).resolve().parent / "configs"
                     / "test_thinkdiff_clip_image_text.yaml")
CLIP_TWO_CONFIG = (Path(__file__).resolve().parent / "configs"
                   / "test_thinkdiff_clip_two_images.yaml")
# 2 epochs of 4 steps of 32 from the cc_sbu shards (each epoch's shuffle
# buffer of 1000 re-reads them)
CLIP_IMAGES, CLIP_EPOCHS, CLIP_STEPS = 256, 2, 4
CLIP_TRAIN_KERNELS = ("flash_attention_fwd", "rmsnorm", "flash_attention_dq",
                      "flash_attention_dkv")
# one full-width ViT-g forward (B1, 39 blocks) through the flash forward
# against the same forward through mha_reference (f32): the output tokens'
# cosine at least this (the per-call check holds each call at the flash
# rows' 2e-2 + 2e-2 |ref|). Measured on the card (NVIDIA H100 80GB HBM3,
# 700 W) on seeded weights: 0.999874, the worst token 0.999857, the worst
# call at 0.26 of its limit; the limit is 4x that distance from 1, as
# FLUX_VEL_COS_MIN's
CLIP_VIT_COS_MIN = 0.9995
# the gradient check of the 2-layer full-width copy (ViT 2 blocks, T5 2 +
# 2, 4 samples) against the same step on the CPU's plain versions, bf16 on
# both sides. The loss limit is three times the largest relative
# difference of ``clip_gradient_draws`` (5 draws, model seeds 20-24 and
# 4 samples of the phase's shards each; NVIDIA H100 80GB HBM3, 700 W):
# 3.55e-5, 2.66e-6, 2.56e-6, 4.33e-5, 1.27e-5 (the phase's own 6.4e-7);
# gradient cosine 0.99999 at worst, norm ratio card/CPU 0.99978-1.00023,
# so the LVLM check's cosine limit and band stand
CLIP_GRAD_LOSS_TOL, CLIP_GRAD_COS_MIN = 1.3e-4, GRAD_COS_MIN
CLIP_GRAD_SAMPLES = 4


def clip_t5_tokenizer():
    """flan-t5's 32128 ids through the stand-in (no tokenizer files): pad
    0, eos 1, unk 2, words 3..32099."""
    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer

    return StandInTokenizer({"<pad>": 0, "</s>": 1, "<unk>": 2}, word_lo=3,
                            word_hi=32100, eos_token="</s>")


def clip_shards(root, n, seed):
    """``n`` seeded 448x448 JPEGs with captions of N(14, 6) words (2-60) in
    cc_sbu tar shards of 64: the brace pattern of the shards."""
    from thinkdiff_torch.data.tario import ShardWriter

    images, _ = requests(n, seed)
    rs = np.random.RandomState(seed + 1)
    vocab = [f"word{i}" for i in range(2000)]
    root.mkdir(parents=True, exist_ok=True)
    pattern = str(root / "%06d.tar")
    with ShardWriter(pattern, maxcount=64) as w:
        for i, im in enumerate(images):
            words = rs.choice(vocab, int(np.clip(rs.normal(14, 6), 2, 60)))
            w.write({"__key__": f"{i:09d}", "jpg": im,
                     "json": {"caption": " ".join(words).capitalize() + "."}})
        shards = w.shard
    return str(root / f"{{000000..{shards - 1:06d}}}.tar")


def clip_vit_check(model, pixels):
    """One ViT-g forward of ``pixels`` through the flash forward, every
    call held against mha_reference on its own inputs (2e-2 + 2e-2 |ref|),
    and its tokens against the same forward through mha_reference: the
    cosine over all tokens and the worst token's."""
    from unittest import mock

    from thinkdiff_torch.models import vit as vit_mod
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)

    worst = {"calls": 0, "ratio": 0.0}

    def checked(q, k, v, *a):
        o = flash_attention(q, k, v, *a)
        ref = mha_reference(q, k, v, *a).float()
        worst["calls"] += 1
        worst["ratio"] = max(worst["ratio"], float(
            ((o.float() - ref).abs() / (2e-2 + 2e-2 * ref.abs())).max()))
        return o

    vit = model.frozen["vision"]
    with torch.no_grad():
        with mock.patch.object(vit_mod, "flash_attention", checked):
            got = vit(pixels).float()
        with mock.patch.object(vit_mod, "flash_attention", mha_reference):
            want = vit(pixels).float()
    if not torch.isfinite(got).all():
        raise AssertionError("clip-flux: non-finite ViT tokens")
    cos = cosine(got, want)
    per_token = torch.nn.functional.cosine_similarity(
        got.flatten(0, 1).double(), want.flatten(0, 1).double(), dim=-1)
    say("clip-flux", f"ViT-g forward B{pixels.shape[0]} T{got.shape[1]} D88 "
        f"({model.vit_cfg.num_layers} blocks): {worst['calls']} flash calls, "
        f"the worst at {worst['ratio']:.3g} of its limit; tokens against the "
        f"plain forward: cosine {cos:.6f} (limit {CLIP_VIT_COS_MIN}), worst "
        f"token {float(per_token.min()):.6f}")
    if (worst["calls"] != model.vit_cfg.num_layers or worst["ratio"] > 1.0
            or not cos >= CLIP_VIT_COS_MIN):
        raise AssertionError(f"clip-flux: ViT check failed {worst} {cos}")
    return cos, float(per_token.min())


def _png_check(phase, path, images=None):
    """The PNG at ``path`` read back: not constant, and equal to ``images``
    (1, H, W, 3) in [0, 1] rounded as save_images rounds them."""
    from PIL import Image

    back = np.asarray(Image.open(path))
    if back.std() == 0:
        raise AssertionError(f"{phase}: constant PNG {path}")
    if images is not None and not np.array_equal(
            back, (images.cpu() * 255).to(torch.uint8)[0].numpy()):
        raise AssertionError(f"{phase}: the PNG read back differs")
    return back.shape


def phase_clip_flux(pipe):
    """ThinkDiff-CLIP inference into FLUX from its CLIs on seeded random
    weights: the single-image CLI's main over
    configs/test_thinkdiff_clip_image_text.yaml as written (1024², 28
    steps, guidance 3.5, seed 42) with one 448x448 JPEG as run.image_path;
    the CLIP model (BLIP-2 ViT-g, projector, flan-t5-xxl) and ``pipe``
    (lvlm-flux's FLUX.1-dev, CLIP-L, VAE) injected where build_model and
    from_pretrained would read files. The image, its PNG, the path's
    launches against clip_flux_launches, the ViT check, the FLUX velocity
    check at T4161 (65 tokens); then the _flux_text CLI once on two images
    (130 tokens, T4226). Returns (the single-image path's launches,
    rates, the CLIP model: clip-video and lvlm-flux-clis run on it)."""
    import shutil
    from unittest import mock

    import yaml

    from thinkdiff_torch import kernels
    from thinkdiff_torch.data.processors import BlipImageEvalProcessor
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline
    from thinkdiff_torch.models.aligner_clip import (
        BlipVisionT5Decoder, clip_flux_launches)
    from thinkdiff_torch.scripts import test_blip_vision_t5_decoder_flux as one
    from thinkdiff_torch.scripts import (
        test_blip_vision_t5_decoder_flux_text as two)
    from thinkdiff_torch.tasks import base_task

    doc = yaml.safe_load(CLIP_IMAGE_CONFIG.read_text())
    run = doc["run"]
    steps = int(run["num_inference_steps"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = BlipVisionT5Decoder(doc["model"], seed=SEED + 13)
    torch.cuda.synchronize()
    vc, tc5 = model.vit_cfg, model.t5_cfg
    say("clip-flux", f"ThinkDiff-CLIP model as written (ViT-g {vc.num_layers}"
        f" x {vc.hidden_size}, {vc.num_heads} heads of "
        f"{vc.hidden_size // vc.num_heads}; flan-t5-xxl {model.dtype} encoder "
        f"{tc5.num_layers} + decoder {tc5.num_decoder_layers}; projector "
        f"{model.cfg['mm_projector_type']}, pool x"
        f"{model.downsample_factor}) from seeded random weights in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB with FLUX")
    CLIP_DIR.mkdir(parents=True, exist_ok=True)
    imgs, _ = requests(2, SEED + 14)
    paths = []
    for name, im in zip(("animal", "glasses"), imgs):
        paths.append(CLIP_DIR / f"{name}.jpg")
        im.save(paths[-1])
    seen = {}
    generate = pipe.generate

    def recorded(embeds, *a, **kw):
        seen["cond"] = embeds
        seen["images"] = generate(embeds, *a, **kw)
        return seen["images"]

    def run_cli(main, argv):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, kernels.launch_counts()

    # the pooled embedding of "" is computed on this path, not cached
    pipe._pooled_cache.clear()
    with mock.patch.object(base_task.BaseTask, "build_model",
                           lambda self, cfg: model), \
            mock.patch.object(ThinkDiffPipeline, "from_pretrained",
                              classmethod(lambda cls, *a, **k: pipe)), \
            mock.patch.object(pipe, "generate", recorded):
        png, wall, launches = run_cli(one.main, [
            "--cfg-path", str(CLIP_IMAGE_CONFIG), "--options",
            f"run.image_path={paths[0]}",
            f"run.output_dir={CLIP_DIR / 'image_text'}"])
        cond, images = seen["cond"], seen["images"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        img = images.float()
        hgt, wdt = int(run["image_height"]), int(run["image_width"])
        if tuple(images.shape) != (1, hgt, wdt, 3) or not (
                torch.isfinite(img).all() and float(img.min()) >= 0.0
                and float(img.max()) <= 1.0 and float(img.std()) > 0.0):
            raise AssertionError(f"clip-flux: image {tuple(images.shape)} "
                                 "not finite, outside [0, 1] or constant")
        if tuple(cond.shape) != (1, 65, tc5.d_model):
            raise AssertionError(f"clip-flux: condition {tuple(cond.shape)}")
        _png_check("clip-flux", png, images)
        want = clip_flux_launches(model, pipe.sampler.cfg, steps,
                                  pipe.clip_encoder.cfg.num_layers)
        if launches != {k: want.get(k, 0) for k in launches}:
            raise AssertionError(f"clip-flux: launches {launches} != "
                                 f"clip_flux_launches {want}")
        say("clip-flux", f"test_blip_vision_t5_decoder_flux.main over the "
            f"image YAML as written: one 448x448 JPEG -> ViT-g -> pool -> "
            f"projector -> {tuple(cond.shape)} {cond.dtype} condition (T"
            f"{cond.shape[1] + 4096}), {hgt}x{wdt}, {steps} steps, guidance "
            f"{run['guidance_scale']}, seed {run['seed']}: {wall:.2f} s "
            f"(model injected, so no build); image mean "
            f"{float(img.mean()):.4f} std {float(img.std()):.4f}; PNG read "
            f"back equal; peak {peak:.2f} GiB; launches {launches} = "
            "clip_flux_launches")
        proc = BlipImageEvalProcessor(image_size=224)
        from PIL import Image

        pixels = torch.from_numpy(proc(Image.open(paths[0]))[None]).cuda()
        vit_cos = clip_vit_check(model, pixels)
        noise = pipe.sampler.noise(1, 4096, int(run["seed"]))
        vel = flux_velocity_check(pipe, cond[0], noise,
                                  pipe.pooled_from_prompt("", 1), 1.0,
                                  phase="clip-flux")
        two_png, two_wall, two_launches = run_cli(two.main, [
            "--cfg-path", str(CLIP_TWO_CONFIG), "--options",
            f"run.img_urls=[[{paths[0]}, {paths[1]}]]",
            f"run.output_dir={CLIP_DIR / 'two_images'}"])
        cond2 = seen["cond"]
    want2 = clip_flux_launches(model, pipe.sampler.cfg, steps, 0, images=2)
    if (len(two_png) != 1 or tuple(cond2.shape) != (1, 130, tc5.d_model)
            or two_launches != {k: want2.get(k, 0) for k in two_launches}):
        raise AssertionError(f"clip-flux: two images gave {two_png}, "
                             f"{tuple(cond2.shape)}, {two_launches} against "
                             f"{want2}")
    shape = _png_check("clip-flux", two_png[0], seen["images"])
    say("clip-flux", f"test_blip_vision_t5_decoder_flux_text.main over the "
        f"two-image YAML (questions [\"\"]): [img_1; img_2] "
        f"{tuple(cond2.shape)} (T{cond2.shape[1] + 4096}) -> "
        f"{Path(two_png[0]).name} {shape} in {two_wall:.2f} s; launches "
        f"{two_launches} = clip_flux_launches(images=2, CLIP-L pooled "
        "cached)")
    shutil.rmtree(CLIP_DIR)
    return launches, {"wall_s": wall, "two_wall_s": two_wall,
                      "peak_gib": peak, "vit_cos": vit_cos, "vel": vel}, model


def _clip_two_layer_copy(model_cfg, seed):
    """The CLIP model cut to 2 ViT blocks and 2 + 2 T5 layers at full
    width on the card, and the same frozen towers on the CPU (plain
    versions)."""
    from thinkdiff_torch.models.aligner_clip import BlipVisionT5Decoder
    from thinkdiff_torch.models.bridge import load_params, tree_of
    from thinkdiff_torch.models.t5 import T5ForConditionalGeneration
    from thinkdiff_torch.models.vit import VisionTransformer

    cfg = dict(model_cfg)
    cfg["vision_config"] = {**cfg.get("vision_config", {}), "num_layers": 2}
    cfg["t5_config"] = {**cfg.get("t5_config", {}), "num_layers": 2,
                        "num_decoder_layers": 2}
    model = BlipVisionT5Decoder(cfg, seed=seed)
    cpu = {"vision": VisionTransformer(model.vit_cfg, device="cpu"),
           "t5": T5ForConditionalGeneration(model.t5_cfg, device="cpu",
                                             encoder=True)}
    for name, module in cpu.items():
        load_params(module, tree_of(model.frozen[name], lambda _, t: t))
    return model, cpu


def clip_gradient_check(model_cfg, host, seed=SEED + 15, phase="clip-train"):
    """The 2-layer full-width copy: loss and projector gradients of
    ``host`` (CLIP_GRAD_SAMPLES samples) on the card (the kernels) against
    the same step through the plain versions on the CPU. Returns (relative
    loss difference, the lowest gradient cosine)."""
    model, cpu = _clip_two_layer_copy(model_cfg, seed)
    lk, gk, _ = _grad_step(model, model.frozen, host, model.device)
    lp, gp, tp = _grad_step(model, cpu, host, torch.device("cpu"))
    del model, cpu
    torch.cuda.empty_cache()
    rel = abs(lk - lp) / abs(lp)
    cos = {n: cosine(gk[n], gp[n]) for n in gk}
    ratio = {n: float(gk[n].double().norm() / gp[n].double().norm())
             for n in gk}
    lo, hi = GRAD_NORM_RATIO
    say(phase, f"gradient check, ViT 2 blocks + T5 2 + 2 layers at full "
        f"width, {host['labels'].shape[0]} samples "
        f"({int((host['labels'] >= 0).sum())} label tokens): loss card "
        f"{lk:.6f} vs CPU plain {lp:.6f} (rel {rel:.2e}, limit "
        f"{CLIP_GRAD_LOSS_TOL:g}); projector gradient cosine "
        + ", ".join(f"{n} {c:.5f}" for n, c in cos.items())
        + f" (limit {CLIP_GRAD_COS_MIN}); norm ratio card/CPU "
        + ", ".join(f"{n} {r:.5f}" for n, r in ratio.items())
        + f" (band {lo}-{hi}); CPU step {tp:.1f} s")
    if (rel > CLIP_GRAD_LOSS_TOL or min(cos.values()) < CLIP_GRAD_COS_MIN
            or not all(lo <= r <= hi for r in ratio.values())):
        raise AssertionError(f"{phase}: gradient check failed")
    return rel, min(cos.values())


def clip_gradient_draws(seeds=range(5)):
    """The CLIP gradient check's agreement over several draws (model seed
    SEED + 20 + s, CLIP_GRAD_SAMPLES samples of the phase's shards drawn
    from seed s): prints the loss difference and the lowest gradient
    cosine a draw, from which CLIP_GRAD_LOSS_TOL / CLIP_GRAD_COS_MIN are
    set. Run alone: ``python3 -c "import chip_smoke as c;
    c.phase_device(); c.phase_build(); c.clip_gradient_draws()"``."""
    import yaml

    from thinkdiff_torch.data.builders import CCSBUBuilder
    from thinkdiff_torch.core.config import ConfigNode

    doc = yaml.safe_load(CLIP_TRAIN_CONFIG.read_text())
    storage = clip_shards(CLIP_DIR / "draws", 64, SEED + 30)
    ds = doc["datasets"]["cc_sbu"]
    out = []
    for s in seeds:
        bundle = CCSBUBuilder(ConfigNode({**ds, "build_info": {
            "storage": storage}}), model_cfg=doc["model"]).build()
        bundle.set_tokenizers(clip_t5_tokenizer(), None)
        it = iter(bundle.get_loader(batch_size=CLIP_GRAD_SAMPLES, seed=s))
        host = next(it)
        it.close()
        rel, cos = clip_gradient_check(doc["model"], host, SEED + 20 + s,
                                       phase="clip-draws")
        out.append((rel, cos))
    import shutil

    shutil.rmtree(CLIP_DIR / "draws")
    say("clip-draws", f"largest relative loss difference "
        f"{max(r for r, _ in out):.3e}, lowest cosine "
        f"{min(c for _, c in out):.5f} over {len(out)} draws")
    return out


def phase_clip_train():
    """ThinkDiff-CLIP training from its CLI: thinkdiff_torch.train.main over
    configs/train_thinkdiff_clip.yaml as written (BLIP-2 ViT-g, flan-t5-xxl
    bf16 encoder 24 + decoder 24, batch 32, max_txt_len 128) on seeded
    cc_sbu shards, only the storage, output directory and epoch length
    overridden (2 epochs of 4 steps); the flan-t5 stand-in tokenizer
    patched in. Losses and gradient norms finite, the projector updated,
    the launches against clip_train_launches, the 2-layer gradient check,
    a 10-step overfit, one profiled step. Returns (launches, rates); the
    shards stay for the ddp phase's CLIP step."""
    from unittest import mock

    from thinkdiff_torch import kernels, train
    from thinkdiff_torch.core.optim import tree_leaves
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.models.aligner_clip import (
        BlipVisionT5Decoder, clip_train_launches)

    t0 = time.perf_counter()
    storage = clip_shards(CLIP_DIR / "shards", CLIP_IMAGES, SEED + 16)
    shard_s = time.perf_counter() - t0
    record, first = [], {}
    step = Trainer.train_step

    def recorded(self, state, batch, rng=None):
        if not first:
            first["params"] = {n: p.detach().clone()
                               for n, p in tree_leaves(state["params"])}
            first["batch"] = batch
        t = time.perf_counter()
        state, m = step(self, state, batch, rng)
        record.append({"step": state["step"], "lr": m["lr"],
                       "loss": m["loss"], "grad_norm": m["grad_norm"],
                       "t": t})
        return state, m

    argv = ["--cfg-path", str(CLIP_TRAIN_CONFIG), "--job-id", "clip",
            "--options", f"datasets.cc_sbu.build_info.storage={storage}",
            f"run.output_dir={CLIP_DIR / 'train'}",
            f"run.max_epoch={CLIP_EPOCHS}",
            f"run.iters_per_epoch={CLIP_STEPS}"]
    tok = clip_t5_tokenizer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(Trainer, "train_step", recorded), \
            mock.patch.object(BlipVisionT5Decoder, "get_t5_tokenizer",
                              lambda self: tok), CapturedLog(
                "thinkdiff_torch.data.builders", CC_SBU_LOG) as data_log:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runner = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model, n = runner.model, CLIP_EPOCHS * CLIP_STEPS
    losses, norms = check_finite("clip-train", record)
    if len(record) != n:
        raise AssertionError(f"clip-train: {len(record)} steps, not {n}")
    moved = {k: float((p - first["params"][k]).abs().max())
             for k, p in tree_leaves(runner.state["params"])}
    if min(moved.values()) == 0:
        raise AssertionError(f"clip-train: projector not updated: {moved}")
    dec_len = int(first["batch"]["labels"].shape[1])
    per_step = clip_train_launches(model, dec_len)
    expect_launches("clip-train", launches, per_step, n, CLIP_TRAIN_KERNELS)
    if launches["s8_matmul"] or launches["s8_matmul_bwd"]:
        raise AssertionError("clip-train: a bf16 model launched s8 kernels")
    out = Path(runner.output_dir)
    lines = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    if [e["epoch"] for e in lines if "train_loss" in e] != list(
            range(CLIP_EPOCHS)) or not all(
            (out / f"checkpoint_{e}.pth").exists() for e in range(CLIP_EPOCHS)):
        raise AssertionError(f"clip-train: log.txt / checkpoints {lines[1:]}")
    gaps = [b["t"] - a["t"] for a, b in zip(record, record[1:])
            if b["step"] % CLIP_STEPS != 1]     # within an epoch
    step_ms = statistics.median(gaps) * 1e3
    b = first["batch"]
    vc, tc5 = model.vit_cfg, model.t5_cfg
    say("clip-train", f"train YAML as written (ViT-g {vc.num_layers} x "
        f"{vc.hidden_size}, flan-t5-xxl {model.dtype} encoder "
        f"{tc5.num_layers} + decoder {tc5.num_decoder_layers}, batch "
        f"{b['pixel_values'].shape[0]}, pixels {tuple(b['pixel_values'].shape[1:])}, "
        f"text {tuple(b['input_ids'].shape)} / labels {tuple(b['labels'].shape)}) "
        f"on {CLIP_IMAGES} seeded images in cc_sbu shards ({shard_s:.1f} s to "
        f"write), {CLIP_EPOCHS} epochs x {CLIP_STEPS} steps in {wall:.1f} s "
        f"(model build and each epoch's shuffle-buffer fill included); "
        f"{step_ms:.0f} ms a step through the runner (median gap within an "
        f"epoch); losses " + " ".join(f"{x:.4f}" for x in losses.tolist())
        + f"; grad norm {norms.min():.4g}-{norms.max():.4g}; peak "
        f"{peak:.2f} GiB")
    say("clip-train", f"launches over {n} steps "
        f"{dict((k, launches[k]) for k in CLIP_TRAIN_KERNELS)} = steps x "
        f"clip_train_launches {per_step} (ViT {vc.num_layers} and encoder "
        f"{tc5.num_layers} flash forwards without gradient, then the "
        "decoder's as the LVLM step counts them)")
    host = {k: v[:CLIP_GRAD_SAMPLES].cpu().numpy() for k, v in b.items()}
    grad = clip_gradient_check(model.cfg, host)
    fit = Trainer(model, {"init_lr": 1e-3, "min_lr": 1e-3, "warmup_steps": 0,
                          "weight_decay": 0.05})
    fstate = fit.init_state()
    fl = [fit.train_step(fstate, b)[1] for _ in range(10)]
    fl, _ = check_finite("clip overfit", fl)
    if not fl[-1] < fl[0]:
        raise AssertionError(f"clip overfit: loss did not fall: {fl.tolist()}")
    say("clip-train", "overfit, one batch, lr 1e-3, 10 steps: loss "
        + " ".join(f"{x:.4f}" for x in fl.tolist()))
    phase_profile_train(runner.trainer, runner.state, b,
                        label="CLIP training step (batch 32: ViT-g, flan-t5-"
                        "xxl bf16 encoder + decoder, 128 + 128 tokens)")
    data_path = check_data_path("clip-train", data_log.lines)
    return launches, {"step_ms": step_ms, "wall_s": wall, "peak_gib": peak,
                      "grad": grad, "storage": storage,
                      "data_path": data_path}


# ---------------------------------------------------------------------------
# ThinkDiff-CLIP into a CogVideoX-5b video
# ---------------------------------------------------------------------------

VIDEO_DIR = Path(__file__).resolve().parent / "build" / "clip_video"
CLIP_VIDEO_CONFIG = (Path(__file__).resolve().parent / "configs"
                     / "test_thinkdiff_clip_video_text.yaml")
# the video CLI reads run.num_frames as LATENT frames (the JAX script's
# reading); 13 latent frames are the YAML's 49 output frames
VIDEO_LATENT_FRAMES = 13
# the YAML's 50 DDIM steps cut to 15, the one cut: a step takes 3.65 s on
# an H100 (NVIDIA H100 80GB HBM3, 700 W; two forwards at T17623, #1 ~27 ms
# a call, 84 calls, 62% of the step), and the script's phases read 625.0 s
# with 25 steps on a slow host. Every step runs the same two forwards; the
# launches count the steps run
VIDEO_STEPS = 15
# one CogVideoX-5b forward at full shape (T17776: the 65 vision tokens and
# 161 text tokens of the 226-token budget, 13 x 30 x 45 video tokens)
# through the flash forward against the same forward through mha_heads
# (f32): the velocity cosine at least COG_VEL_COS_MIN, every call held on
# its own inputs at FLUX_FLASH_REL * max|ref| and at COG_FLASH_FRO *
# ||ref|| (the Frobenius norm of its error). The second is what sees a lost
# key tile here: the model's v has a mean over the keys that a key's loss
# barely moves, so max|err| stays a small part of max|ref|. Measured on
# the card (NVIDIA H100 80GB HBM3, 700 W) on seeded weights, over the 42
# calls: sound ||err|| / ||ref|| 5.6e-4-8.0e-4 (the bf16 output's rounding),
# max|err| / max|ref| <= 0.0075, velocity cosine 0.999888; a key tile
# skipped 2.0e-3-9.8e-3 (9.8e-3 at the first call), the keys' 112-row tail
# cut 2.0e-3-9.6e-3, the queries' tail left zero 0.079, a uniform softmax
# >= 0.075, cosines 0.999880 / 0.999881 / 0.99906 / 0.99659. The limits sit
# near twice the sound readings (1.5e-3; 0.9995, 4x the sound distance
# from 1, as FLUX_VEL_COS_MIN): every fault fails at its first call; no
# cosine tells a lost tile or tail from sound rounding
COG_VEL_COS_MIN = 0.9995
COG_FLASH_FRO = 1.5e-3


class _Caught(Exception):
    """A planted fault's first call beyond its limit (ends that forward)."""


def build_cogvideo(phase):
    """CogVideoX-5b (42 blocks, hidden 3072, bf16) in a CogVideoXSampler and
    its VAE decoder (bf16) on the card from seeded random weights (FLUX's
    initializer: kernels N(0, 0.02), biases 0, LayerNorm and GroupNorm
    scales 1)."""
    from thinkdiff_torch.models.cogvideox import (
        CogVideoXConfig, CogVideoXSampler, CogVideoXTransformer)
    from thinkdiff_torch.models.cogvideox_vae import (
        CogVideoXVAEConfig, CogVideoXVAEDecoder)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    cfg = CogVideoXConfig.cogvideox_5b()
    transformer = CogVideoXTransformer(cfg, device="cuda")
    init_random_(transformer, gen)
    vcfg = CogVideoXVAEConfig.cogvideox_5b()
    decoder = CogVideoXVAEDecoder(vcfg, device="cuda")
    init_random_(decoder, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in transformer.parameters())
    say(phase, f"CogVideoX-5b ({cfg.num_layers} blocks, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads of {cfg.head_dim}, "
        f"{n_params / 1e9:.2f} B params, bf16) and its 3D VAE decoder "
        f"(channels {tuple(reversed(vcfg.block_out_channels))}, bf16) from "
        f"seeded random weights (std {FLUX_INIT_STD}) in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB in all")
    return CogVideoXSampler(cfg, transformer), decoder


def cogvideo_forward(sampler, cond, latents, timestep, attention):
    """One transformer forward at full shape with ``attention`` in place of
    the flash forward at its call site in models/cogvideox.py: the f32
    velocity."""
    from unittest import mock

    from thinkdiff_torch.models import cogvideox as cog_mod

    ts = torch.full((latents.shape[0],), timestep, dtype=torch.int32,
                    device=latents.device)
    with torch.no_grad(), \
            mock.patch.object(cog_mod, "flash_attention", attention):
        out = sampler.transformer(latents, cond, ts).float()
    if not torch.isfinite(out).all():
        raise AssertionError("cogvideox forward: non-finite velocity")
    return out


def cogvideo_velocity_check(sampler, cond, latents, timestep,
                            phase="clip-video"):
    """The CogVideoX forward through the kernel against its plain version
    (mha_heads): the velocity cosine, and every flash call held against
    mha_heads on its own inputs at FLUX_FLASH_REL * max|ref| and
    COG_FLASH_FRO * ||ref|| (``ratio``: the larger error over its limit,
    at most 1). Then planted faults in place of the kernel: a key tile
    skipped (keys 2048-2175), the keys' ragged tail cut to a multiple of
    128, and the queries' ragged tail left zero; each must fail the
    per-call check (the forward ends at its first failing call). Returns
    {run: ...}."""
    from thinkdiff_torch.ops.flash_attention import flash_attention

    t = cond.shape[1] + latents.shape[1] * latents.shape[2] \
        * latents.shape[3] // 4
    cut = t - t % 128
    skip = torch.cat([torch.arange(2048), torch.arange(2176, t)]).cuda()

    def query_tail_zero(q, k, v, *a):
        o = flash_attention(q, k, v, *a)
        o[:, :, cut:] = 0
        return o

    t0 = time.perf_counter()
    want = cogvideo_forward(sampler, cond, latents, timestep, mha_heads)
    plain_s = time.perf_counter() - t0
    runs = {"sound": flash_attention,
            "key tile 16 skipped": lambda q, k, v, *a: flash_attention(
                q, k[:, :, skip], v[:, :, skip], *a),
            f"keys' {t - cut}-row tail cut": lambda q, k, v, *a:
                flash_attention(q, k[:, :, :cut], v[:, :, :cut], *a),
            f"queries' {t - cut}-row tail left zero": query_tail_zero}
    out = {}
    for run, attention in runs.items():
        worst = {"calls": 0, "ratio": 0.0, "fro": 0.0}

        def checked(q, k, v, *a, attention=attention, run=run):
            o = attention(q, k, v, *a)
            ref = mha_heads(q, k, v, *a).float()
            err = o.float() - ref
            worst["calls"] += 1
            worst["fro"] = max(worst["fro"], float(err.norm() / ref.norm()))
            worst["ratio"] = max(worst["ratio"], float(
                err.abs().max()) / flux_flash_limit(ref),
                worst["fro"] / COG_FLASH_FRO)
            if run != "sound" and worst["ratio"] > 1.0:
                raise _Caught()
            return o

        try:
            got = cogvideo_forward(sampler, cond, latents, timestep, checked)
            out[run] = {"cos": cosine(got, want), **worst}
            say(phase, f"velocity at joint length {t} (B1 H48 D64), {run}: "
                f"cosine {out[run]['cos']:.6f} against the plain forward "
                f"(limit {COG_VEL_COS_MIN}; the plain forward "
                f"{plain_s:.1f} s); {worst['calls']} flash calls, the worst "
                f"at {worst['ratio']:.3g} of its limits (||err|| / ||ref|| "
                f"{worst['fro']:.3g}, limit {COG_FLASH_FRO})")
        except _Caught:
            out[run] = {"cos": None, **worst}
            say(phase, f"velocity at joint length {t}, planted fault {run}: "
                f"caught by the per-call check at call {worst['calls']} "
                f"({worst['ratio']:.3g} of its limits, ||err|| / ||ref|| "
                f"{worst['fro']:.3g})")
        if run == "sound" and (worst["ratio"] > 1.0 or worst["calls"]
                               != sampler.cfg.num_layers
                               or not out[run]["cos"] >= COG_VEL_COS_MIN):
            raise AssertionError(f"{phase}: velocity check failed {out}")
        if run != "sound" and out[run]["cos"] is not None:
            raise AssertionError(f"{phase}: the planted fault {run!r} passes "
                                 f"the per-call check {out[run]}")
    return out


def profile_cogvideo_step(sampler, cond, latents):
    """One DDIM step at full shape (two transformer forwards, cond and
    uncond, and the f32 update) under torch.profiler: wall time, device-busy
    share and the kernels that take the time."""
    from torch.autograd import DeviceType
    from torch.utils.flop_counter import FlopCounterMode

    step = lambda: sampler.denoise(latents, cond, 1, 6.0)
    with FlopCounterMode(display=False) as fc:
        step()
    torch.cuda.synchronize()
    proj_flops = fc.get_total_flops()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    cfg = sampler.cfg
    t = cond.shape[1] + latents[0].numel() // cfg.in_channels // 4
    say("profile", f"CogVideoX-5b denoise step (cond + uncond), joint length "
        f"{t}: {wall_ms:.1f} ms unprofiled; device kernel time "
        + (f"{busy_ms:.1f} ms, busy {busy_ms / wall_ms:.0%}" if by_name
           else "not measured (no device events in the trace)"))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("profile", f"  {us / 1e3:.3f} ms/step  {name[:100]}")
    say_total(by_name, "flash_fwd", "the flash forward (#1)", 1)
    say_total(by_name, "nvjet", "cuBLAS (the projections)", 1)
    say_total(by_name, "elementwise", "PyTorch's elementwise kernels", 1)
    say_total(by_name, "copy", "PyTorch's copies", 1)
    say_total(by_name, "reduce", "PyTorch's reductions (LayerNorm)", 1)
    attn_flops = 2 * cfg.num_layers * 4 * cfg.num_heads * t * t * cfg.head_dim
    say("profile", f"  the step's work: projections {proj_flops / 1e12:.2f} "
        f"TFLOP (torch.utils.flop_counter), "
        f"{bound_ms(0, proj_flops, 'bf16')[0]:.1f} ms at the bf16 peak; joint "
        f"attention {attn_flops / 1e12:.2f} TFLOP, "
        f"{bound_ms(0, attn_flops, 'bf16')[0]:.1f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "flash_ms": sum(v for k, v in by_name.items()
                            if "flash_fwd" in k) / 1e3}


def _video_read_back(path, frames):
    """The video at ``path`` through the port's VideoReader against the
    uint8 frames (T, H, W, 3): (container, frames read, mean and max |diff|
    in levels)."""
    from thinkdiff_torch.data.video_io import VideoReader

    reader = VideoReader(str(path))
    back = reader.get_batch(range(len(reader))).astype(np.int32)
    if back.shape != frames.shape:
        raise AssertionError(f"clip-video: read back {back.shape} against "
                             f"{frames.shape}")
    diff = np.abs(back - frames.astype(np.int32))
    return Path(path).suffix, len(reader), float(diff.mean()), int(diff.max())


# the video read back through VideoReader against the frames written: mean
# |diff| in levels at most this. On the card the CLI's mp4 goes through
# cv2's MPEG-4 Part 2 encoder (lossy): measured 6.61 levels mean (max 126)
# on the random-weight frames (std 16.9; NVIDIA H100 80GB HBM3, 700 W); an
# AVI (no encoder) is MJPEG at quality 92, closer. Frames read back in the
# wrong order or from another video differ by ~19 levels (two frames of
# that std)
VIDEO_READ_MEAN_MAX = 10.0


def phase_clip_video(model):
    """ThinkDiff-CLIP into a CogVideoX-5b video from its CLI on seeded
    random weights: test_blip_vision_t5_decoder_cogvideo.main over
    configs/test_thinkdiff_clip_video_text.yaml as written but for what the
    script reads and the YAML lacks (run.image_path: one 448x448 JPEG;
    run.text_input: the YAML's question; run.num_frames: 13 latent frames),
    so 49 frames of 480x720, guidance 6, seed 42, with num_inference_steps
    cut from 50 to VIDEO_STEPS (the time budget); ``model`` (the
    CLIP model of clip-flux: ViT-g + flan-t5-xxl) injected where
    build_model would read files, its T5 encoder as the text embedder (the
    flan-t5 stand-in tokenizer), CogVideoX-5b and its VAE from seeded
    weights in place of the checkpoint. The frames, the latents, the video
    read back, the launches against cogvideo_launches, the velocity check
    at T17776 with its planted faults, one profiled step."""
    import shutil
    from unittest import mock

    import yaml

    from thinkdiff_torch import kernels
    from thinkdiff_torch.engines import pipeline as pipeline_mod
    from thinkdiff_torch.models import cogvideox_vae as vae_mod
    from thinkdiff_torch.models.aligner_clip import cogvideo_launches
    from thinkdiff_torch.scripts import (
        test_blip_vision_t5_decoder_cogvideo as script)
    from thinkdiff_torch.tasks import base_task

    run = yaml.safe_load(CLIP_VIDEO_CONFIG.read_text())["run"]
    steps, seed = VIDEO_STEPS, int(run["seed"])
    hgt, wdt = int(run["video_height"]), int(run["video_width"])
    torch.cuda.reset_peak_memory_stats()
    sampler, decoder = build_cogvideo("clip-video")
    embedder = pipeline_mod.T5TextEmbedder(model.frozen["t5"],
                                           clip_t5_tokenizer())
    VIDEO_DIR.mkdir(parents=True, exist_ok=True)
    image = VIDEO_DIR / "animal.jpg"
    requests(1, SEED + 17)[0][0].save(image)
    seen, times = {}, {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t
            seen[name] = (a, out)
            return out
        return wrapper

    sampler.denoise = timed("denoise", sampler.denoise)
    decode = timed("decode", vae_mod.decode_latents)
    with mock.patch.object(base_task.BaseTask, "build_model",
                           lambda self, cfg: model), \
            mock.patch.object(pipeline_mod.T5TextEmbedder, "from_pretrained",
                              classmethod(lambda cls, *a, **k: embedder)), \
            mock.patch.object(script, "load_cogvideo",
                              lambda path, device: (sampler, decoder)), \
            mock.patch.object(vae_mod, "decode_latents", decode):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        path = script.main([
            "--cfg-path", str(CLIP_VIDEO_CONFIG), "--options",
            f"run.image_path={image}", f"run.text_input={run['questions'][0]}",
            f"run.num_frames={VIDEO_LATENT_FRAMES}",
            f"run.num_inference_steps={steps}",
            f"run.output_dir={VIDEO_DIR / 'out'}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    del sampler.denoise
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (lat0, cond), lat = seen["denoise"][0][:2], seen["denoise"][1]
    frames = seen["decode"][1][0].cpu().numpy()
    n_out = (VIDEO_LATENT_FRAMES - 1) * 4 + 1
    if tuple(frames.shape) != (n_out, hgt, wdt, 3) or frames.dtype != np.uint8 \
            or frames.std() == 0:
        raise AssertionError(f"clip-video: frames {frames.shape} "
                             f"{frames.dtype} or constant")
    if not torch.isfinite(lat).all():
        raise AssertionError("clip-video: non-finite final latents")
    n_txt = cond.shape[1] - script.VISION_TOKEN_BUDGET
    if not (cond.shape[0] == 1 and 1 <= n_txt <= 161):
        raise AssertionError(f"clip-video: condition {tuple(cond.shape)}")
    want = cogvideo_launches(model, model.t5_cfg, sampler.cfg, steps)
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"clip-video: launches {launches} != "
                             f"cogvideo_launches {want}")
    kind, n_read, mean_diff, max_diff = _video_read_back(path, frames)
    if n_read != n_out or not mean_diff <= VIDEO_READ_MEAN_MAX:
        raise AssertionError(f"clip-video: {path} read back {n_read} frames, "
                             f"mean |diff| {mean_diff}")
    t_joint = cond.shape[1] + lat[0].numel() // sampler.cfg.in_channels // 4
    say("clip-video", f"test_blip_vision_t5_decoder_cogvideo.main over the "
        f"video YAML (run.num_frames={VIDEO_LATENT_FRAMES} latent frames): one "
        f"448x448 JPEG -> ViT-g -> pool -> projector -> "
        f"{script.VISION_TOKEN_BUDGET} tokens + {n_txt} T5 text tokens = "
        f"{tuple(cond.shape)} (joint T{t_joint}), latents "
        f"{tuple(lat.shape)}, {steps} steps (the YAML's "
        f"{run['num_inference_steps']} cut, VIDEO_STEPS), guidance "
        f"{run['guidance_scale']}, seed {seed}: {wall:.2f} s for the video; "
        f"denoise {times['denoise']:.2f} s "
        f"({times['denoise'] / steps * 1e3:.1f} ms a step), VAE decode "
        f"{times['decode']:.2f} s ({len(frames)} frames of {hgt}x{wdt}); "
        f"frames mean {frames.mean():.2f} std {frames.std():.2f}; final "
        f"latents |max| {float(lat.abs().max()):.3f}; peak {peak:.2f} GiB")
    say("clip-video", f"{Path(path).name}: {kind} container, {n_read} frames "
        f"read back by VideoReader, mean |diff| {mean_diff:.3f} levels (limit "
        f"{VIDEO_READ_MEAN_MAX}), max {max_diff}; launches {launches} = "
        "cogvideo_launches")
    # the full 226-token budget: the path's vision tokens and 161 text tokens
    long_text = " ".join([run["questions"][0]] * 40)
    full = torch.cat([cond[0, :script.VISION_TOKEN_BUDGET].float(),
                      embedder(long_text, max_len=161)[0]], 0)[None]
    vel = cogvideo_velocity_check(sampler, full, lat0, 999)
    prof = profile_cogvideo_step(sampler, cond, lat0)
    shutil.rmtree(VIDEO_DIR)
    del sampler, decoder
    return launches, {"wall_s": wall, "denoise_s": times["denoise"],
                      "ms_per_step": times["denoise"] / steps * 1e3,
                      "vae_s": times["decode"], "peak_gib": peak,
                      "read_mean_diff": mean_diff, "vel": vel, **prof}


# ---------------------------------------------------------------------------
# The six remaining LVLM FLUX CLIs
# ---------------------------------------------------------------------------

CLIS_DIR = Path(__file__).resolve().parent / "build" / "lvlm_flux_clis"
# each FLUX CLI samples 4 steps (the 28-step path is timed in lvlm-flux)
CLIS_FLUX_STEPS = 4


def phase_lvlm_flux_clis(pipe, clip_model):
    """The six remaining LVLM FLUX CLIs' main() over the LVLM inference YAML
    as written but for what each reads and the YAML lacks (its image,
    prompt, case or export paths) and num_inference_steps 4: the
    multi-image CLI (two 448x448 images), the single-image exporter, the
    replay CLI on that export with extra T5 text, the text-only embed probe,
    the CoBSAT multi-image exporter (one case of two images) and its batch
    exporter (two cases, one batch), and the replay CLI on one array of
    each CoBSAT export. The LVLM model (Qwen2-VL-7B w8a8, flan-t5-xxl int8,
    as lvlm-text builds it) and ``pipe`` (lvlm-flux's FLUX.1-dev, CLIP-L,
    VAE) are injected where build_model and from_pretrained would read
    files; the text embedder is ``clip_model``'s flan-t5-xxl encoder.
    Each run's launches (counts set to 0 before it) against
    get_embed_launches + flux_launches (+ the T5 encoder's for the extra
    text); images finite, in [0, 1], not constant, their PNGs read back
    equal; exports read back. Returns (the multi-image CLI's launches,
    rates)."""
    import importlib
    import json as _json
    import shutil
    from collections import Counter
    from unittest import mock

    import yaml

    from thinkdiff_torch import kernels
    from thinkdiff_torch.engines import pipeline as pipeline_mod
    from thinkdiff_torch.models.aligner_lvlm import (
        flux_launches, get_embed_launches)
    from thinkdiff_torch.tasks import base_task

    run = yaml.safe_load(LVLM_CONFIG.read_text())["run"]
    hgt, wdt = int(run["image_height"]), int(run["image_width"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_lvlm_model()
    say("lvlm-flux-clis", f"the LVLM model (Qwen2-VL-7B w8a8, flan-t5-xxl "
        f"int8) rebuilt in {time.perf_counter() - t0:.1f} s beside FLUX and "
        f"the CLIP model: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    embedder = pipeline_mod.T5TextEmbedder(clip_model.frozen["t5"],
                                           clip_t5_tokenizer())
    CLIS_DIR.mkdir(parents=True, exist_ok=True)
    images, _ = requests(4, SEED + 18)
    paths = []
    for i, im in enumerate(images):
        paths.append(CLIS_DIR / f"img{i}.jpg")
        im.save(paths[-1])
    # two CoBSAT cases of two images: both for the batch exporter (one
    # batch), the first alone for the multi-image exporter
    cases, one_case = CLIS_DIR / "cases", CLIS_DIR / "one_case"
    for d in (cases, one_case):
        d.mkdir()
    for i in range(2):
        spec = _json.dumps({
            "text_inputs": [f"red apple{i}", f"blue ball{i}"],
            "image_inputs": [str(paths[2 * i]), str(paths[2 * i + 1])]})
        for d in (cases, one_case)[:2 - i]:
            (d / f"case{i}.json").write_text(spec)
    seen = {"gen": [], "images": []}
    get_embed, generate = model.get_embed, pipe.generate

    def recorded_embed(*a, **kw):
        out = get_embed(*a, **kw)
        seen["gen"].append(out[1])
        return out

    def recorded_generate(*a, **kw):
        seen["images"].append(generate(*a, **kw))
        return seen["images"][-1]

    t5 = clip_model.t5_cfg
    t5_launches = {"flash_attention_fwd": t5.num_layers,
                   "rmsnorm": 2 * t5.num_layers + 1}
    max_tokens = int(run["max_new_tokens"])
    flux_cfg = pipe.sampler.cfg
    out, rates = {}, {}
    steps = [f"run.num_inference_steps={CLIS_FLUX_STEPS}"]
    plan = [
        ("multi_image", steps + [f"run.image_paths=[{paths[0]}, {paths[1]}]",
                                 "run.text_inputs=[red, blue]"]),
        ("embed", [f"run.image_path={paths[2]}",
                   "run.text_input=describe this picture"]),
        ("multi_image_input", steps + [
            f"run.embed_path={CLIS_DIR / 'embed' / 'img2.npy'}",
            "run.extra_text_input=in the style of a watercolour"]),
        ("multi_image_input_embed", steps + [
            "run.prompts=[a red apple on a wooden table]"]),
        ("embed_multi_image", [f"run.image_folder={one_case}",
                               "run.prompt=Look at the pictures. "]),
        ("embed_multi_image_batch", [f"run.cobsat_json_dir={cases}"]),
        ("multi_image_input", steps + [
            f"run.embed_path={CLIS_DIR / 'embed_multi_image' / 'case0.pth'}"]),
        ("multi_image_input", steps + [
            f"run.embed_path={CLIS_DIR / 'embed_multi_image_batch' / 'case1.npy'}"]),
    ]
    with mock.patch.object(base_task.BaseTask, "build_model",
                           lambda self, cfg: model), \
            mock.patch.object(pipeline_mod.ThinkDiffPipeline, "from_pretrained",
                              classmethod(lambda cls, *a, **k: pipe)), \
            mock.patch.object(pipeline_mod.T5TextEmbedder, "from_pretrained",
                              classmethod(lambda cls, *a, **k: embedder)), \
            mock.patch.object(model, "get_embed", recorded_embed), \
            mock.patch.object(pipe, "generate", recorded_generate):
        for name, options in plan:
            cli = importlib.import_module(
                f"thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_{name}")
            seen["gen"].clear()
            seen["images"].clear()
            cached = ("", 1) in pipe._pooled_cache
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            result = cli.main(["--cfg-path", str(LVLM_CONFIG), "--options",
                               *options, f"run.output_dir={CLIS_DIR / name}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = kernels.launch_counts()
            want = Counter()
            for gen in seen["gen"]:  # the text-only probe has no vision pass
                want.update(get_embed_launches(
                    model, [len(p) for p in gen.prompt_token_ids], max_tokens,
                    0 if name == "multi_image_input_embed" else 1))
            if seen["images"]:
                want.update(flux_launches(
                    flux_cfg, CLIS_FLUX_STEPS,
                    0 if cached else pipe.clip_encoder.cfg.num_layers))
            if any("extra_text_input" in o for o in options):
                want.update(t5_launches)
            if launches != {k: want.get(k, 0) for k in launches}:
                raise AssertionError(f"lvlm-flux-clis {name}: launches "
                                     f"{launches} != {want}")
            note = ""
            for img in seen["images"]:
                x = img.float()
                if tuple(img.shape) != (1, hgt, wdt, 3) or not (
                        torch.isfinite(x).all() and float(x.min()) >= 0.0
                        and float(x.max()) <= 1.0 and float(x.std()) > 0.0):
                    raise AssertionError(f"lvlm-flux-clis {name}: image "
                                         f"{tuple(img.shape)} not finite, "
                                         "outside [0, 1] or constant")
            pngs = ([result] if isinstance(result, str) else result) \
                if seen["images"] else []
            for png, img in zip(pngs, seen["images"]):
                _png_check("lvlm-flux-clis", png, img)
                note = f"{Path(png).name} {hgt}x{wdt} read back equal"
            if name.startswith("embed"):
                files = [result] if isinstance(result, str) else result
                for f in files:
                    arr = (np.load(f) if f.endswith(".npy") else
                           torch.load(f, weights_only=True).numpy())
                    if not (arr.dtype == np.float32 and arr.ndim == 2
                            and arr.shape[1] == model.t5_cfg.d_model
                            and np.isfinite(arr).all()):
                        raise AssertionError(f"lvlm-flux-clis {name}: "
                                             f"export {f} {arr.shape}")
                note = (f"{len(files)} exports ("
                        + ", ".join(Path(f).name for f in files)
                        + f", {arr.shape} f32) read back")
            key = name if name not in out else f"{name} ({Path(options[-1]).name})"
            out[key] = launches
            rates[key] = wall
            say("lvlm-flux-clis", f"test_mllama_t5_decoder_flux_{name}.main "
                f"({', '.join(o.split('=')[0] for o in options)}): "
                f"{wall:.2f} s; {len(seen['gen'])} get_embed call(s), "
                f"{len(seen['images'])} FLUX image(s) of {CLIS_FLUX_STEPS} "
                f"steps; {note}; launches {launches} = derived")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("lvlm-flux-clis", f"six CLIs, {len(plan)} runs in "
        f"{sum(rates.values()):.2f} s; peak {peak:.2f} GiB with the LVLM "
        "model, FLUX and the CLIP model on the card")
    shutil.rmtree(CLIS_DIR)
    del model
    return out["multi_image"], {"walls": rates, "peak_gib": peak}


def phase_dense_int8(base_cfg, params):
    """The dense slice with ``quantization: int8``: the 2B LM weight-only
    (the same seeded int8 weights without the w8a8 input scales), so every
    decode step's projections take the GEMV."""
    import copy

    from thinkdiff_torch.models.qwen2_vl import Qwen2VLConfig

    cfg_d = copy.deepcopy(base_cfg)
    cfg_d["vllm_config"]["quantization"] = "int8"
    cfg = Qwen2VLConfig.qwen2_vl_2b(quant_int8=True, fused_proj=True,
                                    vision_quant=True)

    def strip(node):
        return {k: strip(v) for k, v in node.items() if k != "input_scale"} \
            if isinstance(node, dict) else node

    wparams = {"vision": params["vision"], "lm": strip(params["lm"])}
    model = build_model(cfg_d, cfg, wparams, DENSE_OVERRIDES)
    out, images, launches, _, _ = serve(
        "dense-int8", model, 8, None,
        ["flash_attention_fwd", "rmsnorm", "int8_matmul"])
    if launches["s8_matmul"]:
        raise AssertionError("dense-int8: a weight-only LM launched s8 GEMMs")
    teacher_forcing_check("dense-int8", model.engine, out, images, 0)
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
    say_total(by_name, "paged_decode", "the paged decode (#4)", steps)
    del pools


# ---------------------------------------------------------------------------
# ddp: stages 1 and 2 over several ranks, through torch.distributed.run
# ---------------------------------------------------------------------------

DDP_DIR = Path(__file__).resolve().parent / "build" / "ddp"
DDP_WORLD = 2
DDP_TIMEOUT = 420        # seconds one launch of the ranks may take
# the limits of the cli phase's resume check and of the gradient check
# (PERF.md section 2): a rank's loss against the world-1 run on the
# concatenated global batch, and each projector leaf's cosine and norm
# ratio; here also each step's gradient norm, the reduced gradient's
DDP_LOSS_TOL, DDP_COSINE, DDP_NORM_RATIO = (CLI_LOSS_TOL, CLI_COSINE,
                                            GRAD_NORM_RATIO)
# ThinkDiff-CLIP's step takes 37.7 GiB at batch 32 (clip-train's peak): two
# ranks of the full flan-t5-xxl (encoder 24 + decoder 24) would not fit one
# 80 GB card beside each other, so its two-rank step cuts both T5 stacks to
# this depth (widths and ViT-g as written)
CLIP_DDP_T5_LAYERS = 12
CLIP_DDP_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(phase, nproc, child_args, timeout=DDP_TIMEOUT):
    """``python -m torch.distributed.run --nproc_per_node nproc
    chip_smoke.py --ddp-child ...`` as the leader of a POSIX process group:
    a non-zero exit raises, and at the timeout the launcher and every rank
    are killed together. Returns the wall seconds."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), str(Path(__file__).resolve()), "--ddp-child",
           *map(str, child_args)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent),
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc is None:
        raise AssertionError(f"{phase}: the ranks did not end within "
                             f"{timeout} s (killed)")
    if rc:
        raise AssertionError(f"{phase}: torch.distributed.run exited {rc}")
    return time.perf_counter() - t0


def rank_results(out, world):
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def standin_tokenizers():
    """The stand-in tokenizers patched into the aligners' classes, as a
    context (there are no tokenizer files): flan-t5's 32128 ids through a
    stand-in, and the VLM ids decoded by the stand-in the engine served
    with."""
    from contextlib import ExitStack
    from unittest import mock

    from thinkdiff_torch.engines.standin_tokenizer import StandInTokenizer
    from thinkdiff_torch.models.aligner_clip import BlipVisionT5Decoder
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder

    t5_tok = clip_t5_tokenizer()
    vlm_decode = StandInTokenizer().decode
    stack = ExitStack()
    for cls, name, fn in (
            (MllamaT5EmbedDecoder, "get_t5_tokenizer", lambda self: t5_tok),
            (MllamaT5EmbedDecoder, "get_vlm_decode_fn",
             lambda self: vlm_decode),
            (BlipVisionT5Decoder, "get_t5_tokenizer", lambda self: t5_tok)):
        stack.enter_context(mock.patch.object(cls, name, fn))
    return stack


def ddp_child(argv):
    """One rank, started by launch_ranks: ``train OUT [--nccl-group]
    [--profile] -- <train CLI argv>`` or ``stage1 OUT INDEX EMBED_DIR``.
    Writes OUT/rank{r}.json."""
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                          % torch.cuda.device_count())
    mode, out = argv[0], Path(argv[1])
    out.mkdir(parents=True, exist_ok=True)
    if mode == "train":
        split = argv.index("--")
        result = ddp_child_train(argv[2:split], argv[split + 1:])
    elif mode == "stage1":
        result = ddp_child_stage1(*argv[2:])
    else:
        raise ValueError(f"unknown --ddp-child mode {mode}")
    (out / f"rank{result['rank']}.json").write_text(json.dumps(result))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def ddp_child_train(flags, train_argv):
    """thinkdiff_torch.train.main(train_argv) on this rank, each step's
    loss, gradient norm and lr recorded, the launch counters set to 0 just
    before and read just after. Flags: --nccl-group (the rank first makes
    an NCCL process group itself; init_distributed_mode then uses it),
    --dump DIR (each host batch the trainer takes is saved there, for the
    world-1 reference), --profile-step N (step N runs under
    torch.profiler)."""
    import argparse

    import torch.distributed as dist

    from thinkdiff_torch import kernels, train
    from thinkdiff_torch.core import distributed as td
    from thinkdiff_torch.engines.trainer import Trainer

    parser = argparse.ArgumentParser()
    parser.add_argument("--nccl-group", action="store_true")
    parser.add_argument("--dump", default=None)
    parser.add_argument("--profile-step", type=int, default=0)
    opts = parser.parse_args(flags)
    if opts.nccl_group:
        dist.init_process_group("nccl", device_id=torch.device(
            "cuda", torch.cuda.current_device()))
    record, profile = [], {}
    step, prepare = Trainer.train_step, Trainer.prepare_batch

    def recorded(self, state, batch, rng=None):
        prof = None
        if len(record) + 1 == opts.profile_step:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        t = time.perf_counter()
        state, m = step(self, state, batch, rng)
        if prof is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            prof.stop()
            profile.update(allreduce_share(prof, wall_ms))
        record.append({"step": state["step"], "lr": m["lr"],
                       "loss": m["loss"], "grad_norm": m["grad_norm"],
                       "t": t})
        return state, m

    def dumped(self, batch):
        path = Path(opts.dump) / (f"rank{os.environ.get('RANK', '0')}_"
                                  f"{len(record):03d}.npz")
        np.savez(path, **batch)
        return prepare(self, batch)

    Trainer.train_step = recorded
    if opts.dump:
        Path(opts.dump).mkdir(parents=True, exist_ok=True)
        Trainer.prepare_batch = dumped
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with standin_tokenizers(), CapturedLog(
                "thinkdiff_torch.data.builders", CC_SBU_LOG) as data_log:
            runner = train.main(train_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        Trainer.train_step, Trainer.prepare_batch = step, prepare
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = runner.iters_per_epoch
    # the gaps between step starts within an epoch (the profiled step, if
    # the last, starts the last gap and so lengthens none)
    gaps = [b["t"] - a["t"] for a, b in zip(record, record[1:])
            if b["step"] % iters != 1]
    return {
        "rank": td.get_rank(), "world": td.get_world_size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(runner.trainer.device), "wall_s": wall,
        "steps": [r["step"] for r in record], "lrs": [r["lr"] for r in record],
        "losses": [float(r["loss"]) for r in record],
        "grad_norms": [float(r["grad_norm"]) for r in record],
        "step_ms": statistics.median(gaps) * 1e3 if gaps else None,
        "peak_gib": peak, "launches": launches, "profile": profile or None,
        "output_dir": str(runner.output_dir), "data_path": data_log.lines,
        "t5_layers": [runner.model.t5_cfg.num_layers,
                      runner.model.t5_cfg.num_decoder_layers]}


def allreduce_share(prof, wall_ms):
    """From one profiled step: the longest host span of the gradient
    all-reduce (gloo: the collective with its copies through the host and
    the wait for the other rank) against the step's wall ms, and the
    device time of NCCL's all-reduce kernels."""
    from torch.autograd import DeviceType

    host, device_ms = {}, 0.0
    for e in prof.events():
        name = e.name.lower()
        if "allreduce" not in name and "all_reduce" not in name:
            continue
        if e.device_type == DeviceType.CUDA:
            device_ms += e.time_range.elapsed_us() / 1e3
        else:
            host[e.name] = max(host.get(e.name, 0.0),
                               e.time_range.elapsed_us() / 1e3)
    ar_ms = max(host.values()) if host else None
    return {"wall_ms": wall_ms, "allreduce_ms": ar_ms,
            "allreduce_device_ms": device_ms, "events": sorted(host),
            "share": ar_ms / wall_ms if ar_ms is not None else None}


def ddp_child_stage1(index, embed_dir):
    """The precompute CLI's bootstrap, task and runner_process_data over
    configs/qwen2_vl_embed_ccsbu.yaml as written on this rank, its own
    seeded 2B engine on its card (the cli phase's stop lengths and shard
    size); its shards checked, one sample read back through the
    teacher-forced check."""
    import torch.distributed as dist

    from thinkdiff_torch import kernels
    from thinkdiff_torch.core import distributed as td
    from thinkdiff_torch.data.wids_reader import ShardListDataset
    from thinkdiff_torch.scripts.common import (
        bootstrap, build_runner, parse_args)
    from thinkdiff_torch.tasks import image_text_process_data

    args = parse_args("stage 1", [
        "--cfg-path", str(CONFIG), "--options",
        f"datasets.cc_sbu_mllama_vllm_process_wids.build_info.storage={index}",
        f'run.output_shard_path=["{embed_dir}", "%06d.tar", 0]'])
    run_cfg, task = bootstrap(args)
    rank = td.get_rank()
    base_cfg, cfg, params = load_weights()
    model = build_model(base_cfg, cfg, params, {})
    runner = build_runner(run_cfg, task, model, task.build_datasets(run_cfg),
                          None, "runner_process_data")
    lengths = stop_lengths(CLI_IMAGES, SEED + 1)
    model.engine.stop_len_fn = lambda req, m: m >= lengths[req]
    image_text_process_data.SHARD_MAXSIZE = CLI_SHARD_BYTES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = runner.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.engine.stop_len_fn = None
    tars = sorted(p for p in Path(embed_dir).glob("*.tar")
                  if int(p.stem) // 100000 == rank)
    n, last, keys = check_embed_shards(tars, cfg.hidden_size,
                                       expect=stats["num_samples"])
    out = {"prompt_token_ids": [last["json"]["input_prompt_token_ids"]],
           "output_token_ids": [last["json"]["output_token_ids"]],
           "prompt_hidden_states": [last["input"]],
           "hidden_states": [last["output"]]}
    teacher_forcing_check(f"ddp rank {rank}", model.engine, out,
                          [ShardListDataset(index)[int(last["__key__"])][
                              "jpg"]], 0)
    return {"rank": rank, "world": td.get_world_size(),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "stats": stats, "wall_s": wall, "imgs_per_s": n / wall,
            "launches": launches, "keys": keys,
            "tars": [p.name for p in tars], "peak_gib": peak}


def concat_padded(parts):
    """The ranks' host batches as one global batch: each array padded at
    the end of every axis but the first to the widest rank's (labels with
    -100, everything else with 0: ignored labels and masked condition
    rows, which change no loss), then concatenated."""
    out = {}
    for k in parts[0]:
        arrs = [np.asarray(p[k]) for p in parts]
        width = np.max([a.shape for a in arrs], axis=0)
        fill = -100 if k == "labels" else 0
        arrs = [np.pad(a, [(0, 0)] + [(0, int(w - s)) for w, s in
                                      zip(width[1:], a.shape[1:])],
                       constant_values=fill) for a in arrs]
        out[k] = np.concatenate(arrs)
    return out


def ddp_reference(argv, dump, world):
    """What GSPMD computes over a data axis of ``world``: the training
    CLI's bootstrap, task, model and Trainer in this process (a world of
    one), each step fed the concatenation of the batches the ``world``
    ranks took at that step (``dump``, saved by the ranks). Returns each
    step's loss and gradient norm, and the projector before and after."""
    from thinkdiff_torch.core.optim import tree_leaves
    from thinkdiff_torch.engines.trainer import Trainer
    from thinkdiff_torch.scripts.common import bootstrap, parse_args

    cfg, task = bootstrap(parse_args("ddp reference", argv))
    model = task.build_model(cfg)
    trainer = Trainer(model, cfg.run_cfg, device=model.device)
    state = trainer.init_state()
    init = {k: t.detach().cpu().clone() for k, t in tree_leaves(state["params"])}
    steps = len(list(Path(dump).glob("rank0_*.npz")))
    losses, norms, rows = [], [], []
    for i in range(steps):
        parts = []
        for r in range(world):
            with np.load(Path(dump) / f"rank{r}_{i:03d}.npz") as f:
                parts.append(dict(f))
        host = concat_padded(parts)
        rows.append(int(host["labels"].shape[0]))
        state, m = trainer.train_step(state, trainer.prepare_batch(host),
                                      int(cfg.run_cfg.seed))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    final = {k: t.detach().cpu().clone()
             for k, t in tree_leaves(state["params"])}
    return {"losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in norms], "rows": rows,
            "init": init, "final": final}


def ddp_compare(phase, ranks, ref, ckpt):
    """The ranks against the world-1 run on the concatenated batches:
    every rank reports the same global losses and gradient norms; each
    step's loss within DDP_LOSS_TOL relative and gradient norm within
    DDP_NORM_RATIO; the projector rank 0 saved, leaf by leaf, cosine >=
    DDP_COSINE and norm ratio in DDP_NORM_RATIO (the update from the
    common start is printed beside)."""
    first = ranks[0]
    for r in ranks[1:]:
        if r["losses"] != first["losses"] or \
                r["grad_norms"] != first["grad_norms"]:
            raise AssertionError(f"{phase}: ranks disagree: {r['losses']} "
                                 f"vs {first['losses']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(first["losses"], ref["losses"])]
    ratio = [a / b for a, b in zip(first["grad_norms"], ref["grad_norms"])]
    if len(rel) != len(ref["losses"]) or max(rel) > DDP_LOSS_TOL or not all(
            DDP_NORM_RATIO[0] <= x <= DDP_NORM_RATIO[1] for x in ratio):
        raise AssertionError(
            f"{phase}: losses {first['losses']} vs {ref['losses']} (rel "
            f"{rel}), grad norm ratios {ratio}")
    got = torch.load(ckpt, weights_only=True)["model"]
    cos = {k: cosine(got[k], ref["final"][k]) for k in ref["final"]}
    norm = {k: float(got[k].double().norm() / ref["final"][k].double().norm())
            for k in ref["final"]}
    upd = {k: cosine(got[k] - ref["init"][k], ref["final"][k] - ref["init"][k])
           for k in ref["final"]}
    if min(cos.values()) < DDP_COSINE or not all(
            DDP_NORM_RATIO[0] <= x <= DDP_NORM_RATIO[1] for x in norm.values()):
        raise AssertionError(f"{phase}: projector cosines {cos}, norm "
                             f"ratios {norm}")
    say(phase, f"against the world-1 run on the concatenated batches "
        f"({ref['rows'][0]} rows a step): losses max rel err {max(rel):.3g} "
        f"(<= {DDP_LOSS_TOL}); gradient norm ratio {min(ratio):.6f}-"
        f"{max(ratio):.6f}; projector cosine min {min(cos.values()):.6f} "
        f"(>= {DDP_COSINE}), norm ratio {min(norm.values()):.6f}-"
        f"{max(norm.values()):.6f} over {len(cos)} leaves; the update's "
        f"cosine min {min(upd.values()):.6f}")


def ddp_train(phase, out, world, flags, argv, timeout=DDP_TIMEOUT):
    """The training CLI's main on ``world`` ranks through the launcher:
    the ranks' results."""
    wall = launch_ranks(phase, world, ["train", out, *flags, "--", *argv],
                        timeout)
    ranks = rank_results(out, world)
    for r in ranks:
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"{phase} rank {r['rank']}: {r['losses']}")
    say(phase, f"{world} rank(s), {ranks[0]['backend'] or 'no process group'}"
        f", launched and ended in {wall:.1f} s; per rank: " + "; ".join(
            f"rank {r['rank']} on {r['device']}: {len(r['losses'])} steps in "
            f"{r['wall_s']:.1f} s, {r['step_ms']:.0f} ms a step (median gap "
            f"within an epoch), peak {r['peak_gib']:.2f} GiB" for r in ranks)
        + "; global losses " + " ".join(f"{x:.4f}" for x in ranks[0]["losses"]))
    return ranks


def ddp_stage2(stage1, stage2):
    """Stage 2 of the cli phase (the training YAML as written, 2B width,
    its shards, 2 epochs of 4 steps) on more than one rank: at world 1
    under the launcher with an NCCL group of one (bit for bit the cli
    phase's run), at two ranks on the one card over gloo against the
    world-1 run on the concatenated batches, resumed at two ranks, and at
    two cards over NCCL where there are two."""
    storage = f"{stage1['dir']}/{{000000..{stage1['tars'] - 1:06d}}}.tar"
    opts = ["--cfg-path", str(TRAIN_CONFIG), "--options",
            "model.mllama_pretrained_model_name_or_path=Qwen/Qwen2-VL-2B-Instruct",
            f"datasets.llava_instruct_mllama_embed_2.build_info.storage={storage}",
            "run.max_epoch=2", "run.iters_per_epoch=4"]
    # world 1, an NCCL group of one: bit for bit the cli phase's run
    w1 = ddp_train("ddp world-1", DDP_DIR / "w1", 1, ["--nccl-group"],
                   opts + [f"run.output_dir={DDP_DIR / 'w1'}", "--job-id",
                           "w1"])[0]
    if w1["backend"] != "nccl" or w1["losses"] != stage2["losses"]:
        raise AssertionError(f"ddp world-1: {w1['backend']}, losses "
                             f"{w1['losses']} vs {stage2['losses']}")
    a = torch.load(stage2["dir"] / "checkpoint_1.pth", weights_only=True)
    b = torch.load(DDP_DIR / "w1" / "w1" / "checkpoint_1.pth",
                   weights_only=True)
    if sorted(a["model"]) != sorted(b["model"]) or not all(
            torch.equal(a["model"][k], b["model"][k]) for k in a["model"]):
        raise AssertionError("ddp world-1: the projector differs from the "
                             "cli phase's")
    same = {k: (w1["launches"][k], stage2["launches"][k])
            for k in CLI_STAGE2_KERNELS}
    if any(x != y for x, y in same.values()):
        raise AssertionError(f"ddp world-1: launches {same}")
    say("ddp world-1", f"NCCL group of one: losses and projector bit for bit "
        f"the cli phase's run without a launcher; launches equal {same}")

    # two ranks on the one card (gloo), no --job-id: rank 0's id for both;
    # the last step profiled
    out = DDP_DIR / "gloo"
    ranks = ddp_train("ddp gloo", out, DDP_WORLD, [
        "--dump", out / "batches", "--profile-step", 8],
        opts + [f"run.output_dir={out}"])
    ref = ddp_reference(opts + [f"run.output_dir={DDP_DIR / 'ref'}"],
                        out / "batches", DDP_WORLD)
    torch.cuda.empty_cache()
    jobs = [p for p in out.iterdir() if p.is_dir() and p.name != "batches"]
    if len(jobs) != 1 or len({r["output_dir"] for r in ranks}) != 1:
        raise AssertionError(f"ddp gloo: job directories {jobs}")
    job = jobs[0]
    written = sorted(p.name for p in job.iterdir())
    if written != ["checkpoint_0.config.json", "checkpoint_0.pth",
                   "checkpoint_1.config.json", "checkpoint_1.pth", "log.txt",
                   "result"]:
        raise AssertionError(f"ddp gloo: {job} holds {written}")
    ddp_compare("ddp gloo", ranks, ref, job / "checkpoint_1.pth")
    missing = [(r["rank"], k) for r in ranks for k in CLI_STAGE2_KERNELS
               if r["launches"][k] == 0]
    if missing or any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"ddp gloo: backends "
                             f"{[r['backend'] for r in ranks]}, not launched "
                             f"{missing}")
    for r in ranks:
        p = r["profile"]
        say("ddp gloo", f"rank {r['rank']} profiled step 8: "
            f"{p['wall_ms']:.1f} "
            f"ms, of which the gradient all-reduce "
            + (f"{p['allreduce_ms']:.1f} ms ({p['share']:.0%}; events "
               f"{p['events']})" if p["allreduce_ms"] is not None
               else "not found in the trace"))

    # resumed on two ranks from the checkpoint rank 0 wrote
    res = DDP_DIR / "resumed"
    resumed = ddp_train("ddp resume", res, DDP_WORLD, [], opts + [
        f"run.output_dir={res}",
        f"run.resume_ckpt_path={job / 'checkpoint_0.pth'}", "--job-id",
        "resumed"])
    again = ranks[0]
    for r in resumed:
        if r["steps"] != again["steps"][4:] or r["lrs"] != again["lrs"][4:] \
                or max(abs(x - y) / abs(y) for x, y in zip(
                    r["losses"], again["losses"][4:])) > DDP_LOSS_TOL:
            raise AssertionError(f"ddp resume rank {r['rank']}: steps "
                                 f"{r['steps']} losses {r['losses']} vs "
                                 f"{again['losses'][4:]}")
    ca = torch.load(job / "checkpoint_1.pth", weights_only=True)["model"]
    cb = torch.load(res / "resumed" / "checkpoint_1.pth",
                    weights_only=True)["model"]
    cos = min(cosine(ca[k], cb[k]) for k in ca)
    if cos < DDP_COSINE:
        raise AssertionError(f"ddp resume: projector cosine {cos}")
    say("ddp resume", f"both ranks resumed from checkpoint_0.pth: steps "
        f"{resumed[0]['steps']}, lr equal, losses within {DDP_LOSS_TOL} of "
        f"the straight run's epoch 1, projector cosine min {cos:.6f}")
    nccl2 = None
    if torch.cuda.device_count() >= DDP_WORLD:
        out2 = DDP_DIR / "nccl"
        nccl2 = ddp_train("ddp nccl", out2, DDP_WORLD, [],
                          opts + [f"run.output_dir={out2}", "--job-id", "n"])
        if any(r["backend"] != "nccl" for r in nccl2):
            raise AssertionError("ddp nccl: not NCCL")
        ddp_compare("ddp nccl", nccl2, ref, out2 / "n" / "checkpoint_1.pth")
    return {"w1": w1, "gloo": ranks, "resumed": resumed, "nccl": nccl2}


def ddp_stage1(stage1):
    """Stage 1 at two ranks on the cli phase's JPEGs: each rank its own 2B
    engine on the card, 256 slots as written; the shard ranges disjoint
    (rank r from r x 100000 on), every sample of the world-1 run once,
    every embedding checked, one sample a rank read back, #1-#4 launched
    on each rank."""
    embed = DDP_DIR / "embed"
    wall = launch_ranks("ddp stage 1", DDP_WORLD, [
        "stage1", DDP_DIR / "stage1", stage1["index"], embed])
    ranks = rank_results(DDP_DIR / "stage1", DDP_WORLD)
    keys = [k for r in ranks for k in r["keys"]]
    starts = [{int(Path(t).stem) // 100000 for t in r["tars"]} for r in ranks]
    if len(keys) != len(set(keys)) or set(keys) != set(stage1["keys"]) or \
            starts != [{r} for r in range(DDP_WORLD)]:
        raise AssertionError(f"ddp stage 1: {len(keys)} keys ({len(set(keys))}"
                             f" distinct, world-1 {len(stage1['keys'])}), "
                             f"shards {[r['tars'] for r in ranks]}")
    missing = [(r["rank"], k) for r in ranks for k in CLI_STAGE1_KERNELS
               if r["launches"][k] == 0]
    if missing:
        raise AssertionError(f"ddp stage 1: not launched {missing}")
    n, _, _ = check_embed_shards(sorted(embed.glob("*.tar")),
                                 stage1["width"])
    say("ddp stage 1", f"{DDP_WORLD} ranks ({ranks[0]['backend']}) in "
        f"{wall:.1f} s: " + "; ".join(
            f"rank {r['rank']} {r['stats']['num_samples']} samples into "
            f"{r['tars']} in {r['wall_s']:.1f} s ({r['imgs_per_s']:.2f} "
            f"imgs/s), peak {r['peak_gib']:.2f} GiB" for r in ranks)
        + f"; {n} samples, disjoint, the world-1 run's keys each once")
    return ranks


def phase_ddp(stage1, stage2):
    """Stages 1 and 2 of the cli phase over several ranks, through
    ``python -m torch.distributed.run`` and the CLIs' entry points, each
    rank in a process of its own (chip_smoke.py --ddp-child)."""
    import shutil

    shutil.rmtree(DDP_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    try:
        train = ddp_stage2(stage1, stage2)
        torch.cuda.empty_cache()
        first = ddp_stage1(stage1)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    return {"train": train, "stage1": first}


def phase_ddp_clip(storage):
    """ThinkDiff-CLIP's training YAML at two ranks on the one card (gloo)
    on clip-train's shards, CLIP_DDP_STEPS steps, both T5 stacks cut to
    CLIP_DDP_T5_LAYERS layers, against the world-1 run on the concatenated
    batches at the same depth."""
    import shutil

    out = DDP_DIR / "clip"
    opts = ["--cfg-path", str(CLIP_TRAIN_CONFIG), "--options",
            f"datasets.cc_sbu.build_info.storage={storage}",
            "run.max_epoch=1", f"run.iters_per_epoch={CLIP_DDP_STEPS}",
            f"model.t5_config.num_layers={CLIP_DDP_T5_LAYERS}",
            f"model.t5_config.num_decoder_layers={CLIP_DDP_T5_LAYERS}"]
    say("ddp clip", f"the CLIP YAML cut for two ranks on one card: flan-t5-"
        f"xxl encoder and decoder {CLIP_DDP_T5_LAYERS} + "
        f"{CLIP_DDP_T5_LAYERS} layers (of 24 + 24), widths and ViT-g as "
        f"written, {CLIP_DDP_STEPS} steps")
    try:
        ranks = ddp_train("ddp clip", out, DDP_WORLD, [
            "--dump", out / "batches"], opts + [
            f"run.output_dir={out}", "--job-id", "clip"])
        ref = ddp_reference(opts + [f"run.output_dir={out / 'ref'}"],
                            out / "batches", DDP_WORLD)
        if ranks[0]["t5_layers"] != [CLIP_DDP_T5_LAYERS] * 2:
            raise AssertionError(f"ddp clip: T5 {ranks[0]['t5_layers']}")
        ddp_compare("ddp clip", ranks, ref, out / "clip" / "checkpoint_0.pth")
        missing = [(r["rank"], k) for r in ranks for k in CLIP_TRAIN_KERNELS
                   if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"ddp clip: not launched {missing}")
        for r in ranks:
            check_data_path(f"ddp clip rank {r['rank']}", r["data_path"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return ranks


# ---------------------------------------------------------------------------
# The modules of the last slice: native IO, SmoothQuant calibration, the
# CoBSAT scorer, Llama with LoRA
# ---------------------------------------------------------------------------

NATIVE_IMAGES = 256
NATIVE_SIZE = 224
# JAX's bounds for the C++ decode against the PIL processor
# (tests/test_native_io.py): per image, median |diff| and correlation
NATIVE_MEDIAN_MAX, NATIVE_CORR_MIN = 0.05, 0.99
# a cc_sbu loader's log line that names the path it took
CC_SBU_LOG = "cc_sbu:"


def jpeg_toolchain():
    """None when g++ compiles against jpeglib.h and ldconfig lists
    libjpeg (the native library can build here), else the reason."""
    src = "#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
    try:
        cc = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                            input=src, capture_output=True, text=True,
                            timeout=60)
        libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                              text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"
    if cc.returncode != 0:
        err = [x for x in cc.stderr.splitlines() if "error" in x] or [
            cc.stderr.strip()]
        return err[0].replace("<stdin>:3:10: ", "")[:200]
    if "libjpeg.so" not in libs:
        return "ldconfig lists no libjpeg.so"
    return None


def native_expected(phase):
    """Whether the native IO library must be taken on this machine: it
    must when the JPEG toolchain is here (then a library that fails to
    build fails the phase); otherwise the phase prints why it is
    unavailable and checks the decoded path only."""
    from thinkdiff_torch.data import native

    missing = jpeg_toolchain()
    if native.available():
        say(phase, f"native IO library {native.library_path().name} (g++ "
            f"{' '.join(native.CXX_FLAGS + native.LINK_FLAGS)})")
        return True
    if missing is None:
        raise AssertionError(f"{phase}: jpeglib.h and libjpeg are here but "
                             f"the native library is unavailable: "
                             f"{native.unavailable_reason()}")
    say(phase, f"native: unavailable ({missing}; "
        f"{native.unavailable_reason()})")
    return False


def check_data_path(phase, lines):
    """The cc_sbu loaders' log lines of a run: at least one, and each the
    native path when the library is available here (the decoded path
    otherwise). Prints and returns the first."""
    from thinkdiff_torch.data import native

    want = ("native JPEG decode" if native.available()
            else "decoded-sample path")
    if not lines or not all(want in x for x in lines):
        raise AssertionError(f"{phase}: cc_sbu loaders took {lines}, "
                             f"expected the {want}")
    say(phase, f"{len(lines)} cc_sbu loader(s): {lines[0]}")
    return lines[0]


class CapturedLog(logging.Handler):
    """The messages of ``logger`` that start with ``prefix``, while open."""

    def __init__(self, logger, prefix):
        super().__init__(logging.INFO)
        self.logger, self.prefix, self.lines = (logging.getLogger(logger),
                                                prefix, [])

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.prefix):
            self.lines.append(msg)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def phase_native(index):
    """The C++ batch decode (``data/native.py``) on NATIVE_IMAGES of the cli
    phase's 448x448 JPEGs to NATIVE_SIZE², against the PIL processor
    (BlipImageEvalProcessor) image for image within JAX's bounds, and both
    paths' images a second. Returns its record."""
    import io

    from PIL import Image

    from thinkdiff_torch.data import native
    from thinkdiff_torch.data.processors import (
        CLIP_MEAN, CLIP_STD, BlipImageEvalProcessor)
    from thinkdiff_torch.data.wids_reader import ShardListDataset

    ds = ShardListDataset(index, decode=False)
    jpegs = [ds[i]["jpg"] for i in range(NATIVE_IMAGES)]
    record = {"native": native_expected("native"), "images": len(jpegs)}
    proc = BlipImageEvalProcessor(image_size=NATIVE_SIZE)
    t0 = time.perf_counter()
    plain = [proc(Image.open(io.BytesIO(j))) for j in jpegs]
    plain_s = time.perf_counter() - t0
    record["pil_imgs_per_s"] = len(jpegs) / plain_s
    if not record["native"]:
        say("native", f"PIL processor (one thread): {len(jpegs)} images in "
            f"{plain_s:.2f} s, {record['pil_imgs_per_s']:.1f} imgs/s")
        return record
    native.decode_resize_normalize_batch(jpegs[:8], NATIVE_SIZE, CLIP_MEAN,
                                         CLIP_STD)  # warm
    t0 = time.perf_counter()
    got = native.decode_resize_normalize_batch(jpegs, NATIVE_SIZE, CLIP_MEAN,
                                               CLIP_STD)
    native_s = time.perf_counter() - t0
    record["native_imgs_per_s"] = len(jpegs) / native_s
    med, corr = [], []
    for i, ref in enumerate(plain):
        ref = np.asarray(ref)
        med.append(float(np.median(np.abs(got[i] - ref))))
        corr.append(float(np.corrcoef(got[i].ravel(), ref.ravel())[0, 1]))
    record.update(median_max=max(med), corr_min=min(corr))
    say("native", f"{len(jpegs)} JPEGs of 448² to {NATIVE_SIZE}²: C++ batch "
        f"decode (8 threads) {native_s:.3f} s = "
        f"{record['native_imgs_per_s']:.1f} imgs/s, PIL processor (one "
        f"thread) {plain_s:.2f} s = {record['pil_imgs_per_s']:.1f} imgs/s; "
        f"against PIL per image: median |diff| <= {max(med):.4f} (limit "
        f"{NATIVE_MEDIAN_MAX}), correlation >= {min(corr):.5f} (limit "
        f"{NATIVE_CORR_MIN})")
    if got.shape != (len(jpegs), NATIVE_SIZE, NATIVE_SIZE, 3) or not (
            np.isfinite(got).all() and max(med) < NATIVE_MEDIAN_MAX
            and min(corr) > NATIVE_CORR_MIN):
        raise AssertionError(f"native: the C++ decode disagrees with PIL "
                             f"{got.shape} {max(med)} {min(corr)}")
    return record


CALIBRATE_BATCHES = 4


def phase_calibrate():
    """SmoothQuant calibration of the w8a8 flan-t5-xxl decoder as
    train-w8a8 builds it (full width and depth, fused projections):
    ``calibrate_w8a8`` over CALIBRATE_BATCHES of bench.py's packed 4 x
    256/256 batches, its launches (counts set to 0 just before), how many
    ``input_scale``s changed, the seconds; the loss of one batch before and
    after; then the gradient check on a 2-layer copy calibrated the same
    way (the equalized tower's loss and projector gradients through the
    kernels against the CPU's plain versions). Returns (launches, rates)."""
    from thinkdiff_torch import kernels
    from thinkdiff_torch.data.synthetic import build_batches_packed
    from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder
    from thinkdiff_torch.models.bridge import flatten, tree_of

    model_cfg, _ = train_config(BENCH_OVERRIDES)
    model = MllamaT5EmbedDecoder(model_cfg, seed=SEED)
    host, _ = build_batches_packed(np.random.RandomState(SEED + 40),
                                   CALIBRATE_BATCHES, BENCH_ROWS, BENCH_CAP,
                                   BENCH_CAP, model.vlm_hidden,
                                   model.t5_cfg.vocab_size)
    dev = lambda b: {k: torch.from_numpy(v).to(model.device)
                     for k, v in b.items()}
    scales = lambda: {k: v.clone() for k, v in flatten(tree_of(
        model.frozen["t5"], lambda _, t: t)).items()
        if k.endswith("input_scale")}
    with torch.no_grad():
        loss0 = float(model.loss_fn(model.trainable, model.frozen,
                                    dev(host[0])))
    before = scales()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.calibrate_w8a8(host)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    after = scales()
    with torch.no_grad():
        loss1 = float(model.loss_fn(model.trainable, model.frozen,
                                    dev(host[0])))
    changed = sum(not torch.equal(after[k], before[k]) for k in before)
    ranges = torch.cat([v for v in after.values()])
    say("calibrate", f"calibrate_w8a8 over {CALIBRATE_BATCHES} packed "
        f"batches ({BENCH_ROWS} x {BENCH_CAP}/{BENCH_CAP}): {seconds:.2f} s; "
        f"{changed} of {len(before)} input_scales changed (range "
        f"{float(ranges.min()):.4g}-{float(ranges.max()):.4g}); loss of "
        f"batch 0 {loss0:.6f} -> {loss1:.6f}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in ("flash_attention_fwd", "s8_matmul", "rmsnorm")
               if launches[k] == 0]
    if missing or changed == 0 or not (np.isfinite(loss1)
                                       and torch.isfinite(ranges).all()):
        raise AssertionError(f"calibrate: not launched {missing}, "
                             f"{changed} scales changed, loss {loss1}")
    del model
    torch.cuda.empty_cache()
    rel, cos = gradient_check(model_cfg, host[0], calibrate=host,
                              phase="calibrate")
    return launches, {"seconds": seconds, "changed": changed,
                      "scales": len(before), "loss": (loss0, loss1),
                      "grad_rel": rel, "grad_cos": cos}


def mha_p_bf16(q, k, v, bias=None, kv_mask=None, causal=False,
               sm_scale=None, q_segment_ids=None, kv_segment_ids=None):
    """``mha_reference`` with the softmax probabilities rounded to bf16
    before the PV product, as the flash kernel rounds them: a yardstick of
    how far that rounding alone moves a deep forward."""
    from thinkdiff_torch.ops import flash_attention as fa

    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    ok = fa._allowed(q, k, kv_mask, causal, q_segment_ids, kv_segment_ids)
    p = torch.softmax(fa._scores(q, k, bias, ok, sm_scale), dim=-1)
    v = fa._repeat_kv(v, q.shape[1])
    return torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                        v.float()).to(q.dtype)


def sdpa_attention(q, k, v, bias=None, kv_mask=None, causal=False,
                   sm_scale=None, q_segment_ids=None, kv_segment_ids=None):
    """PyTorch's ``scaled_dot_product_attention`` at a call site of the
    flash forward (no kv_mask or segments): a library attention, used here
    only as a yardstick of how far another correct attention moves a deep
    forward and backward from the plain version."""
    import torch.nn.functional as F

    if kv_mask is not None or q_segment_ids is not None:
        raise ValueError("sdpa_attention: no kv_mask or segments")
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=None if bias is None else bias.to(q.dtype),
        is_causal=causal, scale=sm_scale)


COBSAT_IMAGES = 32
COBSAT_LABELS = 8          # candidates of each of the two variables
# the embeddings through the kernels against the plain attention: the
# limit of the ViT-g tokens check (CLIP_VIT_COS_MIN). Every flash
# call is also held against mha_reference on its own inputs. The phase
# prints two yardsticks beside it: a plain version that rounds P to bf16
# as the kernel does, and PyTorch's SDPA against the plain attention
COBSAT_COS_MIN = CLIP_VIT_COS_MIN


def cobsat_scorer():
    """CLIP-L at full width, bf16, seeded N(0, 0.02) weights on the card:
    ViT-L/14 at 224 (24 x 1024, 16 heads of 64), the text encoder (12 x
    768), both projections to 768; the CLIP stand-in tokenizer."""
    from thinkdiff_torch.models.clip_scorer import CLIPScorer
    from thinkdiff_torch.models.clip_text import CLIPTextConfig
    from thinkdiff_torch.models.vit import ViTConfig, init_vit_

    scorer = CLIPScorer(ViTConfig.clip_vit_l(dtype=torch.bfloat16),
                        CLIPTextConfig.clip_l(dtype=torch.bfloat16),
                        tokenizer=ClipStandInTokenizer())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    init_vit_(scorer.vision, gen)
    init_random_(scorer.text, gen)
    for p in (scorer.visual_projection, scorer.text_projection):
        p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    return scorer


def phase_cobsat():
    """The CoBSAT scorer on COBSAT_IMAGES seeded 448x448 images against 2 x
    COBSAT_LABELS templated candidates: launches (counts set to 0 just
    before), the embeddings and similarities against the same towers with
    the plain attention (mha_reference at both call sites): every
    embedding's cosine >= COBSAT_COS_MIN and the argmaxes identical; then
    ``score_cobsat.main`` on PNGs the phase writes (the scorer patched in
    where the weights would be read). Returns (launches, rates)."""
    from unittest import mock

    from thinkdiff_torch import kernels
    from thinkdiff_torch.models import clip_scorer as cs
    from thinkdiff_torch.models import clip_text as text_mod
    from thinkdiff_torch.models import vit as vit_mod
    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)
    from thinkdiff_torch.scripts import score_cobsat

    scorer = cobsat_scorer()
    worst = {"calls": 0, "ratio": 0.0}

    def checked(q, k, v, *a):
        o = flash_attention(q, k, v, *a)
        ref = mha_reference(q, k, v, *a).float()
        worst["calls"] += 1
        worst["ratio"] = max(worst["ratio"], float(
            ((o.float() - ref).abs() / (2e-2 + 2e-2 * ref.abs())).max()))
        return o

    images, _ = requests(COBSAT_IMAGES, SEED + 51)
    latent = [f"object{i}" for i in range(COBSAT_LABELS)]
    explicit = [f"color{i}" for i in range(COBSAT_LABELS)]
    texts = [f"a photo of {c}" for c in latent + explicit]
    pixels = [cs.preprocess_clip_image(im) for im in images]
    scorer.encode_images(pixels[:2])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    emb_i, emb_t = scorer.encode_images(pixels), scorer.encode_texts(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    def both(attention):
        with mock.patch.object(vit_mod, "flash_attention", attention), \
                mock.patch.object(text_mod, "flash_attention", attention):
            return scorer.encode_images(pixels), scorer.encode_texts(texts)

    both(checked)
    ref_i, ref_t = both(mha_reference)
    rowcos = lambda a, b: (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                              * np.linalg.norm(b, axis=-1))
    mincos = lambda a, b: float(min(rowcos(a[0], b[0]).min(),
                                    rowcos(a[1], b[1]).min()))
    cos = mincos((emb_i, emb_t), (ref_i, ref_t))
    cos16 = mincos((emb_i, emb_t), both(mha_p_bf16))
    cos_sdpa = mincos(both(sdpa_attention), (ref_i, ref_t))
    sims, ref_sims = emb_i @ emb_t.T, ref_i @ ref_t.T
    delta = float(np.abs(sims - ref_sims).max())
    # an argmax may differ only where the plain version's top two are
    # closer than the similarities moved (a near-tie on seeded weights)
    flips, unexplained = 0, 0
    for sl in (slice(0, COBSAT_LABELS), slice(COBSAT_LABELS, None)):
        for a, b in zip(sims[:, sl], ref_sims[:, sl]):
            if np.argmax(a) != np.argmax(b):
                top2 = np.sort(b)[-2:]
                flips += 1
                unexplained += int(top2[1] - top2[0] > 2 * delta)
    say("cobsat", f"CLIP-L (ViT-L/14 24 x 1024 at 224, text 12 x 768, bf16, "
        f"seeded): {COBSAT_IMAGES} images and {len(texts)} candidates in "
        f"{wall * 1e3:.1f} ms ({COBSAT_IMAGES / wall:.1f} imgs/s with the "
        f"texts); launches {dict((k, v) for k, v in launches.items() if v)}; "
        f"{worst['calls']} flash calls each against mha_reference on its own "
        f"inputs, the worst at {worst['ratio']:.3g} of 2e-2 + 2e-2|ref|; "
        f"embeddings against the plain attention: cosine >= {cos:.6f} (limit "
        f"{COBSAT_COS_MIN}; against a plain version that rounds P to bf16 as "
        f"the kernel does: {cos16:.6f}; SDPA against the plain attention: "
        f"{cos_sdpa:.6f}); similarities within {delta:.2e}; "
        f"{flips} of {2 * COBSAT_IMAGES} argmaxes differ, "
        f"{unexplained} where the plain top two are further apart than 2x "
        f"that")
    if (launches["flash_attention_fwd"] != 24 + 12 or worst["calls"] != 36
            or worst["ratio"] > 1.0 or unexplained or not cos >= COBSAT_COS_MIN
            or not np.isfinite(sims).all()):
        raise AssertionError(f"cobsat: launches {launches}, calls {worst}, "
                             f"cosine {cos}, {unexplained} argmaxes differ")
    # the CLI on PNGs
    import shutil

    out = Path(__file__).resolve().parent / "build" / "cobsat"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    labels = {}
    rs = np.random.RandomState(SEED + 52)
    for i, im in enumerate(images):
        im.save(out / f"case{i:03d}.png")
        labels[f"case{i:03d}"] = {
            "latent": latent[rs.randint(COBSAT_LABELS)],
            "explicit": explicit[rs.randint(COBSAT_LABELS)],
            "latent_candidates": latent, "explicit_candidates": explicit,
            "task": f"task{i % 4}"}
    (out / "labels.json").write_text(json.dumps(labels))
    try:
        with mock.patch.object(cs.CLIPScorer, "from_pretrained",
                               classmethod(lambda cls, *a, **k: scorer)):
            t0 = time.perf_counter()
            res = score_cobsat.main([
                "--images-dir", str(out), "--labels-json",
                str(out / "labels.json"), "--out-json",
                str(out / "result.json")])
            cli_s = time.perf_counter() - t0
        saved = json.loads((out / "result.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    say("cobsat", f"score_cobsat CLI: {res['n']} cases in {cli_s:.2f} s "
        f"({res['n'] / cli_s:.1f} imgs/s, one image a call), accuracy "
        f"{res['overall']:.3f} (seeded weights: no meaning), per task "
        f"{res['per_task']}")
    if res["n"] != COBSAT_IMAGES or res["missing"] or saved["n"] != res["n"]:
        raise AssertionError(f"cobsat: CLI result {res['n']} {res['missing']}")
    return launches, {"imgs_per_s": COBSAT_IMAGES / wall,
                      "cli_imgs_per_s": res["n"] / cli_s}


LORA_R, LORA_B, LORA_T, LORA_STEPS = 8, 4, 512, 4
LORA_KERNELS = ("flash_attention_fwd", "rmsnorm", "flash_attention_dq",
                "flash_attention_dkv")


@torch.no_grad()
def init_llama_(module, gen, std=0.02):
    """Seeded weights in place: kernels and embeddings N(0, std), norm
    weights 1, biases 0."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)


def lora_grads(llama, ids, labels, attention=None, norm=None):
    """(loss, {adapter leaf: gradient}) of one step, with ``attention`` and
    ``norm`` in place of the flash forward and RMSNorm at their call sites
    in models/qwen2_vl.py when given."""
    from contextlib import ExitStack
    from unittest import mock

    from thinkdiff_torch.models import qwen2_vl as q_mod

    leaves = [(f"{k}/{n}", t) for k, layer in llama.adapters.items()
              for n, t in layer.items()]
    with ExitStack() as stack:
        if attention is not None:
            stack.enter_context(mock.patch.object(q_mod, "flash_attention",
                                                  attention))
        if norm is not None:
            stack.enter_context(mock.patch.object(q_mod, "rmsnorm", norm))
        loss = llama(ids, labels=labels)["loss"]
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {n: g.float().cpu()
                                  for (n, _), g in zip(leaves, grads)}


def lora_model(num_layers):
    """Llama-2-7B's geometry in bf16 at ``num_layers`` layers, seeded
    weights, LoRA r LORA_R on q/v (``a`` from its own generator), and a
    seeded batch of B4 T512 whose first eighth of labels is -100."""
    from thinkdiff_torch.models.llama import LlamaForCausalLM, llama_config

    cfg = llama_config(dtype=torch.bfloat16, num_layers=num_layers)
    llama = LlamaForCausalLM(cfg, lora_r=LORA_R, lora_generator=torch.Generator(
        device="cuda").manual_seed(SEED + 60))
    init_llama_(llama.model, torch.Generator(device="cuda").manual_seed(
        SEED + 61))
    rs = np.random.RandomState(SEED + 62)
    ids = torch.from_numpy(rs.randint(1, cfg.vocab_size, (LORA_B, LORA_T)))
    labels = ids.clone()
    labels[:, : LORA_T // 8] = -100
    return llama, ids, labels


def lora_steps(llama, ids, labels, steps):
    """``steps`` AdamW steps (lr 1e-3) on the adapters: (losses, ms a
    step)."""
    leaves = [t.requires_grad_(True) for layer in llama.adapters.values()
              for t in layer.values()]
    opt = torch.optim.AdamW(leaves, lr=1e-3)
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = llama(ids, labels=labels)["loss"]
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
    return losses, step_ms


def lora_diff(got, want):
    """(loss rel, {leaf: cosine}, {leaf: norm ratio}) of two
    ``lora_grads`` results."""
    (lg, gg), (lw, gw) = got, want
    return (abs(lg - lw) / abs(lw), {n: cosine(gg[n], gw[n]) for n in gg},
            {n: float(gg[n].double().norm() / gw[n].double().norm())
             for n in gg})


def phase_lora():
    """Llama-2-7B geometry in bf16 (32 layers, 4096, 11008, vocab 32000),
    seeded weights, LoRA r LORA_R on q/v: the merged model's logits at init
    equal the base's; LORA_STEPS AdamW steps on the adapters at B4 T512
    (launches, counts set to 0 just before; ms a step, peak); the loss and
    adapter gradients through the kernels against the plain versions on
    the card (mha_reference and rmsnorm_reference, autograd through them),
    printed at full depth beside the same comparison of PyTorch's SDPA;
    then the gradient check's protocol, a 2-layer copy at full width after
    the same steps, held within its limits (GRAD_LOSS_TOL, GRAD_COS_MIN,
    GRAD_NORM_RATIO). Returns (launches, rates)."""
    from thinkdiff_torch import kernels
    from thinkdiff_torch.models.lora import lora_param_count
    from thinkdiff_torch.ops.flash_attention import mha_reference
    from thinkdiff_torch.ops.norms import rmsnorm_reference

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llama, ids, labels = lora_model(32)
    cfg = llama.cfg
    torch.cuda.synchronize()
    n_base = sum(p.numel() for p in llama.model.parameters())
    with torch.no_grad():
        base = llama(ids, adapters={})["logits"]
        merged = llama(ids)["logits"]
    if not torch.equal(base, merged):
        raise AssertionError("lora: the merged model at init is not the base")
    del base, merged
    say("lora", f"Llama-2-7B geometry ({cfg.num_layers} x {cfg.hidden_size}, "
        f"ffn {cfg.intermediate_size}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, bf16): {n_base / 1e9:.2f} B "
        f"parameters, LoRA r {LORA_R} on q/v: "
        f"{lora_param_count(llama.adapters)} trainable; built in "
        f"{time.perf_counter() - t0:.1f} s; merged logits at init equal the "
        "base's")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, step_ms = lora_steps(llama, ids, labels, LORA_STEPS)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("lora", f"{LORA_STEPS} AdamW steps on the adapters, B{LORA_B} "
        f"T{LORA_T}: loss " + " ".join(f"{x:.4f}" for x in losses)
        + f"; {statistics.median(step_ms[1:]):.1f} ms a step (median of "
        f"steps 2-{LORA_STEPS}; first {step_ms[0]:.1f}); peak {peak:.2f} GiB; "
        f"launches {dict((k, v) for k, v in launches.items() if v)}")
    missing = [k for k in LORA_KERNELS if launches[k] == 0]
    if missing or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"lora: not launched {missing}, losses {losses}")
    plain = lora_grads(llama, ids, labels, mha_reference, rmsnorm_reference)
    full = {}
    for name, attention in (("kernels", None), ("SDPA", sdpa_attention)):
        rel, cos, _ = lora_diff(lora_grads(llama, ids, labels, attention),
                                plain)
        full[name] = (rel, min(cos.values()))
    say("lora", f"at full depth ({cfg.num_layers} layers), against the plain "
        "versions on the card: "
        + "; ".join(f"{n}: loss rel {r:.2e}, adapter gradient cosine >= "
                    f"{c:.5f}" for n, (r, c) in full.items())
        + " (printed, not held: the gradient check's limits are for its "
        "2-layer copy)")
    del llama
    torch.cuda.empty_cache()
    llama, ids, labels = lora_model(2)
    lora_steps(llama, ids, labels, LORA_STEPS)
    rel, cos, ratio = lora_diff(lora_grads(llama, ids, labels), lora_grads(
        llama, ids, labels, mha_reference, rmsnorm_reference))
    del llama
    torch.cuda.empty_cache()
    lo, hi = GRAD_NORM_RATIO
    worst = min(cos, key=cos.get)
    say("lora", f"gradient check, a 2-layer copy at full width after the same "
        f"{LORA_STEPS} steps, kernels against the plain versions on the card: "
        f"loss rel {rel:.2e} (limit {GRAD_LOSS_TOL:g}); {len(cos)} adapter "
        f"gradients: cosine >= {cos[worst]:.5f} ({worst}; limit "
        f"{GRAD_COS_MIN}), norm ratio {min(ratio.values()):.5f}-"
        f"{max(ratio.values()):.5f} (band {lo}-{hi})")
    if (rel > GRAD_LOSS_TOL or cos[worst] < GRAD_COS_MIN
            or not all(lo <= r <= hi for r in ratio.values())):
        raise AssertionError("lora: gradient check failed")
    return launches, {"step_ms": statistics.median(step_ms[1:]),
                      "peak_gib": peak, "grad_rel": rel,
                      "grad_cos": cos[worst], "full_depth": full}


def kernels_cobsat(results):
    """The flash forward at the CoBSAT scorer's CLIP-L ViT: B32 H16 T257
    D64, bidirectional, on head-transposed views of its projections, also
    with a cold L2 and checked to be one device launch a call."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.flash_attention import (
        flash_attention, mha_reference)

    b, t, h, d = COBSAT_IMAGES, 257, 16, 64
    q, k, v = (randn((b, t, h * d), s).reshape(b, t, h, d).transpose(1, 2)
               for s in (110, 111, 112))
    run = lambda: flash_attention(q, k, v, None, None, False, d ** -0.5)
    results.append(check(
        "flash_attention_fwd", "clip-l vision B32 H16 T257 D64 "
        "(projection views)", run,
        lambda: mha_reference(q, k, v, None, None, False, d ** -0.5),
        lambda e, r: e <= 2e-2 + 2e-2 * r.abs(),
        "2e-2 + 2e-2*|ref| (P rounded to bf16; bf16 output)",
        (nbytes(q, k, v, q), 4 * b * h * t * t * d, "bf16"),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=d ** -0.5),
        cold="flash_fwd"))
    expect_one_launch("kernels", "clip-l vision attention", run, "flash_fwd")


def kernels_lora(results):
    """A LoRA step's attention at Llama-2-7B's B4 H32 T512 D128, causal:
    the flash forward with its lse, dq and dk/dv (as the decoder hands
    them over: head-transposed views of the projections, dO a view of a
    contiguous (B, T, H*D) gradient); and RMSNorm at its 2048 rows of
    4096."""
    import torch.nn.functional as F

    from thinkdiff_torch.ops.norms import rmsnorm, rmsnorm_reference

    b, t, h, d = LORA_B, LORA_T, 32, 128
    heads = lambda x: x.reshape(b, t, h, d).transpose(1, 2)
    q, k, v, do = (heads(randn((b, t, h * d), s)) for s in (113, 114, 115, 116))
    check_attention(results, f"llama B{b} H{h} T{t} D{d} causal (projection "
                    "views, strided dO)", q, k, v, do,
                    dict(bias=None, kv_mask=None, causal=True,
                         sm_scale=d ** -0.5, q_segment_ids=None,
                         kv_segment_ids=None))
    del q, k, v, do
    x, scale = randn((b * t, 4096), 117) * 3.0, randn((4096,), 118)
    results["rmsnorm"].append(check(
        "rmsnorm", f"llama R{b * t} D4096",
        lambda: rmsnorm(x, scale, 1e-6),
        lambda: rmsnorm_reference(x, scale, 1e-6),
        lambda e, ref: e <= bf16_ulp(ref), "1 bf16 ulp",
        (nbytes(x, scale, x), 4 * x.numel(), "bf16"),
        library=lambda: F.rms_norm(x, (4096,), scale, 1e-6)))


def main() -> int:
    name, _ = phase_device()
    t_start = time.perf_counter()
    phase_build()
    results = phase_kernels()
    launches, train = phase_train_w8a8()
    torch.cuda.empty_cache()
    calib, calib_rates = phase_calibrate()
    torch.cuda.empty_cache()
    yaml_step_ms = phase_train_yaml()
    torch.cuda.empty_cache()
    ops = phase_ops()
    for k in OP_KERNELS:
        launches[k] = ops[k]
    base_cfg, cfg, params = load_weights()
    phase_dense_slice(base_cfg, cfg, params)
    phase_dense_int8(base_cfg, params)
    served, paged_engine, rates = phase_paged_slice(base_cfg, cfg, params)
    launches["paged_attention"] = served["paged_attention"]
    phase_profile(paged_engine)
    del paged_engine
    torch.cuda.empty_cache()
    launches["fused_lm_sample"] = phase_gumbel_slice(
        base_cfg, cfg, params)["fused_lm_sample"]
    torch.cuda.empty_cache()
    cli1, cli2, ddp = phase_cli(base_cfg, cfg, params, yaml_step_ms)
    del params
    torch.cuda.empty_cache()
    lvlm, lvlm_rates, lvlm_model = phase_lvlm_text()
    launches["int8_matmul"] = lvlm["int8_matmul"]
    embeds, embed_launches = lvlm_flux_embeds(lvlm_model)
    # the VLM side is freed: the FLUX phase needs only the aligned tokens
    del lvlm_model
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    flux, flux_rates, pipe = phase_lvlm_flux(embeds, embed_launches)
    clip_flux, clip_flux_rates, clip_model = phase_clip_flux(pipe)
    clis, clis_rates = phase_lvlm_flux_clis(pipe, clip_model)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    clip_video, video_rates = phase_clip_video(clip_model)
    del clip_model
    gc.collect()
    torch.cuda.empty_cache()
    try:
        clip_train, clip_train_rates = phase_clip_train()
        gc.collect()
        torch.cuda.empty_cache()
        ddp_clip = phase_ddp_clip(clip_train_rates["storage"])
    finally:
        import shutil

        shutil.rmtree(CLIP_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    cobsat, cobsat_rates = phase_cobsat()
    torch.cuda.empty_cache()
    lora, lora_rates = phase_lora()
    nat = cli1["native"]
    gloo, first = ddp["train"]["gloo"], ddp["stage1"]
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"train-w8a8 {train['step_ms']:.1f} ms a step, "
        f"{train['samples_per_s']:.2f} samples/s per GPU, peak "
        f"{train['peak_gib']:.2f} GiB; paged slice {rates['imgs_per_s']:.2f} "
        f"imgs/s, {rates['tokens_per_s']:.1f} generated tokens/s; lvlm-text "
        f"{lvlm_rates['wall_s']:.2f} s for {LVLM_REQUESTS} requests, "
        f"{lvlm_rates['t5_ms_per_step']:.2f} ms a T5 step; cli stage 1 "
        f"{cli1['imgs_per_s']:.2f} imgs/s, {cli1['mb']:.1f} MB in "
        f"{cli1['tars']} shards; cli stage 2 {cli2['step_ms']:.0f} ms a step "
        f"(train-yaml {yaml_step_ms:.0f}); lvlm-flux {flux_rates['wall_s']:.2f} "
        f"s for a 1024² image, {flux_rates['ms_per_step']:.1f} ms a denoise "
        f"step, VAE {flux_rates['vae_s']:.2f} s, peak "
        f"{flux_rates['peak_gib']:.2f} GiB; clip-flux "
        f"{clip_flux_rates['wall_s']:.2f} s for a 1024² image from one "
        f"image, {clip_flux_rates['two_wall_s']:.2f} s from two; "
        f"lvlm-flux-clis {sum(clis_rates['walls'].values()):.2f} s for "
        f"{len(clis_rates['walls'])} runs of the six CLIs, peak "
        f"{clis_rates['peak_gib']:.2f} GiB; clip-video "
        f"{video_rates['wall_s']:.2f} s a 49-frame 480x720 video, "
        f"{video_rates['ms_per_step']:.1f} ms a denoise step (busy "
        f"{video_rates['busy_ms'] / video_rates['wall_ms']:.0%}), VAE "
        f"{video_rates['vae_s']:.2f} s, peak {video_rates['peak_gib']:.2f} "
        f"GiB; clip-train "
        f"{clip_train_rates['step_ms']:.0f} ms a step, peak "
        f"{clip_train_rates['peak_gib']:.2f} GiB; ddp (two ranks sharing "
        f"one card: correctness, not scaling) stage 2 "
        + ", ".join(f"rank {r['rank']} {r['step_ms']:.0f} ms a step, peak "
                    f"{r['peak_gib']:.2f} GiB" for r in gloo)
        + "; stage 1 " + ", ".join(f"rank {r['rank']} {r['imgs_per_s']:.2f} "
                                   f"imgs/s" for r in first)
        + "; clip " + ", ".join(f"rank {r['rank']} {r['step_ms']:.0f} ms a "
                                f"step" for r in ddp_clip)
        + f" ({ddp_clip[0]['data_path'][0]}); native: "
        + (f"{nat['native_imgs_per_s']:.1f} imgs/s (C++) against "
           f"{nat['pil_imgs_per_s']:.1f} (PIL)" if nat["native"] else
           f"unavailable, PIL {nat['pil_imgs_per_s']:.1f} imgs/s")
        + f"; calibrate {calib_rates['seconds']:.2f} s, "
        f"{calib_rates['changed']} of {calib_rates['scales']} input_scales "
        f"changed; cobsat {cobsat_rates['imgs_per_s']:.1f} imgs/s (CLI "
        f"{cobsat_rates['cli_imgs_per_s']:.1f}); lora "
        f"{lora_rates['step_ms']:.1f} ms a step, peak "
        f"{lora_rates['peak_gib']:.2f} GiB")
    report = []
    for kname, (route, source, replaces) in TPU_KERNELS.items():
        rows = results[kname]
        main_row = next(r for r in rows if r["main"])
        report.append({
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "device_ms": main_row["device_ms"],
            "cold_device_ms": main_row["cold_device_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "launches_from": ("ops phase (no model path runs it)"
                              if kname in OP_KERNELS else "main path"),
            "cli_stage1_launches": cli1["launches"][kname],
            "cli_stage2_launches": cli2["launches"][kname],
            "lvlm_flux_launches": flux[kname],
            "lvlm_flux_get_embed_launches": embed_launches[kname],
            "clip_flux_launches": clip_flux[kname],
            "clip_video_launches": clip_video[kname],
            "lvlm_flux_clis_launches": clis[kname],
            "clip_train_launches": clip_train[kname],
            "ddp_train_launches": [r["launches"][kname] for r in gloo],
            "ddp_stage1_launches": [r["launches"][kname] for r in first],
            "ddp_world1_launches": ddp["train"]["w1"]["launches"][kname],
            "ddp_clip_launches": [r["launches"][kname] for r in ddp_clip],
            "calibrate_launches": calib[kname],
            "cobsat_launches": cobsat[kname], "lora_launches": lora[kname],
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
    if sys.argv[1:2] == ["--ddp-child"]:
        sys.exit(ddp_child(sys.argv[2:]))
    sys.exit(main())
