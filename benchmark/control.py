"""Readings of the numbers that decide ``correct``, at a cell's own size,
over many seeds in one process: what the limits in ``workloads/<cell>.json``
are set from. The benchmark's runs never run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --mode <mode> [--passes n]

Modes:
  sound    the program as the cell runs it, judged by the cell's check:
           training, set-up's first steps and, after ``--passes`` passes
           over the pool through the window's call (a 45 s window takes
           about 18), three steps more; rendering, the checked request;
  control  the nearest lower precision: training, the program's own w8a8
           path (``quantize_frozen: int8_dyn`` on the fused layout) judged
           by the same check; rendering, the reference itself with fp8
           products in the program's place, judged against the float32
           reference;
  half     training only: the step's loss taken over the first half of
           each batch (half of the batch left out, the mean over the rest).

Prints one JSON line a seed: {"seed", "mode", "readings": {name: value}}."""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import sys
import time
from unittest import mock

import torch

from benchmark import harness


def readings(workload: str, seed: int, mode: str, device="cuda",
             files=None, passes: int = 18) -> dict:
    files = copy.deepcopy(files or harness.cell_files(workload))
    cell, config, traffic = files["cell"], files["config"], files["traffic"]
    device = torch.device(device)
    if mode == "control" and cell["driver"] == "flux_render":
        from benchmark.drivers import flux_render
        from benchmark.reference.precision import Products

        lat, img = flux_render.render(config, traffic, seed, 0, device,
                                      Products("fp32"))
        lat8, img8 = flux_render.render(config, traffic, seed, 0, device,
                                        Products("fp8"))
        return {"latent_rel": flux_render.latent_gap(lat8, lat),
                "image_abs": float((img8 - img).abs().mean())}
    if mode == "control":
        config["model"]["quantize_frozen"] = "int8_dyn"
        config["t5_layout"] = {"fused_proj": True}
    patch = contextlib.nullcontext()
    if mode == "half":
        from thinkdiff_torch.models.aligner_lvlm import MllamaT5EmbedDecoder

        loss_fn = MllamaT5EmbedDecoder.loss_fn

        def half(self, trainable, frozen, batch, rng=None):
            n = batch["labels"].shape[0] // 2
            return loss_fn(self, trainable, frozen,
                           {k: v[:n] for k, v in batch.items()}, rng)

        patch = mock.patch.object(MllamaT5EmbedDecoder, "loss_fn", half)
    driver = harness.driver_class(cell["driver"])(cell, config, traffic, seed,
                                                  device)
    with patch:
        driver.setup()
        if cell["driver"] == "train_lvlm":
            for i in range(passes):
                driver.unit(i, harness.Spans())
        driver.after_window()
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {k: v for k, (v, _) in driver.check().items()}
    if getattr(driver, "left_out", None):
        out["left_out"] = driver.left_out
    return out


def main(argv=None) -> int:
    harness.prepare_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("sound", "control", "half"),
                    default="sound")
    ap.add_argument("--passes", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.mode, passes=args.passes)
        print(json.dumps({"seed": int(s), "mode": args.mode, "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
