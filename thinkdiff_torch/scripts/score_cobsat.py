"""CoBSAT accuracy scorer: generated case PNGs -> the accuracy table, with
the port's CLIP scorer (counterpart of scripts/score_cobsat.py; the
reference reports 46.3% best accuracy, its README.md:27).

Protocol (CoBSAT, arXiv:2402.01293): each generated image must depict
both the LATENT variable the model had to infer from the demonstration
images and the EXPLICIT attribute named by the final text input. A CLIP
classifier scores the image against prompt-templated candidate labels of
each variable apart; a case is right when both argmaxes equal the ground
truth. Reported: overall accuracy, per-variable accuracies and a per-task
breakdown.

    python -m thinkdiff_torch.scripts.score_cobsat --images-dir out/ \\
        --labels-json labels.json [--clip openai/clip-vit-large-patch14] \\
        [--template "a photo of {}"] [--out-json res.json] [--device cpu]

``--images-dir`` holds {case}.png (or {case}_seed*.png); ``--labels-json``
is {case: {"latent", "explicit", "latent_candidates",
"explicit_candidates", "task" (optional)}}; ``--clip`` names local CLIP
weights (a directory or the hub cache; nothing is downloaded).
``score_cases`` takes any object with ``classify(images, texts) -> (B, N)``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np


def find_case_image(images_dir: str, case: str):
    for pat in (f"{case}.png", f"{case}_seed*.png", f"{case}*.png"):
        hits = sorted(glob.glob(os.path.join(images_dir, pat)))
        if hits:
            return hits[0]
    return None


def score_cases(scorer, images_dir: str, labels: Dict[str, Dict],
                template: str = "a photo of {}") -> Dict:
    """-> {"overall", "latent_acc", "explicit_acc", "per_task": {task:
    acc}, "n", "missing": [...], "cases": {...}}."""
    from PIL import Image

    per_case = {}
    missing = []
    for case, lab in sorted(labels.items()):
        path = find_case_image(images_dir, case)
        if path is None:
            missing.append(case)
            continue
        lat_cands = list(lab["latent_candidates"])
        exp_cands = list(lab["explicit_candidates"])
        with Image.open(path) as img:
            sims = scorer.classify(
                [img], [template.format(c) for c in lat_cands + exp_cands])[0]
        pred_lat = lat_cands[int(np.argmax(sims[: len(lat_cands)]))]
        pred_exp = exp_cands[int(np.argmax(sims[len(lat_cands):]))]
        rec = {"pred_latent": pred_lat, "pred_explicit": pred_exp,
               "latent_ok": pred_lat == lab["latent"],
               "explicit_ok": pred_exp == lab["explicit"],
               "task": lab.get("task", "default")}
        rec["correct"] = rec["latent_ok"] and rec["explicit_ok"]
        per_case[case] = rec

    n = len(per_case)
    if n == 0:
        return {"overall": 0.0, "latent_acc": 0.0, "explicit_acc": 0.0,
                "per_task": {}, "n": 0, "missing": missing, "cases": {}}
    tasks: Dict[str, List[bool]] = {}
    for c in per_case.values():
        tasks.setdefault(c["task"], []).append(c["correct"])
    return {
        "overall": sum(c["correct"] for c in per_case.values()) / n,
        "latent_acc": sum(c["latent_ok"] for c in per_case.values()) / n,
        "explicit_acc": sum(c["explicit_ok"] for c in per_case.values()) / n,
        "per_task": {t: sum(v) / len(v) for t, v in sorted(tasks.items())},
        "n": n, "missing": missing, "cases": per_case,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="CoBSAT accuracy scorer (PyTorch)")
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--labels-json", required=True)
    ap.add_argument("--clip", default="openai/clip-vit-large-patch14")
    ap.add_argument("--template", default="a photo of {}")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a card) or cpu")
    args = ap.parse_args(argv)

    with open(args.labels_json) as f:
        labels = json.load(f)

    from thinkdiff_torch.models.clip_scorer import CLIPScorer

    scorer = CLIPScorer.from_pretrained(args.clip, device=args.device)
    result = score_cases(scorer, args.images_dir, labels,
                         template=args.template)

    print(f"cases scored: {result['n']}   missing: {len(result['missing'])}")
    print(f"overall accuracy (both correct): {result['overall']:.3f}")
    print(f"  latent-variable accuracy:      {result['latent_acc']:.3f}")
    print(f"  explicit-attribute accuracy:   {result['explicit_acc']:.3f}")
    for task, acc in result["per_task"].items():
        print(f"  task {task:<16} {acc:.3f}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=2)
        print("saved:", args.out_json)
    return result


if __name__ == "__main__":
    main()
