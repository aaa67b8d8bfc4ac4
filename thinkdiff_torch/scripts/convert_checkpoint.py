"""Checkpoint interchange with the reference stack, both directions
(counterpart of scripts/convert_checkpoint.py).

A reference aligner checkpoint (thinkdiff_clip.pth / thinkdiff_lvlm.pth:
its trainable ``mm_projector.*`` entries, raw or under ``model``) becomes
the port's trainable checkpoint, ``{"model": {JAX path: tensor}, "epoch":
0}``: what ``load_checkpoint`` (a config's ``model.ckpt``) reads; it holds
no optimizer state, so it starts a run rather than resuming one. The port's
``checkpoint_{tag}.pth`` (its ``model`` entries under their JAX paths)
becomes the reference's ``{"model": state dict, "epoch": 0}`` wrapper with
the ``mm_projector.*`` key layout its inference scripts load. Both sides
are ``.pth``, so the direction is inferred from the input's keys.

    python -m thinkdiff_torch.scripts.convert_checkpoint \\
        --arch mllama-vllm-t5-embed-decoder-2 \\
        --input thinkdiff_lvlm.pth --output checkpoints/thinkdiff_lvlm.pth
    python -m thinkdiff_torch.scripts.convert_checkpoint \\
        --arch mllama-vllm-t5-embed-decoder-2 \\
        --input output/run/checkpoint_best.pth --output thinkdiff_lvlm.pth
"""

from __future__ import annotations

import argparse
import os

import torch


def _state_dict(path: str):
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ck, dict) and isinstance(ck.get("model"), dict):
        ck = ck["model"]
    return ck


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", required=True)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    import thinkdiff_torch.models.aligner_clip  # noqa: F401
    import thinkdiff_torch.models.aligner_lvlm  # noqa: F401
    from thinkdiff_torch.core.registry import registry
    from thinkdiff_torch.models.bridge import flatten, to_tensor, unflatten

    model_cls = registry.get_model_class(args.arch)
    if model_cls is None:
        raise KeyError(f"Unknown arch '{args.arch}'")
    # the conversion is a name map: no model (and no card) is needed
    model = model_cls.__new__(model_cls)

    sd = _state_dict(args.input)
    if any("mm_projector" in k for k in sd):
        converted = flatten(model_cls.convert_reference_checkpoint(model, sd))
        payload = {"model": {k: to_tensor(v).clone() for k, v in
                             converted.items()}, "epoch": 0}
    elif sd and all("/" in k for k in sd):
        converted = model_cls.export_reference_checkpoint(model, unflatten(sd))
        payload = {"model": {k: to_tensor(v).clone() for k, v in
                             converted.items()}, "epoch": 0}
    else:
        raise ValueError(
            f"{args.input}: neither a reference checkpoint (mm_projector.* "
            "keys) nor the port's (keys under their JAX paths)")
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save(payload, args.output)
    print(f"converted {args.input} -> {args.output}")
    for k, v in sorted(payload["model"].items()):
        print(" ", k, tuple(v.shape))
    return payload


if __name__ == "__main__":
    main()
