"""FLUX sampling from exported aligned embeds (the replay half of the
export workflow): an ``.npy`` or torch ``.pth`` of aligned tokens (as the
``_flux_embed*`` exporters write them), optionally followed by the T5 text
embeds of ``run.extra_text_input`` (after the image tokens), into FLUX ->
``{output_dir}/{embed name}_seed{seed}.png``.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_multi_image_input \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.embed_path=x.npy [run.extra_text_input="..."] [--device cpu]

``run.embed_path`` (absent from the YAML) names the export; the text
embedder is flan-t5-xxl's encoder (``run.t5_model``, local files, raising
without them); ``image_height`` / ``image_width`` default to 512. No
aligner model is built. FLUX's initial noise comes from a
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def load_embeds(path: str):
    """An exported (S, D) or (B, S, D) array: ``.npy``, else a torch file
    (``.pth``), as f32 numpy."""
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    import torch

    return torch.load(path, map_location="cpu", weights_only=True).float().numpy()


def main(argv=None):
    args = parse_args("FLUX sampling from saved aligned embeds (PyTorch)",
                      argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    import torch

    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import T5TextEmbedder, ThinkDiffPipeline

    embed_path = run.get("embed_path")
    extra_text = run.get("extra_text_input", "")
    out_dir = run.get("output_dir", "output/lvlm_flux_replay")
    seed = int(run.get("seed", 42))

    cond = torch.as_tensor(load_embeds(embed_path), device=task.device)
    if cond.ndim == 2:
        cond = cond[None]
    if extra_text:
        embedder = T5TextEmbedder.from_pretrained(
            run.get("t5_model", "google/flan-t5-xxl"), device=task.device)
        cond = torch.cat([cond, embedder(extra_text).to(cond)], dim=1)

    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    images = pipeline.generate(
        cond, prompt="",
        height=int(run.get("image_height", 512)),
        width=int(run.get("image_width", 512)),
        num_steps=int(run.get("num_inference_steps", 28)),
        guidance=float(run.get("guidance_scale", 3.5)), seed=seed)
    name = os.path.splitext(os.path.basename(embed_path))[0]
    out_path = os.path.join(out_dir, f"{name}_seed{seed}.png")
    save_images(images, [out_path])
    print("saved:", out_path)
    return out_path


if __name__ == "__main__":
    main()
