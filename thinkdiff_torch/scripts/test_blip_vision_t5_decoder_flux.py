"""ThinkDiff-CLIP image(+text) inference into FLUX: each image through the
BLIP-2 ViT-g, the x2 pool and the projector, the images' tokens
concatenated (then the T5 text embeds of ``run.text_input`` when the
pipeline has a T5 embedder), cut to ``run.max_sequence_length`` tokens,
into FLUX.1-dev -> a PNG at ``{output_dir}/{image names}_seed{seed}.png``.

    python -m thinkdiff_torch.scripts.test_blip_vision_t5_decoder_flux \\
        --cfg-path configs/test_thinkdiff_clip_image_text.yaml \\
        --options run.image_path=... [run.text_input="..."] [--device cpu]

``run.image_paths`` (a list) or ``run.image_path`` name the images (the
YAML sets neither: pass them through ``--options``). The run section's
``image_height``/``image_width``, ``num_inference_steps``,
``guidance_scale``, ``seed`` and ``flux_model`` are used as written. An
existing output is kept (``run.skip_if_exists``, default true) and, unlike
the JAX script, which checks after sampling, nothing is sampled for it.
FLUX's initial noise comes from a ``torch.Generator`` seeded with ``seed``
(not JAX's draw: the same seed gives another image than the JAX script).
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def main(argv=None):
    args = parse_args("ThinkDiff-CLIP -> FLUX inference (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from PIL import Image

    from thinkdiff_torch.data.processors import BlipImageEvalProcessor
    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    image_paths = run.get("image_paths") or [run.get("image_path")]
    prompt = run.get("text_input", "")
    out_dir = run.get("output_dir", "output/clip_flux")
    seed = int(run.get("seed", 42))
    max_seq = int(run.get("max_sequence_length", 512))
    name = "_".join(os.path.splitext(os.path.basename(p))[0]
                    for p in image_paths)
    out_path = os.path.join(out_dir, f"{name}_seed{seed}.png")
    if os.path.exists(out_path) and run.get("skip_if_exists", True):
        print("exists, skipping:", out_path)
        return out_path

    model = task.build_model(cfg)
    proc = BlipImageEvalProcessor(image_size=224)
    projections = [model.forward_encoder(proc(Image.open(p))[None])[0]
                   for p in image_paths]
    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    text_embeds = None
    if prompt and pipeline.t5_embedder is not None:
        text_embeds = pipeline.t5_embedder(prompt)[0]
    cond = pipeline.compose_clip_condition(projections, text_embeds,
                                           max_len=max_seq)
    images = pipeline.generate(
        cond[None], prompt=prompt,
        height=int(run.get("image_height", 1024)),
        width=int(run.get("image_width", 1024)),
        num_steps=int(run.get("num_inference_steps", 28)),
        guidance=float(run.get("guidance_scale", 3.5)), seed=seed)
    save_images(images, [out_path])
    print("saved:", out_path)
    return out_path


if __name__ == "__main__":
    main()
