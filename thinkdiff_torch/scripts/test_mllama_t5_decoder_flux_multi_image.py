"""ThinkDiff-LVLM multi-image (CoBSAT-style) inference into FLUX: the
images and an interleaved "Word k: <attr>," text with the analyse-then-
prompt instruction -> Qwen2-VL generate -> aligned output embeds -> FLUX ->
``{output_dir}/cobsat_seed{seed}.png``.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_multi_image \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options "run.image_paths=[a.jpg, b.jpg]" \\
        "run.text_inputs=[red, blue]" [--device cpu]

``run.image_paths`` and ``run.text_inputs`` (absent from the YAML) name the
case; ``image_height`` / ``image_width`` default to 512 (the YAML sets
1024), ``num_inference_steps``, ``guidance_scale``, ``seed``,
``embedding_type``, ``max_new_tokens`` and ``flux_model`` are read as the
JAX script reads them. FLUX's initial noise comes from a
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args

ANALYSE_INSTRUCTION = (
    "Please analyse the relationship between the words and the images, then "
    "generate a detailed prompt describing the next image for the final word "
    "so it can be created by a 2D diffusion model."
)


def build_interleaved_text(text_inputs, n_images):
    """'Word k: <attr>,' per item, then the instruction (the chat template
    interleaves the images)."""
    parts = [f"Word {i + 1}: {word}," for i, word in enumerate(text_inputs)]
    return " ".join(parts) + " " + ANALYSE_INSTRUCTION


def main(argv=None):
    args = parse_args("ThinkDiff-LVLM multi-image -> FLUX (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from PIL import Image

    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    model = task.build_model(cfg)
    image_paths = list(run.get("image_paths", []))
    text_inputs = list(run.get("text_inputs", []))
    out_dir = run.get("output_dir", "output/lvlm_flux_multi")
    seed = int(run.get("seed", 42))

    images = [Image.open(p) for p in image_paths]
    prompt_text = build_interleaved_text(text_inputs, len(images))
    samples = {"images": [images], "answers": [prompt_text]}
    conds, gen = model.get_embed(
        samples, embedding_type=run.get("embedding_type", "output_embed"),
        max_new_tokens=int(run.get("max_new_tokens", 128)))
    print("generated:", gen.texts[0])

    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    out = pipeline.generate(
        conds[0][None], prompt="",
        height=int(run.get("image_height", 512)),
        width=int(run.get("image_width", 512)),
        num_steps=int(run.get("num_inference_steps", 28)),
        guidance=float(run.get("guidance_scale", 3.5)), seed=seed)
    out_path = os.path.join(out_dir, f"cobsat_seed{seed}.png")
    save_images(out, [out_path])
    print("saved:", out_path)
    return out_path


if __name__ == "__main__":
    main()
