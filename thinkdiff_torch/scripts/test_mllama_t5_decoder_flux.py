"""ThinkDiff-LVLM single-image inference into FLUX (stage 3): image +
question -> Qwen2-VL generate -> aligned hidden states -> projector ->
FLUX.1-dev -> a PNG at ``{output_dir}/{image name}_seed{seed}.png``.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.image_path=... run.text_input="..." [--device cpu]

The run section's ``image_height``/``image_width``, ``num_inference_steps``,
``guidance_scale``, ``seed``, ``embedding_type``, ``max_new_tokens`` and
``flux_model`` are used as written. FLUX's initial noise comes from a
``torch.Generator`` seeded with ``seed`` (not JAX's draw: the same seed
gives another image than the JAX script).
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def main(argv=None):
    args = parse_args("ThinkDiff-LVLM -> FLUX inference (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from PIL import Image

    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    model = task.build_model(cfg)

    image_path = run.get("image_path")
    text_input = run.get("text_input", "")
    out_dir = run.get("output_dir", "output/lvlm_flux")
    seed = int(run.get("seed", 42))
    embedding_type = run.get("embedding_type", "output_embed")
    max_new_tokens = int(run.get("max_new_tokens", 128))

    samples = {"images": [Image.open(image_path)], "answers": [text_input]}
    conds, gen = model.get_embed(samples, embedding_type=embedding_type,
                                 max_new_tokens=max_new_tokens)
    print("generated:", gen.texts[0])

    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    images = pipeline.generate(
        conds[0][None], prompt="",
        height=int(run.get("image_height", 1024)),
        width=int(run.get("image_width", 1024)),
        num_steps=int(run.get("num_inference_steps", 28)),
        guidance=float(run.get("guidance_scale", 3.5)),
        seed=seed,
    )
    name = os.path.splitext(os.path.basename(image_path))[0]
    out_path = os.path.join(out_dir, f"{name}_seed{seed}.png")
    save_images(images, [out_path])
    print("saved:", out_path)
    return out_path


if __name__ == "__main__":
    main()
