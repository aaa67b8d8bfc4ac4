"""Text-only aligned-embed FLUX sampling, a text -> embed -> image probe of
the aligner: each prompt through Qwen2-VL with no image, the selected
embedding type aligned (the MODEL section's ``embedding_type``, default
output_embed), zero-padded or cut to ``run.max_tokens``, into FLUX ->
``{output_dir}/{name}_edit_4_flux_{embedding_type}_0.png``.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_multi_image_input_embed \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options "run.prompts=[a red apple]" [run.max_tokens=128] [--device cpu]

``run.prompts`` (or ``run.prompt``) and ``run.image_names`` (default
text0, text1, ...) are read as the JAX script reads them; an existing
output is skipped; ``image_height`` / ``image_width`` default to 512.
FLUX's initial noise comes from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def pad_or_cut(cond, max_tokens):
    """(B, S, D) -> (B, max_tokens, D): zero rows appended or the tail cut;
    unchanged when ``max_tokens`` is None."""
    import torch

    if max_tokens is None:
        return cond
    max_tokens = int(max_tokens)
    if cond.shape[1] > max_tokens:
        return cond[:, :max_tokens]
    if cond.shape[1] < max_tokens:
        pad = cond.new_zeros((cond.shape[0], max_tokens - cond.shape[1],
                              cond.shape[2]))
        return torch.cat([cond, pad], dim=1)
    return cond


def main(argv=None):
    args = parse_args("LVLM text-only embed -> FLUX (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    model = task.build_model(cfg)
    prompts = list(run.get("prompts") or [run.get("prompt", "")])
    image_names = list(run.get("image_names") or
                       [f"text{i}" for i in range(len(prompts))])
    out_dir = run.get("output_dir", "output/lvlm_text_embed_flux")
    os.makedirs(out_dir, exist_ok=True)
    embedding_type = cfg.model_cfg.get("embedding_type", "output_embed")

    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    written = []
    for name, prompt in zip(image_names, prompts):
        out_path = os.path.join(
            out_dir, f"{name}_edit_4_flux_{embedding_type}_0.png")
        if os.path.exists(out_path):
            print("exists, skipping:", out_path)
            continue
        samples = {"images": [[]], "answers": [prompt]}  # no image
        conds, gen = model.get_embed(
            samples, embedding_type=embedding_type,
            max_new_tokens=int(run.get("max_new_tokens", 128)))
        print("generated:", gen.texts[0])
        cond = pad_or_cut(conds[0].float()[None], run.get("max_tokens"))
        images = pipeline.generate(
            cond, prompt="",
            height=int(run.get("image_height", 512)),
            width=int(run.get("image_width", 512)),
            num_steps=int(run.get("num_inference_steps", 28)),
            guidance=float(run.get("guidance_scale", 3.5)),
            seed=int(run.get("seed", 42)))
        save_images(images, [out_path])
        print("saved:", out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
