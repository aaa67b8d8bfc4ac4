"""ThinkDiff-CLIP image+text composition into FLUX: for each case, every
image of the case through the BLIP-2 ViT-g, the x2 pool and the projector,
concatenated [img_1; img_2; ...; T5 text of the prompt] (images first, text
last, the text's ids cut to ``run.flux_max_sequence_length``), the CLIP-L
pooled embedding from the prompt.

    python -m thinkdiff_torch.scripts.test_blip_vision_t5_decoder_flux_text \\
        --cfg-path configs/test_thinkdiff_clip_two_images.yaml \\
        --options "run.img_urls=[[a.jpg, b.jpg]]" [--device cpu]

The JAX script's input surface:
  - images: ``run.img_folder`` (every .png/.jpg) | ``run.img_json`` (a JSON
    list whose items may be lists: multi-image composition) |
    ``run.img_urls``; ``run.img_urls_len`` keeps the first n;
  - prompts: ``run.prompt_json`` ({image name: prompt}) | ``run.questions``
    + ``run.questions_names``;
  - naming: ``use_image_name_as_output_name`` |
    ``use_image_name_and_prompt_as_output_name`` | by default
    ``{image}_clip_t5_flux_{name}_seed_{seed}.png``; an existing output is
    skipped.
FLUX's initial noise comes from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import json
import os
import re

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def _image_list(run):
    if run.get("img_folder"):
        folder = run["img_folder"]
        urls = sorted(os.path.join(folder, n) for n in os.listdir(folder)
                      if n.endswith((".png", ".jpg")))
    elif run.get("img_json"):
        with open(run["img_json"]) as f:
            urls = json.load(f)
    else:
        urls = list(run.get("img_urls", []))
    if run.get("img_urls_len"):
        urls = urls[: int(run["img_urls_len"])]
    return urls


def _image_names(run, img_urls):
    if run.get("image_names"):
        return list(run["image_names"])
    names = []
    for u in img_urls:
        if isinstance(u, (list, tuple)):
            names.append("_".join(os.path.splitext(os.path.basename(s))[0]
                                  for s in u))
        else:
            names.append(os.path.splitext(os.path.basename(u))[0])
    return names


def _output_path(run, out_dir, image_name, prompt, q_name, seed):
    if run.get("use_image_name_as_output_name", False):
        return os.path.join(out_dir, f"{image_name}.png")
    if run.get("use_image_name_and_prompt_as_output_name", False):
        p = re.sub(r"[^\w\s-]", "", prompt)
        p = re.sub(r"\s+", "_", p)
        return os.path.join(out_dir, f"{image_name}_{p}.png")
    tag = f"_{q_name}" if q_name else ""
    return os.path.join(out_dir,
                        f"{image_name}_clip_t5_flux{tag}_seed_{seed}.png")


def main(argv=None):
    args = parse_args("ThinkDiff-CLIP image+text -> FLUX (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from PIL import Image

    from thinkdiff_torch.data.processors import BlipImageEvalProcessor
    from thinkdiff_torch.engines.flux_sampler import save_images
    from thinkdiff_torch.engines.pipeline import ThinkDiffPipeline

    model = task.build_model(cfg)
    proc = BlipImageEvalProcessor(image_size=int(run.get("image_size", 224)))
    img_urls = _image_list(run)
    image_names = _image_names(run, img_urls)
    out_dir = run.get("output_dir", "output/clip_flux_text")
    os.makedirs(out_dir, exist_ok=True)
    seed = int(run.get("seed", 42))

    if run.get("prompt_json"):
        with open(run["prompt_json"]) as f:
            prompt_by_name = json.load(f)
        cases = [(i, prompt_by_name[image_names[i]], None)
                 for i in range(len(img_urls))]
    else:
        questions = list(run.get("questions", [""]))
        q_names = list(run.get("questions_names", [None] * len(questions)))
        cases = [(i, q, qn) for i in range(len(img_urls))
                 for q, qn in zip(questions, q_names)]

    pipeline = ThinkDiffPipeline.from_pretrained(
        run.get("flux_model", "black-forest-labs/FLUX.1-dev"),
        device=task.device)
    max_seq = int(run.get("flux_max_sequence_length", 128))
    saved = []
    for img_i, prompt, q_name in cases:
        out_path = _output_path(run, out_dir, image_names[img_i], prompt,
                                q_name, seed)
        if os.path.exists(out_path):
            print("exists, skipping:", out_path)
            continue
        urls = img_urls[img_i]
        urls = urls if isinstance(urls, (list, tuple)) else [urls]
        # image tokens first, the T5 text embeds of the prompt last
        projections = [model.forward_encoder(
            proc(Image.open(u).convert("RGB"))[None])[0] for u in urls]
        text_embeds = None
        if pipeline.t5_embedder is not None and prompt:
            text_embeds = pipeline.t5_embedder(prompt, max_len=max_seq)[0]
        cond = pipeline.compose_clip_condition(projections, text_embeds)
        images = pipeline.generate(
            cond[None], prompt=prompt,
            height=int(run.get("flux_height", 1024)),
            width=int(run.get("flux_width", 1024)),
            num_steps=int(run.get("flux_num_inference_steps", 28)),
            guidance=float(run.get("guidance_scale", 3.5)), seed=seed)
        save_images(images, [out_path])
        print("saved:", out_path)
        saved.append(out_path)
    return saved


if __name__ == "__main__":
    main()
