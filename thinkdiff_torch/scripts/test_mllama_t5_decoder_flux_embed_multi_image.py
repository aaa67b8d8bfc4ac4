"""CoBSAT embed exporter, multi-image: every case JSON of
``run.image_folder`` (``{"text_inputs": [...], "image_inputs": [...]}``)
through the LVLM aligner with the ``run.prompt`` instruction first, then
the "Word k: <attr>, " items with their images interleaved, ->
``{output_dir}/{case}.pth`` (the aligned tokens, f32, torch-loadable for
the external CoBSAT scorer) and ``{case}.json`` (the case, generated_text,
prompt). Existing exports are skipped.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_embed_multi_image \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.image_folder=cases/ [run.image_path_prefix=...] [--device cpu]

The embedding type is the MODEL section's ``embedding_type`` (default
output_embed), as the JAX script reads it.
"""

from __future__ import annotations

import json
import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def build_word_texts(text_inputs):
    """'Word k: <attr without its last two characters>, ' items, the ones
    after the first preceded by a blank line."""
    texts = []
    for i, t in enumerate(text_inputs):
        head = f"Word {i + 1}: " if i == 0 else f"\n\nWord {i + 1}: "
        texts.append(head + t[:-2] + ", ")
    return texts


def save_pth(path: str, arr) -> None:
    import torch

    with open(path, "wb") as f:
        torch.save(torch.as_tensor(arr).detach().float().cpu().clone(), f)


def main(argv=None):
    args = parse_args("CoBSAT multi-image embed export (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    from PIL import Image

    model = task.build_model(cfg)
    folder = run.get("image_folder")
    case_jsons = sorted(os.path.join(folder, n) for n in os.listdir(folder)
                        if n.endswith(".json"))
    out_dir = run.get("output_dir", "output/cobsat_embeds")
    os.makedirs(out_dir, exist_ok=True)
    instruction = run.get("prompt", "")
    embedding_type = cfg.model_cfg.get("embedding_type", "output_embed")
    prefix = run.get("image_path_prefix", "")

    written = []
    for url in case_jsons:
        name = os.path.splitext(os.path.basename(url))[0]
        embed_path = os.path.join(out_dir, f"{name}.pth")
        if os.path.exists(embed_path):
            print("exists, skipping:", embed_path)
            continue
        with open(url) as f:
            case = json.load(f)
        image_paths = [os.path.join(prefix, p) if prefix else p
                       for p in case["image_inputs"]]
        text = instruction + "".join(build_word_texts(case["text_inputs"]))
        images = [Image.open(p).convert("RGB") for p in image_paths]
        conds, gen = model.get_embed(
            {"images": [images], "answers": [text]},
            embedding_type=embedding_type,
            max_new_tokens=int(run.get("max_new_tokens", 128)))
        save_pth(embed_path, conds[0])
        case["generated_text"] = gen.texts[0]
        case["prompt"] = instruction
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(case, f, indent=4)
        print("saved:", embed_path)
        written.append(embed_path)
    return written


if __name__ == "__main__":
    main()
