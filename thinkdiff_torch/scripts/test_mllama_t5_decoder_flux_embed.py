"""Single-image aligned-embed exporter: the LVLM aligner on one image and
question, its aligned conditioning tokens saved without sampling FLUX (the
export half of the export / replay workflow) ->
``{output_dir}/{image name}.npy`` (f32, ``np.save``) and a ``.json`` beside
it (generated_text, output_token_ids, input_prompt).

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_embed \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.image_path=... run.text_input="..." [--device cpu]

An existing export is kept (``run.skip_if_exists``, default true).
"""

from __future__ import annotations

import json
import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def main(argv=None):
    args = parse_args("LVLM aligned-embed export (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    import numpy as np
    from PIL import Image

    model = task.build_model(cfg)
    image_path = run.get("image_path")
    text_input = run.get("text_input", "")
    out_dir = run.get("output_dir", "output/lvlm_embeds")
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(image_path))[0]
    out_path = os.path.join(out_dir, f"{name}.npy")
    if os.path.exists(out_path) and run.get("skip_if_exists", True):
        print("exists, skipping:", out_path)
        return out_path

    samples = {"images": [Image.open(image_path)], "answers": [text_input]}
    conds, gen = model.get_embed(
        samples, embedding_type=run.get("embedding_type", "output_embed"),
        max_new_tokens=int(run.get("max_new_tokens", 128)))
    np.save(out_path, conds[0].float().cpu().numpy())
    with open(out_path.replace(".npy", ".json"), "w") as f:
        json.dump({"generated_text": gen.texts[0],
                   "output_token_ids": gen.output_token_ids[0],
                   "input_prompt": gen.input_prompts[0]}, f)
    print("saved:", out_path)
    return out_path


if __name__ == "__main__":
    main()
