"""CoBSAT embed exporter, batched: the case JSONs of
``run.cobsat_json_dir`` (``{text_inputs, image_inputs}``) in batches of
``run.batch_size_eval`` (default 4) through the LVLM aligner ("Word k:
<attr>," items with their images), -> ``{output_dir}/{case}.npy`` (the
aligned tokens, f32) and ``{case}.json`` (generated_text,
output_token_ids). Existing exports are skipped; image paths are joined to
``run.image_path_prefix`` when it is set.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_flux_embed_multi_image_batch \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.cobsat_json_dir=cases/ [--device cpu]
"""

from __future__ import annotations

import json
import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def main(argv=None):
    args = parse_args("CoBSAT batch embed export (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    import numpy as np
    from PIL import Image

    model = task.build_model(cfg)
    spec_dir = run.get("cobsat_json_dir")
    out_dir = run.get("output_dir", "output/cobsat_embeds")
    prefix = run.get("image_path_prefix", "")
    batch_size = int(run.get("batch_size_eval", 4))
    os.makedirs(out_dir, exist_ok=True)

    pending = []
    for fname in sorted(f for f in os.listdir(spec_dir) if f.endswith(".json")):
        case = os.path.splitext(fname)[0]
        out_path = os.path.join(out_dir, f"{case}.npy")
        if os.path.exists(out_path):  # resume: skip what is exported
            continue
        with open(os.path.join(spec_dir, fname)) as f:
            pending.append((case, json.load(f), out_path))

    written = []
    for i in range(0, len(pending), batch_size):
        chunk = pending[i: i + batch_size]
        images, texts = [], []
        for _, spec, _ in chunk:
            paths = [os.path.join(prefix, p) if prefix else p
                     for p in spec["image_inputs"]]
            images.append([Image.open(p) for p in paths])
            texts.append(" ".join(f"Word {j + 1}: {w},"
                                  for j, w in enumerate(spec["text_inputs"])))
        conds, gen = model.get_embed(
            {"images": images, "answers": texts},
            embedding_type=run.get("embedding_type", "output_embed"),
            max_new_tokens=int(run.get("max_new_tokens", 128)))
        for j, (case, _, out_path) in enumerate(chunk):
            np.save(out_path, conds[j].float().cpu().numpy())
            with open(out_path.replace(".npy", ".json"), "w") as f:
                json.dump({"generated_text": gen.texts[j],
                           "output_token_ids": gen.output_token_ids[j]}, f)
            written.append(out_path)
        print(f"[{i + len(chunk)}/{len(pending)}] exported")
    return written


if __name__ == "__main__":
    main()
