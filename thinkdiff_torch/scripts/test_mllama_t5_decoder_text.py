"""ThinkDiff-LVLM text-only inference: prompts with no images through the
inference model's text APIs, written to ``{output_dir}/{mode}_results.json``.

Modes (``run.mode``):
  get_text   VLM text generation only (engine decode, no T5).
  generate   the composed chain: VLM generate -> hidden tap -> projector ->
             per-sample T5 greedy decode -> T5 text.

Prompts come from ``run.prompts`` (a list) or ``run.prompt_json`` (a JSON
list). With ``run.raw_prompts=True`` they are fed pre-formatted (tokenized
as they are, no chat template); otherwise they go through the engine's
chat template with no vision parts.

    python -m thinkdiff_torch.scripts.test_mllama_t5_decoder_text \\
        --cfg-path configs/test_thinkdiff_lvlm_ccsbu_image_text.yaml \\
        --options run.mode=get_text "run.prompts=['tell me a story']" \\
        [--device cpu]
"""

from __future__ import annotations

import json
import os

from thinkdiff_torch.scripts.common import bootstrap, parse_args


def main(argv=None):
    args = parse_args("ThinkDiff-LVLM text-only inference (PyTorch)", argv)
    cfg, task = bootstrap(args)
    run = cfg.run_cfg

    model = task.build_model(cfg)

    if run.get("prompt_json"):
        with open(run["prompt_json"]) as f:
            prompts = json.load(f)
    else:
        prompts = list(run.get("prompts", []))
    if not prompts:
        raise ValueError("set run.prompts or run.prompt_json")

    mode = run.get("mode", "get_text")
    max_new_tokens = int(run.get("max_new_tokens", 128))
    out_dir = run.get("output_dir", "output/lvlm_text")
    os.makedirs(out_dir, exist_ok=True)

    raw = bool(run.get("raw_prompts", False))
    if mode == "get_text":
        inputs = ([{"prompt": p} for p in prompts] if raw
                  else {"answers": prompts, "images": [None] * len(prompts)})
        texts = model.get_text(inputs, need_process=not raw,
                               max_new_tokens=max_new_tokens)
        records = [{"prompt": p, "generated_text": t}
                   for p, t in zip(prompts, texts)]
    else:
        samples = (model._vllm_inputs_to_samples([{"prompt": p}
                                                  for p in prompts]) if raw
                   else {"answers": prompts, "images": [None] * len(prompts)})
        outs, t5_texts, vlm_texts = model.generate(
            samples, embedding_type=run.get("embedding_type", "both"),
            max_new_tokens=max_new_tokens,
            t5_max_new_tokens=int(run.get("t5_max_new_tokens", 32)))
        records = [{"prompt": p, "generated_text": v, "t5_text": t,
                    "t5_token_ids": o}
                   for p, v, t, o in zip(prompts, vlm_texts, t5_texts, outs)]

    out_path = os.path.join(out_dir, f"{mode}_results.json")
    with open(out_path, "w") as f:
        json.dump(records, f, indent=2)
    for r in records:
        print(f"prompt: {r['prompt']!r}\n  -> {r['generated_text']!r}")
        if "t5_text" in r:
            print(f"  t5 -> {r['t5_text']!r}")
    print("saved:", out_path)
    return records


if __name__ == "__main__":
    main()
