"""Embedding-precompute task: the VLM engine over an image dataset,
streamed out as WebDataset shards (counterpart of
thinkdiff_tpu/tasks/image_text_process_data.py).

Each sample's fields have the reference's layout: the enriched ``json``,
``{layer}.input_embed.pth`` and ``{layer}.output_embed.pth`` (bf16 torch
tensors, as the reference's vLLM-written shards hold) and the ``jpg``.
The engine's hidden states may be views of larger buffers; the shard
writer saves a compact copy of each.
"""

from __future__ import annotations

import logging
import os

from thinkdiff_torch.core.logging import MetricLogger, SmoothedValue
from thinkdiff_torch.core.registry import registry
from thinkdiff_torch.data.tario import ShardWriter
from thinkdiff_torch.tasks.base_task import BaseTask

logger = logging.getLogger(__name__)

SHARD_MAXSIZE = 5e8  # payload bytes a shard, the reference's


@registry.register_task("image_text_process_data")
class ImageTextProcessDataTask(BaseTask):
    def process_epoch(self, model, data_loader, output_shard_path,
                      log_freq: int = 1, max_batches=None):
        """output_shard_path: [dir, pattern, start_shard] (the config's
        ``run.output_shard_path``). Returns the samples and shards
        written."""
        shard_dir, pattern, start_shard = output_shard_path
        os.makedirs(shard_dir, exist_ok=True)
        writer = ShardWriter(os.path.join(shard_dir, pattern),
                             maxsize=SHARD_MAXSIZE,
                             start_shard=int(start_shard))
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("samples", SmoothedValue(fmt="{value:.0f}"))

        n_total = 0
        with writer:
            for bi, batch in enumerate(
                    metric_logger.log_every(data_loader, log_freq, "Process:")):
                if max_batches is not None and bi >= max_batches:
                    break
                result = model.forward(batch)
                layer = result.get("embedding_layer_name", "model.norm")
                for i in range(len(result["generated_texts"])):
                    payload = dict(batch["jsons"][i]) if batch.get("jsons") else {}
                    payload.update({
                        "generated_text": result["generated_texts"][i],
                        "input_prompt": result["input_prompts"][i],
                        "input_prompt_token_ids": [
                            int(t) for t in result["prompt_token_ids"][i]],
                        "output_text": result["generated_texts"][i],
                        "output_token_ids": [
                            int(t) for t in result["output_token_ids"][i]],
                    })
                    sample = {
                        "__key__": batch["filenames"][i] or f"{n_total:09d}",
                        "json": payload,
                        f"{layer}.input_embed.pth":
                            result["prompt_hidden_states"][i],
                        f"{layer}.output_embed.pth": result["hidden_states"][i],
                    }
                    if batch.get("images") is not None:
                        sample["jpg"] = batch["images"][i]
                    writer.write(sample)
                    n_total += 1
                metric_logger.update(samples=n_total)
        logger.info("Wrote %d samples into shards at %s", n_total, shard_dir)
        return {"num_samples": n_total,
                "num_shards": writer.shard - int(start_shard)}
