"""Stage 1, the embedding precompute CLI: the VLM engine over a
wids-indexed image dataset, written out as WebDataset embedding shards.

    python -m thinkdiff_torch.scripts.generate_embedding_webdataset \\
        --cfg-path configs/qwen2_vl_embed_ccsbu.yaml [--options k=v ...] \\
        [--device cpu]

On N cards, ``python -m torch.distributed.run --nproc_per_node N -m
thinkdiff_torch.scripts.generate_embedding_webdataset ...``: rank r reads
its share of the images and writes its own shard range.
"""

from __future__ import annotations

from thinkdiff_torch.scripts.common import bootstrap, build_runner, parse_args


def main(argv=None):
    args = parse_args("ThinkDiff embedding precompute (PyTorch)", argv)
    cfg, task = bootstrap(args)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    runner = build_runner(cfg, task, model, datasets, args.job_id,
                          "runner_process_data")
    stats = runner.train()
    print(stats)
    return stats


if __name__ == "__main__":
    main()
