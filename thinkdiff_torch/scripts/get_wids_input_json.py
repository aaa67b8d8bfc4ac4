"""Write a wids-shard-index-v1 JSON over a set of tar shards, counting each
shard's samples in a process pool (counterpart of
scripts/get_wids_input_json.py; reference
scripts/get_wids_input_json_para.py:10-49).

    python -m thinkdiff_torch.scripts.get_wids_input_json \\
        --shards '/data/cc_sbu/{00000..01254}.tar' \\
        --output configs/datasets/cc_sbu_wids_shards.json --name cc_sbu \\
        [--items-per-sample 2] [--workers 16]

``--shards`` is a brace pattern or comma-separated paths; paths that do
not exist are skipped. A shard's count is its distinct keys, or its files
divided by ``--items-per-sample``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os

from thinkdiff_torch.data.tario import brace_expand, build_tar_index


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--shards", required=True,
                        help="brace pattern or comma-separated tar paths")
    parser.add_argument("--output", required=True)
    parser.add_argument("--name", default="dataset")
    parser.add_argument("--items-per-sample", type=int, default=None)
    parser.add_argument("--workers", type=int, default=16)
    args = parser.parse_args(argv)

    shards = []
    for part in args.shards.split(","):
        shards.extend(brace_expand(part.strip()))
    shards = [s for s in shards if os.path.exists(s)]
    work = [(s, args.items_per_sample) for s in shards]
    workers = max(1, min(args.workers, len(shards)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        entries = pool.starmap(build_tar_index, work)
    index = {
        "__kind__": "wids-shard-index-v1",
        "wids_version": 1,
        "name": args.name,
        "shardlist": entries,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(index, f, indent=4)
    total = sum(e["nsamples"] for e in entries)
    print(f"indexed {len(entries)} shards, {total} samples -> {args.output}")
    return index


if __name__ == "__main__":
    main()
