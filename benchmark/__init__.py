"""The benchmark of ``thinkdiff_torch`` on NVIDIA H100 cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Driven by data: ``BENCHMARK.json`` names the cells and metrics; each cell
has ``workloads/<cell>.json`` (its configuration, traffic mix and driver),
each configuration ``configs/<config>.json``, each traffic mix
``traffic/<traffic>.json`` (parameters read by one generator of
``traffic/``), each driver ``drivers/<driver>.py`` and each per-layer
metric ``metrics/<metric>.py``. ``work/`` counts the operations and bytes
an operation needs from its shapes; ``kernels/<operation>/*.txt`` lists
the kernel names that count as that operation's device time;
``reference/`` holds the plain float32 references that decide
``correct``. Nothing here imports JAX or the JAX package.
"""
