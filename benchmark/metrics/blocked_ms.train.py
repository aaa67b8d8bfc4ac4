"""blocked_ms.train: host milliseconds a step inside CUDA runtime and
driver calls begun in the program's ``train.prepare_batch`` or
``train.step`` spans, on any thread, each call's time beyond its first
20 us (an enqueue returns sooner: the rest is a synchronize, a pageable
copy or a full launch queue), in the profiled pass. Read against
host_ms.train. Moves train_samples_per_s."""

from benchmark.program_trace import blocked_ms


def read(rec):
    return blocked_ms(rec, "train_step",
                      ("train.prepare_batch", "train.step"), "train.step")
