"""launches.train: kernels a step launched inside the program's
``train.step`` span, every library's (not only the port's hand-written
ones), in the profiled pass. Moves train_samples_per_s."""

from benchmark.program_trace import launches


def read(rec):
    return launches(rec, "train_step", "train.step", "train.step")
