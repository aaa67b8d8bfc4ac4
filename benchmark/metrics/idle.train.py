"""idle.train: the share of the profiled training steps with no
kernel, copy or set running on the card. Moves train_samples_per_s."""

from benchmark.readers import idle


def read(rec):
    return idle(rec, "train_step")
