"""fwd_ms.train: device milliseconds a step of the kernels, copies and
sets launched inside the program's ``train.forward`` span (the loss,
chunked CE included), in the profiled pass. Moves train_samples_per_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "train_step", "train.forward", "train.step")
