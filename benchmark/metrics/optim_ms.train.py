"""optim_ms.train: device milliseconds a step of what the program's
``train.optimizer`` span launched (AdamW and its clip), in the profiled
pass. Moves train_samples_per_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "train_step", "train.optimizer", "train.step")
