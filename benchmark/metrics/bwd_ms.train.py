"""bwd_ms.train: device milliseconds a step of what the program's
``train.backward`` span launched (``torch.autograd.grad``; autograd's
device thread launches inside it), in the profiled pass. Moves
train_samples_per_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "train_step", "train.backward", "train.step")
