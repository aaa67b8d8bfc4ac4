"""host_gap_ms.train: device-idle milliseconds a step in the gaps that
began while the host was inside the program's ``train.step`` span: idle
that the host's own enqueue made, in the profiled pass. Moves
train_samples_per_s."""

from benchmark.program_trace import host_gap_ms


def read(rec):
    return host_gap_ms(rec, "train_step", "train.step", "train.step")
