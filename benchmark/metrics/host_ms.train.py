"""host_ms.train: the host's milliseconds a training step in
``Trainer.prepare_batch`` plus ``Trainer.train_step``, from each call
until it returns, with no synchronize: what the host takes to enqueue a
step. Moves train_samples_per_s."""

from benchmark.readers import span_ms


def read(rec):
    return span_ms(rec, "train_step", ("prepare_batch", "train_step"),
                   per="steps")
