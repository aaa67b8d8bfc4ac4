"""mfu.train: the operations the training steps required
(``work/t5_aligner.py``, from the batches' unpadded lengths: forward,
input gradients through the frozen decoder, the projector's weight
gradients) over the window's seconds, as a share of 989 bf16 TFLOP/s.
Moves train_samples_per_s."""

from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "train_step")
