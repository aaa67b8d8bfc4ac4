"""attn_roofline.train: the least time the step's attention calls
could take (``work/attention.py`` at the padded batch shapes: the
forward of every self- and cross-attention, the backward of all but
block 0's self-attention) over the device time of the kernels in
``kernels/attention/`` (#1, #5, #6), in the profiled steps. Moves
train_samples_per_s."""

from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "train_step", "attention")
