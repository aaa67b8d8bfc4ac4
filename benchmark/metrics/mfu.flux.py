"""mfu.flux: the operations the FLUX transformer required
(``work/flux.py``: each stream's projections, the joint attention at its
length) over the window's seconds, VAE included, as a share of 989 bf16
TFLOP/s. Moves image_s."""

from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "flux_step")
