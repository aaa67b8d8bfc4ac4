"""attn_roofline.flux: the least time the joint attention calls of the
profiled request could take over the device time of the kernels in
``kernels/attention/`` (#1). Moves image_s."""

from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "flux_step", "attention")
