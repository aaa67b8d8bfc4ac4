"""rmsnorm_roofline.flux: the least time the per-head q/k RMSNorm calls
of the profiled request could take (their bytes) over the device time of
the kernels in ``kernels/rmsnorm/`` (#3). Moves image_s."""

from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "flux_step", "rmsnorm")
