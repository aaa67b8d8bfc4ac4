"""idle.flux: the share of the profiled request with no kernel, copy or
set running on the card. Moves image_s."""

from benchmark.readers import idle


def read(rec):
    return idle(rec, "flux_step")
