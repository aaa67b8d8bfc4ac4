"""norm_mod_ms.flux: device milliseconds a denoise step of what the
program's ``flux.norm_mod`` spans launched (each block's LayerNorm and
modulation), in the profiled request. Moves image_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "flux_step", "flux.norm_mod", "flux.step")
