"""residual_ms.flux: device milliseconds a denoise step of what the
program's ``flux.residual`` spans launched (each gated residual add, its
projection outside the span), in the profiled request. Moves image_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "flux_step", "flux.residual", "flux.step")
