"""rope_ms.flux: device milliseconds a denoise step of what the program's
``flux.rope`` spans launched (the stream concats of q, k, v and RoPE,
between the q/k norm and #1), in the profiled request. Moves image_s."""

from benchmark.program_trace import device_ms


def read(rec):
    return device_ms(rec, "flux_step", "flux.rope", "flux.step")
