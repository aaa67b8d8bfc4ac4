"""vae_ms.flux: milliseconds an image in ``FluxSampler.decode`` (the
VAE decoder), a span synchronized on both sides. Moves image_s."""

from benchmark.readers import span_ms


def read(rec):
    return span_ms(rec, "flux_step", ("decode",), per="images")
