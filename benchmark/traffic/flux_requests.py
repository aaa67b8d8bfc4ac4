"""Rendering requests of ThinkDiff-LVLM inference: each request is one
``ThinkDiffPipeline.generate`` call of ``batch`` rows at ``height`` x
``width``, conditioned on ``tokens`` aligned tokens of the transformer's
``joint_attention_dim`` (the projector's output: unit-RMS rows, here
N(0, 1) draws) and seeded noise. Request ``i`` of a run draws its tokens
and its noise seed from (run seed, i): every run seed gives the same shapes."""

from __future__ import annotations

import torch


# keeps the tokens' draw apart from the noise's for the same request
TOKENS_OFFSET = 0x5DEECE66D


def request_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) % (1 << 62)


def shapes(params: dict) -> dict:
    return {"batch": int(params["batch"]), "height": int(params["height"]),
            "width": int(params["width"]), "tokens": int(params["tokens"])}


def tokens(params: dict, config: dict, seed: int, i: int, device,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Request ``i``'s condition tokens (batch, tokens, joint_dim)."""
    s = shapes(params)
    gen = torch.Generator(device=device).manual_seed(
        (request_seed(seed, i) + TOKENS_OFFSET) % (1 << 62))
    return torch.randn((s["batch"], s["tokens"],
                        config["transformer"]["joint_attention_dim"]),
                       generator=gen, device=device, dtype=torch.float32
                       ).to(dtype)


def noise(params: dict, config: dict, seed: int, i: int, device):
    """Request ``i``'s initial packed latents (batch, img tokens, 4 x
    latent channels), f32: the draw the sampler makes for the request's
    noise seed (a normal draw of a generator seeded with it on the
    device), which the reference makes again from the seed."""
    s = shapes(params)
    img = (s["height"] // 16) * (s["width"] // 16)
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, i))
    return torch.randn((s["batch"], img,
                        4 * config["vae"]["latent_channels"]),
                       generator=gen, dtype=torch.float32, device=device)
