"""Seeded random weights in a published checkpoint's key layout, made on
the device in a few large draws.

A spec is a list of (key, shape, init): ``("normal", std)``,
``("uniform", lo, hi)`` or ``("zeros",)``. ``make`` draws every normal
leaf in one flat buffer and every uniform leaf in another, from one
generator seeded with ``seed``, in chunks, then scales each leaf's view;
the same spec, seed and device give the same weights, so the reference
makes them again rather than reading what the program holds."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28


def _fill(buf: torch.Tensor, kind: str, gen: torch.Generator) -> None:
    for i in range(0, buf.numel(), CHUNK):
        part = buf[i:i + CHUNK]
        if kind == "normal":
            part.normal_(0.0, 1.0, generator=gen)
        else:
            part.uniform_(0.0, 1.0, generator=gen)


@torch.no_grad()
def make(spec: List[Tuple], seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in spec:
        if init[0] in sizes:
            sizes[init[0]] += math.prod(shape)
    flat = {k: torch.empty(n, dtype=dtype, device=device)
            for k, n in sizes.items()}
    for k in ("normal", "uniform"):
        _fill(flat[k], k, gen)
    out, offset = {}, {"normal": 0, "uniform": 0}
    for key, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "zeros":
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        view = flat[init[0]][offset[init[0]]:offset[init[0]] + n].view(shape)
        offset[init[0]] += n
        if init[0] == "normal":
            view.mul_(init[1])
        else:
            view.mul_(init[2] - init[1]).add_(init[1])
        out[key] = view
    return out
