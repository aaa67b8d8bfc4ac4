"""LoRA adapters over a frozen parameter tree (counterpart of
thinkdiff_tpu/models/lora.py; the reference wraps its Llama in peft's
``get_peft_model(LoraConfig(r=lora_r, target_modules=["q_proj",
"v_proj"]))``, thinkdiff/models/base_model.py:171-207).

As in the JAX package the adapters are a tree of their own, {"<path of the
target kernel>": {"a": (in, r), "b": (r, out)}}, merged into the base
weights functionally, ``W + scale * a @ b`` formed in f32 and cast back to
W's dtype; the base tree stays frozen and the adapters are the only
trainable leaves. Trees are the weight bridge's nested dicts of tensors
(``bridge.tree_of``): numpy leaves are taken too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

DEFAULT_TARGETS = ("q_proj", "v_proj")  # peft LoraConfig's in the reference


def _target_kernels(params: Any, targets: Sequence[str]):
    """(path, leaf) of every 2-D ``<target>/kernel`` leaf, in the tree's
    order."""
    from thinkdiff_torch.models.bridge import flatten

    for path, leaf in flatten(params).items():
        keys = path.split("/")
        if (len(keys) >= 2 and keys[-1] == "kernel" and keys[-2] in targets
                and getattr(leaf, "ndim", 0) == 2):
            yield path, leaf


def init_lora(generator: torch.Generator, params: Any, r: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              alpha: Optional[float] = None,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """For each target kernel (in, out): ``a`` (in, r) kaiming-uniform,
    U(-1/sqrt(in), 1/sqrt(in)) drawn from ``generator`` on its device, and
    ``b`` (r, out) zeros, so the merged model is the base model at init.
    Raises ValueError when the tree has no target (a fused ``qkv``, or
    quantized kernels)."""
    kernels = list(_target_kernels(params, targets))
    if not kernels:
        raise ValueError(f"no LoRA targets {tuple(targets)} in param tree")
    dev = generator.device
    layers = {}
    for path, leaf in kernels:
        d_in, d_out = leaf.shape
        bound = 1.0 / d_in ** 0.5
        a = torch.rand((d_in, r), generator=generator, device=dev)
        layers[path] = {"a": (a * (2 * bound) - bound).to(dtype),
                        "b": torch.zeros((r, d_out), dtype=dtype, device=dev)}
    return layers


def lora_scale(r: int, alpha: Optional[float] = None) -> float:
    """peft's multiplier: alpha / r (alpha defaults to r)."""
    return float(alpha if alpha is not None else r) / float(r)


def merge_lora(params: Any, adapters: Dict[str, Any],
               scale: float = 1.0) -> Any:
    """``params`` with every adapted kernel replaced by ``W + scale * a @
    b``, computed in f32 and cast back to W's dtype (differentiable in the
    adapters); every other leaf is passed through as it is."""
    from thinkdiff_torch.models.bridge import to_tensor

    def rebuild(tree, prefix):
        if not isinstance(tree, dict):
            ad = adapters.get(prefix)
            if ad is None:
                return tree
            w = to_tensor(tree)
            delta = (to_tensor(ad["a"]).float()
                     @ to_tensor(ad["b"]).float()) * scale
            return (w.float() + delta).to(w.dtype)
        return {k: rebuild(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}

    return rebuild(params, "")


def lora_param_count(adapters: Dict[str, Any]) -> int:
    return sum(int(leaf.numel()) for layer in adapters.values()
               for leaf in layer.values())
