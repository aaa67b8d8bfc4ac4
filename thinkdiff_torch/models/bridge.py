"""The weight bridge: JAX-layout parameter trees <-> the port's modules.

A JAX parameter tree (nested dicts; numpy leaves, ml_dtypes bf16 included,
or torch tensors) names each leaf by its path, e.g.
``decoder/layer_0/self_attn/qkv/kernel_q``. The port's modules carry the
same names with dots, and the JAX layouts (kernels (in, out), int8 kernels
(K, N) with a per-column scale, fused qkv/gate_up), so loading is a copy
per leaf and ``params_of`` is its exact inverse.

A module sharded over a mesh (parallel/sharding.py) holds its rank's
blocks: ``load_params`` of a whole JAX tree copies each rank's block of
each leaf, and ``tree_of`` gathers the blocks back into JAX's whole
layout (a collective: every rank of the mesh calls it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': leaf} -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def to_tensor(leaf: Any) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) or torch leaf -> torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy; bf16 becomes ml_dtypes bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _targets(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def load_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX-layout tree into ``module`` in place. Every leaf must name
    one of the module's parameters or buffers with the same shape, and every
    one of those must be given. The copy keeps the module's dtype, device
    and memory layout (QDense's int8 kernels stay in the transposed storage
    the s8 kernel reads); a training QDense then remakes its (K, N) copy."""
    targets = _targets(module)
    pls, mesh = getattr(module, "_placements", None), getattr(
        module, "_mesh", None)
    flat = {k.replace("/", "."): v for k, v in flatten(tree).items()}
    missing = sorted(set(targets) - set(flat))
    unexpected = sorted(set(flat) - set(targets))
    if missing or unexpected:
        raise KeyError(f"load_params: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    with torch.no_grad():
        for name, leaf in flat.items():
            dst, src = targets[name], to_tensor(leaf)
            if pls is not None:
                from thinkdiff_torch.core.distributed import get_rank
                from thinkdiff_torch.parallel.sharding import local_block

                src = local_block(src, pls[name], mesh,
                                  mesh.coords(get_rank()))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"load_params: {name} has shape "
                                 f"{tuple(src.shape)}, module wants "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    for m in module.modules():
        if hasattr(m, "sync_train_layout"):
            m.sync_train_layout()
    return module


def own_leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s own parameters and buffers (not its children's)."""
    return {k: v for k, v in {**module._parameters,
                              **module._buffers}.items() if v is not None}


@torch.no_grad()
def fill_(module: nn.Module, draw) -> nn.Module:
    """``module``'s leaves in place, submodule by submodule in
    ``modules()`` order, from ``draw(name, submodule, own_leaves)`` (the
    full values; ``parallel.sharding.build_sharded`` takes the same
    ``draw``); a training QDense then remakes its (K, N) copy."""
    for name, sub in module.named_modules():
        own = own_leaves(sub)
        if own:
            for k, v in draw(name, sub, own).items():
                getattr(sub, k).copy_(v)
        if hasattr(sub, "sync_train_layout"):
            sub.sync_train_layout()
    return module


def tree_draw(tree: Dict[str, Any]):
    """A ``fill_`` / ``parallel.sharding.build_sharded`` draw that reads a
    JAX-layout tree: the full leaves of one submodule at a time."""
    flat = {k.replace("/", "."): v for k, v in flatten(tree).items()}

    def draw(name, _, own):
        pre = f"{name}." if name else ""
        return {k: to_tensor(flat[pre + k]) for k in own}

    return draw


def tree_of(module: nn.Module,
            leaf_fn: Callable[[str, torch.Tensor], Any]) -> Dict[str, Any]:
    """The module's parameters and buffers as a JAX-layout tree, each leaf
    mapped by ``leaf_fn(dotted_name, tensor)``; a sharded module's leaves
    whole (gathered)."""
    pls, mesh = getattr(module, "_placements", None), getattr(
        module, "_mesh", None)
    if pls is not None:
        from thinkdiff_torch.parallel.sharding import gather_leaf

        return unflatten({
            name.replace(".", "/"): leaf_fn(name, gather_leaf(
                t, pls[name], mesh)) for name, t in _targets(module).items()})
    return unflatten({name.replace(".", "/"): leaf_fn(name, t)
                      for name, t in _targets(module).items()})


def params_of(module: nn.Module) -> Dict[str, Any]:
    """Inverse of ``load_params``: the module's weights as a numpy tree."""
    return tree_of(module, lambda _, t: to_numpy(t))


def local_hf_dir(repo_or_path: str):
    """The local directory of an HF repo id or path (the directory itself,
    or the newest hub-cache snapshot), or None when it is not on disk."""
    import os

    path = os.path.expanduser(repo_or_path)
    if os.path.isdir(path):
        return path
    cache = os.environ.get("HF_HOME") or os.path.expanduser(
        "~/.cache/huggingface")
    snaps = os.path.join(cache, "hub", "models--" + repo_or_path.replace(
        "/", "--"), "snapshots")
    if os.path.isdir(snaps) and os.listdir(snaps):
        path = os.path.join(snaps, sorted(os.listdir(snaps))[-1])
        if os.path.isdir(path):
            return path
    return None


def local_hf_state_dict(repo_or_path: str):
    """A local HF checkpoint (directory or hub-cache snapshot: its
    ``*.safetensors``, else its ``pytorch_model*.bin``) as a numpy state
    dict, or None when it is not on disk. Never downloads."""
    import glob
    import os

    path = local_hf_dir(repo_or_path)
    if path is None:
        return None
    out: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if files:
        from safetensors.numpy import load_file

        for f in files:
            out.update(load_file(f))
        return out
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not files:
        return None
    for f in files:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        out.update({k: to_numpy(v) for k, v in sd.items()})
    return out
