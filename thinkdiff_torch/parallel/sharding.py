"""Parameter and batch sharding rules (counterpart of
thinkdiff_tpu/parallel/sharding.py).

JAX declares its parallelism as PartitionSpec rules matched against the
parameter paths and lets GSPMD insert the collectives. The port keeps the
same rules, in the same order, as tuples of axis names: each leaf's spec
says which mesh axis splits which of its dimensions, and ``valid_spec``
turns an axis that does not divide its dimension back into replication,
as JAX's ``_valid_spec`` does. Each rank then keeps the block of every
frozen leaf that JAX's rules give the device at its coordinate
(``shard_params``, ``build_sharded``), and the modules do by hand what
GSPMD does: the fsdp dimension is gathered where a layer runs
(``parallel/collectives.py``), a ``model``-sharded layer computes its
share of the product and reduces or gathers over the model group.

One liberty against JAX's placement: a fused projection (``qkv``,
``kv_fused``, ``wi_fused``, ``gate_up``) sharded over ``model`` holds
JAX's count of columns on each rank, but arranged by part (q|k|v, k|v,
gate|up), rank m holding block m of every part, so its share of the
product is whole heads and whole gate/up pairs. The parts are given by
their widths: equal ones by default, a layer's own ``tp_widths`` where
they differ (Qwen2's GQA ``qkv`` is H hd | Hkv hd | Hkv hd). ``tree_of``
and ``load_params`` (models/bridge.py) undo and apply that order, so
trees cross in JAX's layout. Where a part does not split into whole units
(the layer's ``tp_unit``: its head size) the leaf keeps JAX's contiguous
block and the layer gathers its output.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from thinkdiff_torch.parallel.mesh import (
    DATA_AXIS, FSDP_AXIS, MODEL_AXIS, Mesh, set_mesh)

Spec = Tuple[Optional[str], ...]

# Each rule: (regex over the 'a/b/c' parameter path, spec). First match
# wins. Dense kernels are (in, out): q/k/v-like projections and MLP inputs
# split their output columns over ``model`` (column parallel), output
# projections their input rows (row parallel); any embedding table
# (vocab, dim) splits its vocabulary over ``model``; every other kernel
# splits its first dimension over ``fsdp``; the rest is replicated.
DEFAULT_RULES: Sequence[Tuple[str, Spec]] = (
    (r".*(q_proj|k_proj|v_proj|wi|wi_0|wi_1|wi_fused|kv_fused|fc1|up_proj|gate_proj|gate_up|to_q|to_k|to_v|qkv|ff1)/kernel$",
     (FSDP_AXIS, MODEL_AXIS)),
    (r".*(o_proj|wo|fc2|down_proj|to_out|proj_out|ff2)/kernel$",
     (MODEL_AXIS, FSDP_AXIS)),
    (r".*/embedding$", (MODEL_AXIS, FSDP_AXIS)),
    (r".*lm_head/kernel$", (FSDP_AXIS, MODEL_AXIS)),
    (r".*kernel$", (FSDP_AXIS, None)),
    (r".*", ()),
)

# the parts of a fused projection, in its column order (equal widths
# unless the layer gives its own ``tp_widths``)
FUSED_PARTS = {"qkv": 3, "kv_fused": 2, "wi_fused": 2, "gate_up": 2}


def _spec_for_name(name: str, rules) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, name):
            return tuple(spec)
    return ()


def spec_for_param(name: str, ndim: int, rules=DEFAULT_RULES) -> Spec:
    """The raw rule spec of the leaf at path ``name`` ('a/b/c') of rank
    ``ndim``. The quantized triplet follows its float kernel: ``kernel_q``
    the kernel's (in, out) spec, ``kernel_scale`` (out,) its out axis,
    ``input_scale`` (in,) its in axis. Axes past the leaf's rank are
    dropped."""
    base, _, leaf = name.rpartition("/")
    if leaf in ("kernel_q", "kernel_scale", "input_scale"):
        kspec = list(_spec_for_name(base + "/kernel", rules)) + [None, None]
        axes = {"kernel_q": kspec[:2], "kernel_scale": [kspec[1]],
                "input_scale": [kspec[0]]}[leaf]
    else:
        axes = list(_spec_for_name(name, rules))
    return tuple(axes[:ndim])


def valid_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """``spec`` with every axis that does not evenly divide its dimension,
    or whose mesh size is 1, cleared."""
    out = []
    for i, axis in enumerate(spec):
        size = mesh.shape[axis] if axis is not None else 1
        ok = axis is not None and i < len(shape) and size > 1 \
            and shape[i] % size == 0
        out.append(axis if ok else None)
    return tuple(out)


def shard_spec_tree(tree: Dict[str, Any], mesh: Optional[Mesh] = None,
                    rules=DEFAULT_RULES) -> Dict[str, Any]:
    """The spec tree of a parameter tree (leaves: anything with ``shape``),
    raw without ``mesh``, demoted to what divides with it."""
    def rec(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = rec(v, path + "/")
            else:
                s = spec_for_param(path, len(v.shape), rules)
                out[k] = valid_spec(s, v.shape, mesh) if mesh else s
        return out

    return rec(tree, "")


# -- one leaf's placement ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf of full ``shape`` lives: ``spec`` (after ``valid_spec``)
    and, for a fused leaf whose ``model`` dimension is arranged by part,
    that dimension and the parts' widths; ``fused`` marks a fused leaf
    whether or not it is arranged."""
    shape: Tuple[int, ...]
    spec: Spec
    parts_dim: Optional[int] = None
    widths: Tuple[int, ...] = ()
    fused: bool = False

    @property
    def parts(self) -> int:
        return len(self.widths) or 1

    def dim_of(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    def local_shape(self, mesh: Mesh) -> Tuple[int, ...]:
        spec = self.spec + (None,) * (len(self.shape) - len(self.spec))
        return tuple(n // (mesh.shape[a] if a else 1)
                     for n, a in zip(self.shape, spec))


def part_widths(parts, n: int) -> Tuple[int, ...]:
    """The widths of ``parts`` (a count of equal parts of ``n``, or the
    widths themselves)."""
    if isinstance(parts, int):
        return (n // parts,) * parts
    return tuple(int(w) for w in parts)


def arrange_parts(x: torch.Tensor, dim: int, parts, m: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` reordered from part-major (part, block
    of m, its width / m) to block-major (block, part, width / m); ``parts``
    is a count of equal parts or their widths."""
    widths = part_widths(parts, x.shape[dim])
    pieces = [p.unflatten(dim, (m, w // m))
              for p, w in zip(x.split(widths, dim), widths)]
    return torch.cat(pieces, dim + 1).flatten(dim, dim + 1)


def unarrange_parts(x: torch.Tensor, dim: int, parts, m: int) -> torch.Tensor:
    """The inverse of ``arrange_parts``."""
    widths = part_widths(parts, x.shape[dim])
    blocks = x.unflatten(dim, (m, x.shape[dim] // m))
    pieces = blocks.split([w // m for w in widths], dim + 1)
    return torch.cat([p.flatten(dim, dim + 1) for p in pieces], dim)


def local_block(full: torch.Tensor, pl: Placement, mesh: Mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``full`` that JAX's placement (with the port's part
    order) gives the device at ``coords``."""
    x = full
    if pl.parts_dim is not None:
        x = arrange_parts(x, pl.parts_dim, pl.widths, mesh.model)
    for dim, axis in enumerate(pl.spec):
        if axis is None:
            continue
        n = x.shape[dim] // mesh.shape[axis]
        x = x.narrow(dim, coords[axis] * n, n)
    return x


# -- a module's placements ----------------------------------------------------

def _leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def _owner(module: nn.Module, dotted: str):
    path, _, leaf = dotted.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def placements(module: nn.Module, mesh: Mesh,
               rules=DEFAULT_RULES) -> Dict[str, Placement]:
    """{dotted leaf name: Placement} of every parameter and buffer of
    ``module`` (on any device, ``meta`` included) on ``mesh``; the rules
    read the JAX path of each leaf within the module (they match its
    end)."""
    out = {}
    for name, t in _leaves(module).items():
        shape = tuple(t.shape)
        owner, leaf = _owner(module, name)
        spec = valid_spec(spec_for_param(name.replace(".", "/"),
                                         len(shape), rules), shape, mesh)
        parts_dim, widths = None, ()
        md = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        layer = name.rpartition(".")[0].rpartition(".")[2]
        fused = layer in FUSED_PARTS and leaf in (
            "kernel", "kernel_q", "kernel_scale", "bias")
        if md is not None and fused and md == len(shape) - 1:
            w = part_widths(getattr(owner, "tp_widths", None)
                            or FUSED_PARTS[layer], shape[md])
            unit = getattr(owner, "tp_unit", 1)
            if sum(w) == shape[md] and all(
                    x % (mesh.model * unit) == 0 for x in w):
                parts_dim, widths = md, w
        out[name] = Placement(shape, spec, parts_dim, widths, fused)
    return out


def _set_leaf(module: nn.Module, dotted: str, value: torch.Tensor) -> None:
    owner, leaf = _owner(module, dotted)
    if leaf in owner._parameters:
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        owner._buffers[leaf] = value


def _empty_like_leaf(owner: nn.Module, leaf: str, shape, dtype, device,
                     like: Optional[torch.Tensor] = None):
    """Storage for a leaf's block: a whole leaf keeps the strides of
    ``like`` (the layout its layer reads, e.g. a channels-last conv
    kernel)."""
    if like is not None and tuple(like.shape) == tuple(shape):
        return torch.empty_like(like, dtype=dtype, device=device)
    if leaf == "kernel_q":
        # the transposed storage the s8 kernel reads (models/qdense.py)
        return torch.empty(shape[::-1], dtype=dtype, device=device).t()
    return torch.empty(shape, dtype=dtype, device=device)


def _annotate(module: nn.Module, pls: Dict[str, Placement], mesh: Mesh):
    """Records the placements: the module's whole map in ``_placements``,
    each submodule's own leaves' in its ``placement`` (a QDense takes them
    through ``set_placement``)."""
    module._placements = pls
    module._mesh = mesh
    for name, sub in module.named_modules():
        pre = f"{name}." if name else ""
        own = {k[len(pre):]: v for k, v in pls.items()
               if k.startswith(pre) and "." not in k[len(pre):]}
        if hasattr(sub, "set_placement"):
            sub.set_placement(own, mesh)
        elif own:
            sub.placement = own


@torch.no_grad()
def build_sharded(module: nn.Module, mesh: Mesh, coords: Dict[str, int],
                  device, draw: Callable[[str, nn.Module, Dict[str, Any]],
                                         Dict[str, torch.Tensor]]
                  ) -> nn.Module:
    """Materializes ``module`` (built on ``meta``) on ``device`` with this
    rank's blocks only. Submodule by submodule, in ``modules()`` order (the
    order a seeded init draws in), ``draw(name, submodule, own_leaves)``
    gives the full values of the submodule's own parameters and buffers
    (drawn or loaded, on any device); the rank keeps its blocks and drops
    the rest before the next submodule, so no rank holds the whole tree
    at once."""
    from thinkdiff_torch.models.bridge import own_leaves

    pls = placements(module, mesh)
    for name, sub in list(module.named_modules()):
        own = own_leaves(sub)
        if not own:
            continue
        full = draw(name, sub, own)
        pre = f"{name}." if name else ""
        for leaf, meta in own.items():
            value = full[leaf]
            block = local_block(value.to(device), pls[pre + leaf], mesh,
                                coords)
            dst = _empty_like_leaf(sub, leaf, block.shape, meta.dtype, device,
                                   meta)
            dst.copy_(block)
            _set_leaf(module, pre + leaf, dst)
        del full
    _annotate(module, pls, mesh)
    return module


@torch.no_grad()
def shard_params(module: nn.Module, mesh: Mesh,
                 coords: Dict[str, int]) -> nn.Module:
    """Keeps this rank's block of every leaf of a whole ``module``, in
    place (the counterpart of JAX's ``shard_params``, one rank's view); a
    leaf the placement leaves whole is kept as it is."""
    full = {k: v.detach() for k, v in _leaves(module).items()}
    # the rules read the leaf shapes before any leaf is cut
    pls = placements(module, mesh)
    for name, t in full.items():
        if pls[name].parts_dim is None and not any(pls[name].spec):
            continue
        owner, leaf = _owner(module, name)
        block = local_block(t, pls[name], mesh, coords)
        dst = _empty_like_leaf(owner, leaf, block.shape, t.dtype, t.device)
        dst.copy_(block)
        _set_leaf(module, name, dst)
    _annotate(module, pls, mesh)
    return module


def place_on_mesh(module, mesh):
    """``module`` holding this rank's blocks on ``mesh`` (made the run's:
    ``set_mesh`` refuses a mesh that is not the world's): cut in place
    from a whole module, or as it is when it was built block by block."""
    from thinkdiff_torch.core.distributed import get_rank

    set_mesh(mesh)
    if module is None or not mesh.sharded:
        return module
    if getattr(module, "_mesh", None) is not None:
        if module._mesh != mesh:
            raise ValueError(f"module built for {module._mesh}, not {mesh}")
        return module
    return shard_params(module, mesh, mesh.coords(get_rank()))


def gather_leaf(t: torch.Tensor, pl: Placement, mesh: Mesh) -> torch.Tensor:
    """The whole leaf, in JAX's layout, from every rank's block: gathered
    over ``fsdp`` and ``model`` (a collective of both groups)."""
    from thinkdiff_torch.core.distributed import all_gather
    from thinkdiff_torch.parallel.mesh import axis_group

    x = t.detach()
    fd, md = pl.dim_of(FSDP_AXIS), pl.dim_of(MODEL_AXIS)
    if fd is not None:
        x = all_gather(x.contiguous(), axis_group(FSDP_AXIS), fd)
    if md is not None:
        x = all_gather(x.contiguous(), axis_group(MODEL_AXIS), md)
    if pl.parts_dim is not None:
        x = unarrange_parts(x, pl.parts_dim, pl.widths, mesh.model)
    return x


def is_sharded(module: nn.Module) -> bool:
    mesh = getattr(module, "_mesh", None)
    return mesh is not None and mesh.sharded


def rank_bytes(pls: Dict[str, Placement], mesh: Mesh, dtypes) -> int:
    """Bytes of one device's blocks: ``dtypes`` {name: torch dtype}."""
    total = 0
    for name, pl in pls.items():
        n = 1
        for s in pl.local_shape(mesh):
            n *= s
        total += n * torch.empty((), dtype=dtypes[name]).element_size()
    return total


def batch_rows(batch: Dict[str, Any], mesh: Mesh, rank: int) -> Dict[str, Any]:
    """This rank's rows of a GLOBAL batch, split over (data, fsdp) as
    JAX's ``with_batch_constraint`` places them: reader d * F + f of
    D * F takes the rows of its block; ``model`` peers take the same."""
    c = mesh.coords(rank)
    readers = mesh.data * mesh.fsdp
    reader = c[DATA_AXIS] * mesh.fsdp + c[FSDP_AXIS]
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // readers
        out[k] = v[reader * n:(reader + 1) * n]
    return out
