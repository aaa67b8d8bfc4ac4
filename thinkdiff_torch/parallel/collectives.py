"""The collectives a sharded module inserts by hand where GSPMD would
(counterpart of the collectives XLA adds to thinkdiff_tpu's sharded
programs), over the groups of ``parallel/mesh.py``.

The three seams of a tensor-parallel tower, as autograd functions:
  ``copy_to_model``     identity forward, SUM of the input gradient over the
                        model group backward: a replicated input entering
                        a column-parallel layer (each rank's share of dx
                        is partial);
  ``reduce_from_model`` SUM over the model group forward, identity
                        backward: partial results (a row-parallel product,
                        a vocab shard's softmax sum) becoming replicated;
  ``gather_from_model`` the ranks' blocks concatenated forward, the rank's
                        own block of the gradient backward: local heads
                        before a layer the rules leave unsharded over
                        ``model``.
``fsdp_gather`` reassembles a weight's ``fsdp`` dimension where a layer
runs (ZeRO-style: every rank stores 1/F of it; no gradient, the weights
are frozen). Reductions of float partials run in f32; an integer sum is
exact in int32.

What serving adds: ``gather_from_model`` of a vocabulary shard's logits
(in the model dtype, bit for bit), ``model_all_reduce(keys, "max")`` of
the fused sampler's int64 argmax keys, and ``data_gather_objects``, the
data coordinates' host results on every rank. A collective the backend
does not have raises; none is rebuilt from another.
"""

from __future__ import annotations

import torch

from thinkdiff_torch.core.distributed import all_gather, all_reduce
from thinkdiff_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, FSDP_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size)


def model_group():
    return axis_group(MODEL_AXIS)


def model_size() -> int:
    return axis_size(MODEL_AXIS)


def model_index() -> int:
    return axis_index(MODEL_AXIS)


def fsdp_size() -> int:
    return axis_size(FSDP_AXIS)


def fsdp_gather(t: torch.Tensor, dim) -> torch.Tensor:
    """The ``fsdp`` group's blocks of ``t`` concatenated along ``dim``
    (``t`` itself for None or an fsdp axis of 1)."""
    if dim is None or axis_size(FSDP_AXIS) == 1:
        return t
    return all_gather(t.detach(), axis_group(FSDP_AXIS), dim)


def leaf_gathered(module, name: str) -> torch.Tensor:
    """``module``'s leaf ``name`` with its ``fsdp`` block gathered, for a
    leaf the rules split over ``fsdp`` only (e.g. a patch embedding's
    kernel)."""
    t = getattr(module, name)
    pl = getattr(module, "placement", {}).get(name)
    if pl is None:
        return t
    if pl.dim_of(MODEL_AXIS) is not None:
        raise ValueError(f"{name}: split over model, not a gather's")
    return fsdp_gather(t, pl.dim_of(FSDP_AXIS))


def data_gather_objects(obj):
    """[the object of data coordinate d for d in range(D)] on every rank
    (``[obj]`` for a data axis of 1): picklable host objects, gathered over
    this rank's ``data`` line."""
    if axis_size(DATA_AXIS) == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * axis_size(DATA_AXIS)
    dist.all_gather_object(out, obj, group=axis_group(DATA_AXIS))
    return out


def reader_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` split over the (data,
    fsdp) readers (``sharding.batch_rows``, JAX's batch sharding; the whole
    batch without a mesh)."""
    from thinkdiff_torch.core.distributed import get_rank
    from thinkdiff_torch.parallel.mesh import current_mesh
    from thinkdiff_torch.parallel.sharding import batch_rows

    readers = axis_size(DATA_AXIS) * axis_size(FSDP_AXIS)
    if readers == 1:
        return x
    if x.shape[0] % readers:
        raise ValueError(f"a batch of {x.shape[0]} rows over {readers} "
                         f"(data, fsdp) readers: each takes an equal block")
    return batch_rows({"x": x}, current_mesh(), get_rank())["x"]


def gather_reader_rows(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``reader_rows``: the readers' rows, bit for bit, in
    batch order on every rank."""
    x = x.contiguous()
    for axis in (FSDP_AXIS, DATA_AXIS):
        if axis_size(axis) > 1:
            x = all_gather(x, axis_group(axis), 0)
    return x


def model_all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place over the model group (no autograd)."""
    return all_reduce(t, op, model_group()) if model_size() > 1 else t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.float().contiguous()
        model_all_reduce(out)
        return out.to(g.dtype)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return model_all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return all_gather(x.contiguous(), model_group(), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_index() * ctx.n, ctx.n), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x) if model_size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """SUM over the model group; reduce a float in f32 (the caller's
    dtype is kept)."""
    return _ReduceFromModel.apply(x) if model_size() > 1 else x


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if model_size() == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.dim())
