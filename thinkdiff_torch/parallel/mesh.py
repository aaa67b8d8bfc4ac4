"""The run's mesh over the ranks (counterpart of
thinkdiff_tpu/parallel/mesh.py).

JAX lays its devices out as a named (data, fsdp, model) mesh and lets
GSPMD shard the batch over ``data`` and reduce the gradients. Here one
rank is one JAX process on one card: the ``data`` axis counts ranks, each
rank holds a replica of the model and its own slice of the global batch,
and the trainer sums the gradients across ranks itself. ``fsdp`` and
``model`` (parameter and tensor sharding, JAX's
``parallel/sharding.py``) are not ported: a mesh that asks for them is
refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from thinkdiff_torch.core.distributed import get_rank, get_world_size

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class Mesh:
    """The axes' sizes; their product is the world."""
    data: int
    fsdp: int = 1
    model: int = 1

    @property
    def shape(self):
        return {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp,
                MODEL_AXIS: self.model}


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A (data, fsdp, model) mesh over ``world`` ranks (the process group's
    by default); ``data=-1`` takes every rank, as JAX's ``make_mesh``
    takes what the other axes leave of its devices. Raises ValueError for
    ``fsdp`` or ``model`` > 1 and for a mesh that does not cover the
    world."""
    world = get_world_size() if world is None else int(world)
    data, fsdp, model = int(data), int(fsdp), int(model)
    if fsdp < 1 or model < 1:
        raise ValueError(f"mesh fsdp={fsdp} model={model}: each axis is >= 1")
    if fsdp > 1 or model > 1:
        raise ValueError(
            f"mesh fsdp={fsdp} model={model}: the port shards no parameters "
            f"yet (JAX's parallel/sharding.py rules, ROADMAP.md Queue 1, "
            f"item 12c); each rank holds the whole model on one device, "
            f"so use data parallelism (fsdp 1, model 1)")
    if data == -1:
        data = world
    if data * fsdp * model != world:
        raise ValueError(
            f"mesh {data}x{fsdp}x{model} != {world} ranks: each rank holds "
            f"one device, and the axes' product must be the world")
    return Mesh(data, fsdp, model)


def mesh_from_config(run_cfg, world: Optional[int] = None) -> Mesh:
    """The mesh of ``run.mesh: {data, fsdp, model}`` (each optional; the
    default is data parallelism over every rank)."""
    cfg = (run_cfg.get("mesh", {}) if run_cfg else {}) or {}
    return make_mesh(data=int(cfg.get("data", -1)),
                     fsdp=int(cfg.get("fsdp", 1)),
                     model=int(cfg.get("model", 1)), world=world)


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of the global batch."""
    per = global_batch // get_world_size()
    return get_rank() * per, per
