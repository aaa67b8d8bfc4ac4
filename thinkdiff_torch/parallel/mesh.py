"""The run's mesh over the ranks (counterpart of
thinkdiff_tpu/parallel/mesh.py).

JAX lays its devices out as a named (data, fsdp, model) mesh, ``model``
innermost (``reshape(data, fsdp, model)``), and lets GSPMD place the
batch over (data, fsdp) and the frozen weights by the rules of
``parallel/sharding.py``. Here one rank is one JAX device on one card,
laid out the same way: rank r sits at coordinate (d, f, m) with
r = (d * F + f) * M + m. The ranks of one (data, fsdp) coordinate read
the same batch (GSPMD replicates the batch over ``model``), so the
loaders count D * F readers (``loader_rank`` / ``loader_world``).
``setup_groups`` makes one process group per axis line, once, on every
rank; the sharded modules reduce and gather over them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.model

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate, JAX's device layout
        ``reshape(data, fsdp, model)``."""
        return {DATA_AXIS: rank // (self.fsdp * self.model),
                FSDP_AXIS: rank // self.model % self.fsdp,
                MODEL_AXIS: rank % self.model}

    def axis_ranks(self, rank: int, axis: str) -> Tuple[int, ...]:
        """The ranks on ``rank``'s line along ``axis``, in axis order."""
        c = self.coords(rank)
        out = []
        for i in range(self.shape[axis]):
            c2 = {**c, axis: i}
            out.append((c2[DATA_AXIS] * self.fsdp + c2[FSDP_AXIS])
                       * self.model + c2[MODEL_AXIS])
        return tuple(out)

    @property
    def sharded(self) -> bool:
        return self.fsdp > 1 or self.model > 1


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A (data, fsdp, model) mesh over ``world`` ranks (the process group's
    by default); ``data=-1`` takes what the other axes leave, as JAX's
    ``make_mesh`` takes what they leave of its devices. Raises ValueError
    for a mesh that does not cover the world."""
    world = get_world_size() if world is None else int(world)
    data, fsdp, model = int(data), int(fsdp), int(model)
    if fsdp < 1 or model < 1:
        raise ValueError(f"mesh fsdp={fsdp} model={model}: each axis is >= 1")
    if data == -1:
        if world % (fsdp * model):
            raise ValueError(
                f"mesh fsdp={fsdp} model={model} does not divide {world} "
                f"ranks: each rank holds one device")
        data = world // (fsdp * model)
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


# -- the run's mesh and its process groups -----------------------------------

_CURRENT: Dict[str, object] = {"mesh": None, "groups": {}}


def set_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Makes ``mesh`` the run's (None: no mesh) and, over several ranks,
    its process groups: one a line of each axis of more than one rank
    (``data`` too: the serving engines gather their results over it),
    made by every rank in the same order, as
    ``torch.distributed.new_group`` asks.
    Setting the mesh that is current again makes nothing. Raises
    ValueError for a mesh whose size is not the world's, whatever the
    world."""
    import torch.distributed as dist

    if mesh == _CURRENT["mesh"]:
        return mesh
    groups = {}
    if mesh is not None and mesh.size != get_world_size():
        # one rank is one device: a mesh larger than the world would run
        # its sharded layers with no group to reduce over
        raise ValueError(f"mesh of {mesh.size} ranks in a world of "
                         f"{get_world_size()}: each rank holds one device")
    if mesh is not None and mesh.size > 1:
        me = get_rank()
        for axis in AXES:
            if mesh.shape[axis] == 1:
                continue
            lines = sorted({mesh.axis_ranks(r, axis)
                            for r in range(mesh.size)})
            for line in lines:
                g = dist.new_group(list(line))
                if me in line:
                    groups[axis] = g
    _CURRENT.update(mesh=mesh, groups=groups)
    return mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT["mesh"]


def axis_group(axis: str):
    """This rank's process group along ``axis`` (None for an axis of 1)."""
    return _CURRENT["groups"].get(axis)


def axis_index(axis: str) -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.coords(get_rank())[axis]


def axis_size(axis: str) -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.shape[axis]


def loader_rank() -> int:
    """This rank's reader among the (data, fsdp) coordinates: d * F + f
    (the rank itself without a sharded mesh)."""
    mesh = current_mesh()
    if mesh is None or mesh.model == 1:
        return get_rank()
    return get_rank() // mesh.model


def loader_world() -> int:
    """How many ranks read distinct batches: D * F."""
    mesh = current_mesh()
    if mesh is None or mesh.model == 1:
        return get_world_size()
    return get_world_size() // mesh.model


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of the global batch, over the
    (data, fsdp) coordinates."""
    per = global_batch // loader_world()
    return loader_rank() * per, per
