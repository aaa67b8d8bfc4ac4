"""Parallelism of the port (counterpart of thinkdiff_tpu/parallel/): the
mesh's axis arithmetic over the ranks of ``torch.distributed``."""

from thinkdiff_torch.parallel.mesh import (  # noqa: F401
    AXES, Mesh, local_batch_slice, make_mesh, mesh_from_config)
