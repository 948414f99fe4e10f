"""Several devices on ``torch.distributed`` (port of
``shgan_tpu/parallel``): one process per device, the rank's contiguous rows
of each global batch over the ``data`` axis, the high-resolution levels
split along H over the ``model`` axis (:mod:`.spatial`), explicit
collectives."""

from .consistency import check_replicated
from .mesh import Mesh, Rows, ThreadGroup, create_mesh, split
from .multihost import (allgather_rows, barrier, broadcast_object, is_lead,
                        local_rows, maybe_initialize_distributed, rank_device)
from .spatial import constrain, spatial_sharding

__all__ = ["Mesh", "Rows", "ThreadGroup", "allgather_rows", "barrier",
           "broadcast_object", "check_replicated", "constrain",
           "create_mesh", "is_lead", "local_rows",
           "maybe_initialize_distributed", "rank_device",
           "spatial_sharding", "split"]
