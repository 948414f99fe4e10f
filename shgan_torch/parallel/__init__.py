"""Data parallelism on ``torch.distributed`` (port of ``shgan_tpu/parallel``,
without the spatial sharding of its ``spatial.py``): one process per
device, the rank's contiguous rows of each global batch, explicit
collectives."""

from .consistency import check_replicated
from .mesh import Mesh, Rows, ThreadGroup, create_mesh, split
from .multihost import (allgather_rows, barrier, broadcast_object, is_lead,
                        local_rows, maybe_initialize_distributed, rank_device)

__all__ = ["Mesh", "Rows", "ThreadGroup", "allgather_rows", "barrier",
           "broadcast_object", "check_replicated", "create_mesh", "is_lead",
           "local_rows", "maybe_initialize_distributed", "rank_device",
           "split"]
