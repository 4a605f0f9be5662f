"""Processes and data movement (counterparts of ``cmrtpu.parallel``): the
process group, the mesh and the collectives (``mesh``), the host producer
thread and the put-ahead copy on a side stream (``prefetch``)."""

from cmrtpu_torch.parallel.mesh import (create_mesh, local_batch_size,
                                        shard_batch)

__all__ = ["create_mesh", "shard_batch", "local_batch_size"]
