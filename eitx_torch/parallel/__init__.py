"""Multi-device sharding on ``torch.distributed`` (port of eitx/parallel).

One process per device, joined in one process group: the ``data`` axis of
a ``DeviceMesh`` carries subjects, slices, breathing frames and training
images; the ``model`` axis shards parameters (FSDP2, ``fully_shard``).
"""

from .mesh import init_distributed, make_device_mesh
from .shard import (
    shard_batch,
    shard_params_fsdp,
    sharded_eit_monitoring,
    sharded_group_solve,
    sharded_segment_labels,
)

__all__ = [
    "init_distributed",
    "make_device_mesh",
    "shard_batch",
    "shard_params_fsdp",
    "sharded_eit_monitoring",
    "sharded_group_solve",
    "sharded_segment_labels",
]
