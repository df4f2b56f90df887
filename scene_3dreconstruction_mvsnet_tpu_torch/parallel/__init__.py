"""Multi-device runs of the port: data-parallel and data x sweep training
over a ``torch.distributed`` process group (the sweep axis splits the cost
volume's depth planes over ranks), and stage A and the consistency filter
split over devices. Counterpart of ``scene_3dreconstruction_mvsnet_tpu/
parallel``."""

from .collectives import all_reduce_grads, all_reduce_sum, broadcast_module, world_size
from .halo import exchange_halos, gather_depth
from .mesh import Mesh, auto_mesh_shape, initialize_multihost, local_devices, make_global_mesh, make_mesh
from .sharding import (
    VolumeSharding,
    make_sharded_infer,
    make_sharded_train_step,
    shard_rows,
    volume_sharding,
)

__all__ = [
    "Mesh",
    "VolumeSharding",
    "all_reduce_grads",
    "all_reduce_sum",
    "auto_mesh_shape",
    "broadcast_module",
    "exchange_halos",
    "gather_depth",
    "initialize_multihost",
    "local_devices",
    "make_global_mesh",
    "make_mesh",
    "make_sharded_infer",
    "make_sharded_train_step",
    "shard_rows",
    "volume_sharding",
    "world_size",
]
