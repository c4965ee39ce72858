"""Multi-device layer: the ('channel', 'time') mesh over ``torch.distributed``
ranks and the sharded render, with every halo and gather an explicit
exchange."""

from .mesh import Mesh, make_mesh, single_device_mesh
from .sharding import ShardedRenderer
from . import dist

__all__ = ["Mesh", "make_mesh", "single_device_mesh", "ShardedRenderer",
           "dist"]
