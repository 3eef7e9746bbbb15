from .mesh import (Mesh, data_rows, init_distributed, local_device,
                   make_mesh, process_shard, shard_batch, world)
from . import comm, fsdp

__all__ = ["Mesh", "comm", "data_rows", "fsdp", "init_distributed",
           "local_device", "make_mesh", "process_shard",
           "shard_batch", "world"]
