"""Multi-device farms and training (counterpart: ``srack_tpu/parallel``)."""

from .mesh import (Mesh, batch_sharding, make_mesh, replicated,
                   shard_batch)
from .farm import render_farm
from .distributed import init_distributed, is_multiprocess

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated",
           "shard_batch", "render_farm", "init_distributed",
           "is_multiprocess"]
