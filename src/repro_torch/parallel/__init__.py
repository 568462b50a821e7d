"""Logical-axis sharding on ``torch.distributed`` device meshes
(counterpart of the reference's ``repro/parallel``)."""
from . import sharding
from .sharding import (set_active_mesh, active_mesh, use_mesh, constrain,
                       resolve_pspec, named_sharding, tree_pspecs,
                       tree_shardings, DEFAULT_RULES, PartitionSpec,
                       NamedSharding, placements, can_shard)
