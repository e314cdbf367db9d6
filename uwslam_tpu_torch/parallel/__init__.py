"""Landmark-sharded distributed bundle adjustment over processes on
`torch.distributed`, each process holding several shards."""
from .dist_ba import distributed_bundle_adjust, shard_problem
from .runtime import (
    ShardLayout,
    init_distributed,
    is_primary,
    landmark_layout,
    primary_only_io,
    world,
)

__all__ = [
    "ShardLayout",
    "distributed_bundle_adjust",
    "init_distributed",
    "is_primary",
    "landmark_layout",
    "primary_only_io",
    "shard_problem",
    "world",
]
