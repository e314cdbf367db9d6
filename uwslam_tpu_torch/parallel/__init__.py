"""Multi-shard paths over processes on `torch.distributed`, each process
holding several shards as a leading tensor axis: landmark-sharded BA,
sequence-sharded tracking and observer-sharded photometric BA."""
from .dist_ba import AXIS, distributed_bundle_adjust, shard_problem
from .dist_photo_ba import PHOTO_AXIS, distributed_photometric_ba
from .runtime import (
    GridLayout,
    ShardLayout,
    grid_mesh,
    init_distributed,
    is_primary,
    landmark_layout,
    primary_only_io,
    world,
)
from .sequence import SEQ_AXIS, track_sequence_sharded

__all__ = [
    "AXIS",
    "GridLayout",
    "PHOTO_AXIS",
    "SEQ_AXIS",
    "ShardLayout",
    "distributed_bundle_adjust",
    "distributed_photometric_ba",
    "grid_mesh",
    "init_distributed",
    "is_primary",
    "landmark_layout",
    "primary_only_io",
    "shard_problem",
    "track_sequence_sharded",
    "world",
]
