"""Multi-process runtime on `torch.distributed`: bring-up, the shard
layouts and host I/O on the primary process.

Counterpart of `uwslam_tpu.parallel.runtime`. A mesh axis over every
device (`landmark_mesh`, and the one-axis meshes of the sequence and
photometric paths) becomes a `ShardLayout`: the shards are a leading axis
of one set of tensors in each process, `shards_per_process` of them, and
the processes hold consecutive ranges of the global shard index, so
`world * shards_per_process` shards in all, the partition the JAX package
gets from as many devices. `grid_mesh`'s two-axis mesh becomes a
`GridLayout`: the same shards read as a (rows, cols) grid.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import NamedTuple

import torch.distributed as dist


def init_distributed(address: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group from the arguments or torch's environment
    variables (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`, `MASTER_PORT`). Does
    nothing at a world of one process, or when the group exists already.
    The backend defaults to gloo (CPU tensors); pass "nccl" for CUDA ones."""
    world = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    if address is None:
        address = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
    dist.init_process_group(
        backend=backend or "gloo", init_method=address, world_size=world,
        rank=rank if rank is not None else int(os.environ.get("RANK", "0")),
    )


def world() -> tuple[int, int]:
    """(world size, rank) of this process; (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardLayout(NamedTuple):
    """Which landmark shards this process holds."""

    local: int    # shards held here (a leading tensor axis)
    world: int    # processes
    rank: int     # this process

    @property
    def total(self) -> int:
        return self.local * self.world

    @property
    def shards(self) -> range:
        """Global indices of the shards held here."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)


def landmark_layout(shards_per_process: int = 1) -> ShardLayout:
    """The layout of `shards_per_process` shards in every process of the
    group: landmark-sharded BA's, and that of the sequence-sharded tracker
    and the observer-sharded photometric BA."""
    if shards_per_process < 1:
        raise ValueError(f"shards_per_process must be >= 1, got {shards_per_process}")
    size, rank = world()
    return ShardLayout(local=shards_per_process, world=size, rank=rank)


class GridLayout(NamedTuple):
    """A (rows, cols) grid of the world's shards, row-major in the global
    shard index: axis `axes[0]` runs over rows, `axes[1]` over columns."""

    rows: int
    cols: int
    axes: tuple[str, str]
    layout: ShardLayout

    def coords(self, shard: int) -> tuple[int, int]:
        """(row, column) of a global shard index."""
        return divmod(shard, self.cols)

    @property
    def local_coords(self) -> list[tuple[int, int]]:
        """(row, column) of each shard held here."""
        return [self.coords(s) for s in self.layout.shards]


def grid_mesh(rows: int, cols: int, axes=("kf", "lm")) -> GridLayout:
    """A keyframe x landmark grid of rows * cols shards over the group (for
    windows whose reduced camera system is itself sharded); every process
    holds the same number of shards, so rows * cols must divide by the
    world size."""
    size, rank = world()
    total = rows * cols
    if rows < 1 or cols < 1 or total % size:
        raise ValueError(f"a {rows} x {cols} grid does not divide over {size} processes")
    return GridLayout(rows=rows, cols=cols, axes=tuple(axes),
                      layout=ShardLayout(local=total // size, world=size, rank=rank))


def is_primary() -> bool:
    """True on the process that owns host I/O (trajectory export, logs)."""
    return world()[1] == 0


@contextmanager
def primary_only_io():
    """Yields whether this process should do a block of host I/O."""
    yield is_primary()
