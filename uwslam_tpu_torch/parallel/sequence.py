"""Sequence-parallel odometry: frame chunks tracked on different shards.

Counterpart of `uwslam_tpu.parallel.sequence`. The relative poses
T_{i+1 <- i} of a sequence are independent given the frames, so the N - 1
pairs split into D = `layout.total` chunks of C = ceil((N - 1) / D)
consecutive pairs; chunk d covers frames [d C, d C + C] (one frame of
overlap links consecutive chunks), clamped to the last frame. Each chunk
is tracked by `track_sequence_batched` (every pair from the identity) or,
with `batched=False`, by `track_sequence` (each pair from the previous
pair's motion). The results of all chunks, in order, cut to N - 1, are the
sequence's.

Where the JAX package runs one chunk per device under `shard_map`, a
process here holds `layout.local` consecutive chunks (`runtime.ShardLayout`)
and the chunks are gathered over processes with
`torch.distributed.all_gather`; a world of one process concatenates.

- `batched=True`: every pair of this process's chunks is one pair of
  consecutive frames of the contiguous range they cover, so the whole range
  goes through ONE `track_sequence_batched` call (kernel K1 on its
  pyramid, `lm_evaluate`, K3; K2 under Tukey or affine). A pair's result
  depends only on its two frames, so it is the unsharded call's pair, up to
  the batch size the kernels' launch shapes are chosen from.
- `batched=False`: the constant-velocity prior restarts at each chunk's
  first pair, as in the JAX package (that is what the sharded scan
  computes; it is not the unsharded scan).

Pairs past the last frame (the clamped tail of the last chunks, which the
JAX package tracks and then cuts) are not tracked: their rows are the
identity, 0 inliers and 0 error until the cut removes them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..camera.model import PinholeCamera
from ..tracking.sequence import track_sequence, track_sequence_batched
from .runtime import ShardLayout

SEQ_AXIS = "seq"


def _gather(x: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """This process's rows, and every other's, in rank order."""
    if layout.world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(layout.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def track_sequence_sharded(
    frames: torch.Tensor,
    cam: PinholeCamera,
    layout: ShardLayout,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int | tuple[int, ...] = 10,
    mode: str = "fc",
    batched: bool = True,
):
    """Track (N, H, W) frames over the shards of `layout` -> (T_rel
    (N-1, 4, 4), inliers (N-1,), errors (N-1,)), in the meaning of
    `tracking.track_sequence`. Every process passes the whole sequence and
    receives the whole result."""
    N = frames.shape[0]
    D, S = layout.total, layout.local
    C = -(-(N - 1) // D)             # relative poses per chunk
    dev = frames.device
    T = torch.eye(4, dtype=torch.float32, device=dev).repeat(S * C, 1, 1)
    inliers = torch.zeros(S * C, dtype=torch.int64, device=dev)
    errors = torch.zeros(S * C, dtype=torch.float32, device=dev)
    kw = dict(mono_z=mono_z, levels=levels, track_levels=track_levels,
              num_points=num_points, max_iters=max_iters, mode=mode)

    def put(row: int, out) -> None:
        n = out[0].shape[0]
        T[row:row + n] = out[0]
        inliers[row:row + n] = out[1]
        errors[row:row + n] = out[2]

    first = layout.shards[0] * C     # this process's first pair
    if batched:
        last = min(first + S * C, N - 1)       # one past its last real pair
        if last > first:
            put(0, track_sequence_batched(frames[first:last + 1], cam, **kw))
    else:
        for k, d in enumerate(layout.shards):
            last = min(d * C + C, N - 1)
            if last > d * C:
                put(k * C, track_sequence(frames[d * C:last + 1], cam, **kw))
    return tuple(_gather(x, layout)[:N - 1] for x in (T, inliers, errors))
