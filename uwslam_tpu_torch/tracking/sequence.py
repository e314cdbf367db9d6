"""Batched sequence tracking: every adjacent frame pair as one LM problem.

Counterpart of `uwslam_tpu.tracking.sequence.track_sequence_batched`
(monocular depth, FC or IC, optional affine brightness) and
`compose_trajectory`. The whole chunk runs as one stream of device launches:
pyramid (kernel K1 per level), per-frame point selection, then
coarse-to-fine tracking of all pairs at once (kernels K3 and K2).
"""
from __future__ import annotations

import torch
from torch import nn

from ..camera.model import PinholeCamera
from ..image.pyramid import build_pyramid_batched
from ..lie import se3
from .photometric import MODES, track
from .points import topk_gradient_points


def track_sequence_batched(
    frames: torch.Tensor,
    cam: PinholeCamera,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int | tuple[int, ...] = 10,
    block: int = 8,
    mode: str = "ic",
    affine: bool = False,
):
    """Track frames (N, H, W) f32 -> (T_rel (N-1, 4, 4), inliers (N-1,),
    errors (N-1,)); T_rel[i] maps frame-i coordinates to frame-i+1
    coordinates. Every pair starts from the identity."""
    pyrs = build_pyramid_batched(frames, levels=levels)
    pts = topk_gradient_points(
        pyrs.images[0], pyrs.grad_mag[0], cam, num_points=num_points,
        mono_z=mono_z, block=block, grad_x=pyrs.grad_x[0], grad_y=pyrs.grad_y[0],
    )
    ref, tgt = slice(None, -1), slice(1, None)
    out = track(
        pyrs.select(ref), pyrs.select(tgt), pts.select(ref), cam,
        levels=track_levels, max_iters=max_iters, mode=mode, affine=affine,
    )
    return out.T, out.inliers, out.error


class SequenceTracker(nn.Module):
    """Offline odometry of a frame chunk: `forward(frames, mono_z)` runs
    `track_sequence_batched` with this tracker's configuration."""

    def __init__(
        self,
        cam: PinholeCamera,
        levels: int = 5,
        track_levels: tuple[int, ...] = (3, 2, 1, 0),
        num_points: int = 2048,
        max_iters: int | tuple[int, ...] = 10,
        mode: str = "ic",
        affine: bool = False,
    ):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.cam = cam
        self.levels = levels
        self.track_levels = tuple(track_levels)
        self.num_points = num_points
        self.max_iters = max_iters
        self.mode = mode
        self.affine = affine

    def forward(self, frames: torch.Tensor, mono_z: float = 1.0):
        return track_sequence_batched(
            frames, self.cam, mono_z=mono_z, levels=self.levels,
            track_levels=self.track_levels, num_points=self.num_points,
            max_iters=self.max_iters, mode=self.mode, affine=self.affine,
        )


def compose_trajectory(T_rel: torch.Tensor) -> torch.Tensor:
    """Relative poses (N-1, 4, 4) (cur <- prev) -> world poses T_wc (N, 4, 4)
    with frame 0 at the identity: T_wc[i+1] = T_wc[i] @ inv(T_rel[i])."""
    steps = se3.inverse(T_rel)
    poses = [torch.eye(4, dtype=T_rel.dtype, device=T_rel.device)]
    for step in steps:
        poses.append(poses[-1] @ step)
    return torch.stack(poses)
