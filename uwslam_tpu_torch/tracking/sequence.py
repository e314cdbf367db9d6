"""Batched sequence tracking: every adjacent frame pair as one LM problem.

Counterpart of `uwslam_tpu.tracking.sequence`: `track_sequence_batched`
(every pair an independent LM problem from the identity), `track_sequence`
(the frames in order, each pair starting from the previous pair's motion)
and `compose_trajectory`; FC or IC, optional affine brightness, optional
depth frames. A batched chunk runs as one stream of device launches: pyramid
(kernel K1 per level), per-frame point selection (K3 on the depth frames),
then coarse-to-fine tracking of all pairs at once (kernels K3 and K2).
"""
from __future__ import annotations

import torch
from torch import nn

from ..camera.model import PinholeCamera
from ..image.pyramid import build_pyramid, build_pyramid_batched
from ..lie import se3
from .photometric import MODES, track
from .points import topk_gradient_points


def track_sequence(
    frames: torch.Tensor,
    cam: PinholeCamera,
    depth_frames: torch.Tensor | None = None,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int | tuple[int, ...] = 10,
    block: int = 8,
    mode: str = "fc",
    affine: bool = False,
):
    """Track frames (N, H, W) f32 in order -> (T_rel (N-1, 4, 4), inliers
    (N-1,), errors (N-1,)); T_rel[i] maps frame-i coordinates to frame-i+1
    coordinates. Each pair starts from the previous pair's result (constant
    velocity; the first from the identity), so fast motion stays inside the
    coarse level's basin where `track_sequence_batched` may leave it. Every
    frame is ingested inside the loop (pyramid through K1 at B = 1,
    selection, depth through K3) and nothing is read back to the host."""

    def ingest(i: int):
        pyr = build_pyramid(frames[i], levels=levels)
        pts = topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], cam,
            depth_image=None if depth_frames is None else depth_frames[i][None],
            num_points=num_points, mono_z=mono_z, block=block,
            grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0],
        )
        return pyr, pts

    prev_pyr, prev_pts = ingest(0)
    T_init = None
    outs = []
    for i in range(1, frames.shape[0]):
        pyr, pts = ingest(i)
        out = track(
            prev_pyr, pyr, prev_pts, cam, T_init=T_init, levels=track_levels,
            max_iters=max_iters, mode=mode, affine=affine,
        )
        outs.append(out)
        prev_pyr, prev_pts, T_init = pyr, pts, out.T
    return (
        torch.cat([o.T for o in outs]),
        torch.cat([o.inliers for o in outs]),
        torch.cat([o.error for o in outs]),
    )


def track_sequence_batched(
    frames: torch.Tensor,
    cam: PinholeCamera,
    depth_frames: torch.Tensor | None = None,
    mono_z: float = 1.0,
    levels: int = 5,
    track_levels: tuple[int, ...] = (3, 2, 1, 0),
    num_points: int = 2048,
    max_iters: int | tuple[int, ...] = 10,
    block: int = 8,
    mode: str = "fc",
    affine: bool = False,
):
    """Track frames (N, H, W) f32 -> (T_rel (N-1, 4, 4), inliers (N-1,),
    errors (N-1,)); T_rel[i] maps frame-i coordinates to frame-i+1
    coordinates. Every pair starts from the identity. depth_frames
    (N, H, W), raw sensor units, give the points their depth (one K3 launch
    over all frames)."""
    pyrs = build_pyramid_batched(frames, levels=levels)
    pts = topk_gradient_points(
        pyrs.images[0], pyrs.grad_mag[0], cam, depth_image=depth_frames,
        num_points=num_points, mono_z=mono_z, block=block,
        grad_x=pyrs.grad_x[0], grad_y=pyrs.grad_y[0],
    )
    ref, tgt = slice(None, -1), slice(1, None)
    out = track(
        pyrs.select(ref), pyrs.select(tgt), pts.select(ref), cam,
        levels=track_levels, max_iters=max_iters, mode=mode, affine=affine,
    )
    return out.T, out.inliers, out.error


class SequenceTracker(nn.Module):
    """Offline odometry of a frame chunk: `forward(frames, mono_z)` runs
    `track_sequence_batched` with this tracker's configuration, or, with
    sequential=True, `track_sequence`."""

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

    def forward(self, frames: torch.Tensor, mono_z: float = 1.0,
                depth_frames: torch.Tensor | None = None, sequential: bool = False):
        run = track_sequence if sequential else track_sequence_batched
        return run(
            frames, self.cam, depth_frames=depth_frames, mono_z=mono_z,
            levels=self.levels,
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
