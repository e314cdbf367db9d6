"""Candidate-point selection for direct tracking, batched over frames.

Counterpart of `uwslam_tpu.tracking.points` (`TrackPoints`,
`topk_gradient_points`, and the monocular branch of `_depth_at`). Every
field of `TrackPoints` has a leading frame (or pair) dimension B and a fixed
point capacity N; `valid` masks the real entries.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera


class TrackPoints(NamedTuple):
    uv: torch.Tensor          # (B, N, 2) f32 level-0 pixel coords, reference frame
    p3d: torch.Tensor         # (B, N, 3) f32 reference-camera 3D points
    intensity: torch.Tensor   # (B, N) f32 reference intensities
    valid: torch.Tensor       # (B, N) bool
    # Level-0 Scharr gradients at uv, carried from selection; tracking then
    # skips its level-0 reference sample (the points sit on integer pixels).
    gx0: torch.Tensor | None = None   # (B, N) f32
    gy0: torch.Tensor | None = None   # (B, N) f32

    def select(self, index) -> "TrackPoints":
        """The same points restricted to frames `index` (e.g. a slice)."""
        return TrackPoints(*(None if f is None else f[index] for f in self))


def _depth_at(uv: torch.Tensor, mono_z: float):
    """Monocular depth: mono_z at every point, all valid."""
    d = torch.full(uv.shape[:-1], mono_z, dtype=torch.float32, device=uv.device)
    return d, torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device)


def topk_gradient_points(
    image: torch.Tensor,
    grad_mag: torch.Tensor,
    cam: PinholeCamera,
    num_points: int = 2048,
    mono_z: float = 1.0,
    border: int = 4,
    block: int = 8,
    grad_x: torch.Tensor | None = None,
    grad_y: torch.Tensor | None = None,
) -> TrackPoints:
    """Per frame of (B, H, W): the `num_points` strongest `block` x `block`
    block maxima of the gradient magnitude, border suppressed.

    The block argmax is the JAX package's packed-int form: magnitudes are
    bitcast to int32 (monotone for non-negative floats), the low 6 bits
    replaced by 63 - (index in block), and one max yields value and place;
    ties of the packed value go to the lowest in-block index. The blocks are
    then sorted stably by descending magnitude (ties keep block order) and
    padded to capacity, so the selection matches the JAX package exactly."""
    B, H, W = grad_mag.shape
    dev = grad_mag.device
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    interior = (
        (row >= border) & (row < H - border) & (col >= border) & (col < W - border)
    )
    g = torch.where(interior, torch.clamp(grad_mag, min=0.0), 0.0)

    Hb, Wb = H // block, W // block
    nb = block * block
    gb = g[:, : Hb * block, : Wb * block].reshape(B, Hb, block, Wb, block)
    gi = gb.contiguous().view(torch.int32)
    ar = torch.arange(block, dtype=torch.int32, device=dev)
    inner = (ar[:, None] * block + ar[None, :])[None, None, :, None, :]
    packed = (gi & ~(nb - 1)) | (nb - 1 - inner)
    pmax = packed.amax(dim=(2, 4))                           # (B, Hb, Wb)
    inner_sel = (nb - 1) - (pmax & (nb - 1))
    by = torch.arange(Hb, device=dev)[:, None]
    bx = torch.arange(Wb, device=dev)[None, :]
    pix = (
        (by * block + inner_sel // block) * W + bx * block + inner_sel % block
    ).reshape(B, -1)                                         # (B, Hb*Wb) flat index

    def pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, H * W).gather(1, idx)

    best_val = pick(g, pix)
    k = min(num_points, Hb * Wb)
    order = torch.sort(-best_val, dim=-1, stable=True).indices[:, :k]
    sel = pix.gather(1, order)
    top_val = best_val.gather(1, order)
    uv = torch.stack([(sel % W).float(), (sel // W).float()], dim=-1)
    intensity = pick(image, sel)
    gx0 = gy0 = None
    if grad_x is not None:
        gx0, gy0 = pick(grad_x, sel), pick(grad_y, sel)
    if k < num_points:  # pad to capacity
        pad = num_points - k

        def padded(x: torch.Tensor, value: float) -> torch.Tensor:
            fill = torch.full((B, pad, *x.shape[2:]), value, dtype=x.dtype, device=dev)
            return torch.cat([x, fill], dim=1)

        uv = padded(uv, 0.0)
        top_val = padded(top_val, -1.0)
        intensity = padded(intensity, 0.0)
        if gx0 is not None:
            gx0, gy0 = padded(gx0, 0.0), padded(gy0, 0.0)

    depth, dok = _depth_at(uv, mono_z)
    return TrackPoints(
        uv=uv,
        p3d=cam.unproject(uv, depth),
        intensity=intensity,
        valid=(top_val > 0) & dok,
        gx0=gx0,
        gy0=gy0,
    )
