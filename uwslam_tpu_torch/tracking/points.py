"""Candidate-point selection for direct tracking, batched over frames.

Counterpart of `uwslam_tpu.tracking.points` (`TrackPoints`,
`topk_gradient_points`, `dense_points` and `_depth_at`). Every field of
`TrackPoints` has a leading frame (or pair) dimension B and a fixed point
capacity N; `valid` masks the real entries.

Depth images are in the sensor's raw units, TUM's 16-bit PNG values at 5000
per metre (`TUM_DEPTH_FACTOR`, uw-slam src/Tracker.cpp:1223); points without
a depth image sit at the constant monocular depth `mono_z`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..ops.cuda_sample import cuda_bilinear_sample

TUM_DEPTH_FACTOR = 0.0002


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


def _depth_at(depth_image, uv: torch.Tensor, mono_z: float,
              max_edge_ratio: float = 1.15):
    """Depth (metres) and its validity at uv (..., N, 2); `mono_z` where
    there is no depth. depth_image is None (monocular: all valid), (H, W)
    with uv (N, 2), or (B, H, W) with uv (B, N, 2).

    A bilinear read that straddles a depth discontinuity interpolates
    between two surfaces, and high-gradient points sit on exactly those
    edges. So the four corner texels are read on their own (ONE kernel K3
    launch with C = 1 over the 4 N corner coordinates), blended, and the
    point is dropped where a corner is a hole (0) or the corners differ by
    more than `max_edge_ratio`."""
    if depth_image is None:
        d = torch.full(uv.shape[:-1], mono_z, dtype=torch.float32, device=uv.device)
        return d, torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device)
    if depth_image.dim() == 2:
        d, ok = _depth_at(depth_image[None], uv[None], mono_z, max_edge_ratio)
        return d[0], ok[0]
    B, H, W = depth_image.shape
    N = uv.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.clamp(torch.floor(u), 0, W - 2)
    v0 = torch.clamp(torch.floor(v), 0, H - 2)
    fu = torch.clamp(u - u0, 0.0, 1.0)
    fv = torch.clamp(v - v0, 0.0, 1.0)
    corner_uv = torch.stack(
        [torch.stack([u0 + du, v0 + dv], dim=-1)
         for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1))], dim=1,
    )                                                        # (B, 4, N, 2)
    vals, _ = cuda_bilinear_sample(depth_image[:, None], corner_uv.reshape(B, 4 * N, 2))
    corners = vals[:, 0].reshape(B, 4, N) * TUM_DEPTH_FACTOR
    c00, c10, c01, c11 = corners.unbind(1)
    d = (
        c00 * (1 - fu) * (1 - fv)
        + c10 * fu * (1 - fv)
        + c01 * (1 - fu) * fv
        + c11 * fu * fv
    )
    dmin, dmax = corners.amin(1), corners.amax(1)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ok = inb & (dmin > 1e-6) & (dmax <= dmin * max_edge_ratio)
    return torch.where(ok, d, mono_z), ok


def topk_gradient_points(
    image: torch.Tensor,
    grad_mag: torch.Tensor,
    cam: PinholeCamera,
    depth_image: torch.Tensor | None = None,
    num_points: int = 2048,
    mono_z: float = 1.0,
    border: int = 4,
    block: int = 8,
    grad_x: torch.Tensor | None = None,
    grad_y: torch.Tensor | None = None,
) -> TrackPoints:
    """Per frame of (B, H, W): the `num_points` strongest `block` x `block`
    block maxima of the gradient magnitude, border suppressed; their depth
    from `depth_image` (B, H, W) where given (`_depth_at`), else `mono_z`.

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

    depth, dok = _depth_at(depth_image, uv, mono_z)
    return TrackPoints(
        uv=uv,
        p3d=cam.unproject(uv, depth),
        intensity=intensity,
        valid=(top_val > 0) & dok,
        gx0=gx0,
        gy0=gy0,
    )


def dense_points(
    image: torch.Tensor,
    cam: PinholeCamera,
    depth_image: torch.Tensor | None = None,
    mono_z: float = 1.0,
    stride: int = 1,
    border: int = 4,
) -> TrackPoints:
    """Every `stride`-th pixel of (B, H, W) as a track point (uw-slam's
    ObtainAllPoints, src/Tracker.cpp:1259-1310): a fixed (H // stride) *
    (W // stride) points per frame, the border band masked rather than
    dropped. Values are read by strided slicing (the grid is the integer
    pixels themselves), depth holes fall back to `mono_z` and are invalid."""
    B, H, W = image.shape
    dev = image.device
    Hs, Ws = H - (H % stride), W - (W % stride)
    v, u = torch.meshgrid(
        torch.arange(0, Hs, stride, dtype=torch.float32, device=dev),
        torch.arange(0, Ws, stride, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    interior = (
        (uv[:, 0] >= border) & (uv[:, 0] < W - border)
        & (uv[:, 1] >= border) & (uv[:, 1] < H - border)
    )
    uv = uv.expand(B, -1, 2).contiguous()
    intensity = image[:, :Hs:stride, :Ws:stride].reshape(B, -1)
    if depth_image is None:
        depth, dok = _depth_at(None, uv, mono_z)
    else:
        d = depth_image[:, :Hs:stride, :Ws:stride].reshape(B, -1) * TUM_DEPTH_FACTOR
        dok = d > 1e-6
        depth = torch.where(dok, d, mono_z)
    return TrackPoints(
        uv=uv, p3d=cam.unproject(uv, depth), intensity=intensity, valid=interior & dok
    )
