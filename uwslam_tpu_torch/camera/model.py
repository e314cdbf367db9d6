"""Pinhole camera with radial-tangential distortion, and rectification.

Counterpart of `uwslam_tpu.camera.model`: `PinholeCamera` (OpenCV radtan
[k1, k2, p1, p2] of the raw image, as the EUROC calibration has it),
`optimal_new_camera`, `undistort_map`, `remap_bilinear` and `compute_roi`.
Intrinsics are Python floats, so each level's camera is a constant of the
code that uses it. The rectification map is computed once per calibration
and applied to every frame by an exact 4-tap gather (`remap_bilinear`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, 1e-9, z)


@dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # radtan distortion of the RAW image; all zero means none.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(c) > 1e-12 for c in (self.k1, self.k2, self.p1, self.p2))

    def scaled(self, level: int) -> "PinholeCamera":
        """Intrinsics of pyramid level `level`: f halves per level, and the
        principal point follows the half-pixel rule c_l = (c_0 + 0.5)/2^l - 0.5."""
        f = 1 << level
        return PinholeCamera(
            fx=self.fx / f,
            fy=self.fy / f,
            cx=(self.cx + 0.5) / f - 0.5,
            cy=(self.cy + 0.5) / f - 0.5,
            width=self.width >> level,
            height=self.height >> level,
            k1=self.k1, k2=self.k2, p1=self.p1, p2=self.p2,
        )

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2) [u, v]."""
        z = _safe_z(pts[..., 2])
        u = self.fx * pts[..., 0] / z + self.cx
        v = self.fy * pts[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def _tangential(self, x: torch.Tensor, y: torch.Tensor, r2: torch.Tensor):
        dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return dx, dy

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Apply radtan distortion to normalized coordinates (..., 2)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * self.k2)
        dx, dy = self._tangential(x, y, r2)
        return torch.stack([x * radial + dx, y * radial + dy], dim=-1)

    def undistort_normalized(self, xy_d: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Invert radtan by `iters` fixed-point iterations."""
        xy = xy_d
        for _ in range(iters):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * self.k2)
            dx, dy = self._tangential(x, y, r2)
            xy = torch.stack(
                [(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial], dim=-1
            )
        return xy

    def project_jacobian(self, pts: torch.Tensor) -> torch.Tensor:
        """d(u, v)/d(x, y, z): (..., 3) -> (..., 2, 3)."""
        x, y = pts[..., 0], pts[..., 1]
        zi = 1.0 / _safe_z(pts[..., 2])
        zi2 = zi * zi
        zero = torch.zeros_like(x)
        row_u = torch.stack([self.fx * zi, zero, -self.fx * x * zi2], dim=-1)
        row_v = torch.stack([zero, self.fy * zi, -self.fy * y * zi2], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)


def optimal_new_camera(
    cam: PinholeCamera, out_width: int, out_height: int, alpha: float = 0.0
) -> PinholeCamera:
    """Rectified intrinsics covering the undistorted image, in the spirit of
    cv::getOptimalNewCameraMatrix: 64 samples per edge of the raw image are
    undistorted (f32, on the host) and boxed. alpha=0: every output pixel
    valid (the inner box); alpha=1: every source pixel kept (the outer box)."""
    n = 64
    xs = np.linspace(0, cam.width - 1, n, dtype=np.float32)
    ys = np.linspace(0, cam.height - 1, n, dtype=np.float32)
    border = np.concatenate(
        [
            np.stack([xs, np.zeros(n, np.float32)], -1),
            np.stack([xs, np.full(n, cam.height - 1, np.float32)], -1),
            np.stack([np.zeros(n, np.float32), ys], -1),
            np.stack([np.full(n, cam.width - 1, np.float32), ys], -1),
        ]
    )
    xy_d = (border - np.array([cam.cx, cam.cy])) / np.array([cam.fx, cam.fy])
    xy_u = cam.undistort_normalized(torch.from_numpy(xy_d.astype(np.float32))).numpy()

    outer_min, outer_max = xy_u.min(0), xy_u.max(0)
    # Inner box from per-edge extrema, as OpenCV approximates it.
    top, bottom, left, right = xy_u[:n], xy_u[n:2 * n], xy_u[2 * n:3 * n], xy_u[3 * n:]
    inner_min = np.array([left[:, 0].max(), top[:, 1].max()])
    inner_max = np.array([right[:, 0].min(), bottom[:, 1].min()])

    lo = alpha * outer_min + (1 - alpha) * inner_min
    hi = alpha * outer_max + (1 - alpha) * inner_max
    span = np.maximum(hi - lo, 1e-6)
    fx = (out_width - 1) / span[0]
    fy = (out_height - 1) / span[1]
    return PinholeCamera(
        fx=float(fx), fy=float(fy), cx=float(-lo[0] * fx), cy=float(-lo[1] * fy),
        width=out_width, height=out_height,
    )


def undistort_map(raw: PinholeCamera, rect: PinholeCamera) -> torch.Tensor:
    """Dense rectification map (H_out, W_out, 2): the RAW-image pixel [u, v]
    to sample for each rectified output pixel (cv::initUndistortRectifyMap).
    Computed on the host once per calibration, so the map and the region of
    interest derived from it are the same whatever device applies them."""
    v, u = torch.meshgrid(
        torch.arange(rect.height, dtype=torch.float32),
        torch.arange(rect.width, dtype=torch.float32),
        indexing="ij",
    )
    x = (u - rect.cx) / rect.fx
    y = (v - rect.cy) / rect.fy
    xy_d = raw.distort_normalized(torch.stack([x, y], dim=-1))
    return torch.stack(
        [xy_d[..., 0] * raw.fx + raw.cx, xy_d[..., 1] * raw.fy + raw.cy], dim=-1
    )


def remap_bilinear(image: torch.Tensor, src_coords: torch.Tensor, fill: float = 0.0):
    """Bilinear remap: image (H, W), src_coords (..., 2) [u, v] -> (...,).
    Each tap is clipped to the image on its own, with the weights of the
    unclipped floor; samples outside [0, W-1] x [0, H-1] return `fill`
    (cv::remap with BORDER_CONSTANT). NaN coordinates return `fill`."""
    H, W = image.shape
    u, v = src_coords[..., 0], src_coords[..., 1]
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    # Coordinates far outside (or NaN) index pixel 0 and are filled below.
    u0i = torch.where(valid, u0, 0.0).to(torch.int64)
    v0i = torch.where(valid, v0, 0.0).to(torch.int64)
    flat = image.reshape(-1)

    def gather(vi, ui):
        return flat[vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)]

    out = (
        gather(v0i, u0i) * (1 - du) * (1 - dv)
        + gather(v0i, u0i + 1) * du * (1 - dv)
        + gather(v0i + 1, u0i) * (1 - du) * dv
        + gather(v0i + 1, u0i + 1) * du * dv
    )
    return torch.where(valid, out, fill)


def compute_roi(valid_mask: np.ndarray, margin: int = 5) -> tuple[int, int, int, int]:
    """(x0, y0, w, h) of the band of fully valid rows and columns, shrunk by
    `margin` on every side and rounded down to multiples of 16 so that a
    5-level pyramid divides evenly (after uw-slam's black-border scan,
    src/System.cpp:148-191)."""
    rows = valid_mask.all(axis=1)
    cols = valid_mask.all(axis=0)

    def band(flags):
        idx = np.flatnonzero(flags)
        if len(idx) == 0:
            return 0, len(flags)
        return int(idx[0]), int(idx[-1] - idx[0] + 1)

    y0, h = band(rows)
    x0, w = band(cols)
    w = max(w - 2 * margin, 0)
    h = max(h - 2 * margin, 0)
    return x0 + margin, y0 + margin, w - w % 16, h - h % 16
