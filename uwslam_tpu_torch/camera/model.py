"""Pinhole camera (no distortion), in PyTorch.

Counterpart of `uwslam_tpu.camera.model.PinholeCamera` for the undistorted
tracking path. Intrinsics are Python floats, so each level's camera is a
constant of the code that uses it.
"""
from __future__ import annotations

from dataclasses import dataclass

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

    def project_jacobian(self, pts: torch.Tensor) -> torch.Tensor:
        """d(u, v)/d(x, y, z): (..., 3) -> (..., 2, 3)."""
        x, y = pts[..., 0], pts[..., 1]
        zi = 1.0 / _safe_z(pts[..., 2])
        zi2 = zi * zi
        zero = torch.zeros_like(x)
        row_u = torch.stack([self.fx * zi, zero, -self.fx * x * zi2], dim=-1)
        row_v = torch.stack([zero, self.fy * zi, -self.fy * y * zi2], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
