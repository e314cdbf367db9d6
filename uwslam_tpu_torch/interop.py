"""Carry state from the JAX package into the port.

Each function takes the JAX package's object (or its fields) as numpy
arrays and plain numbers and returns the port's counterpart, so both
packages can compute on identical inputs. Nothing here imports JAX: a
caller holding JAX arrays passes them through `numpy.asarray`, which these
functions apply to every field.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera.model import PinholeCamera
from .image.pyramid import FramePyramid
from .tracking.points import TrackPoints
from .utils.synthetic import Texture


def _tensor(x, device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def camera_from_jax(cam) -> PinholeCamera:
    """From an object with the fields of `uwslam_tpu.camera.PinholeCamera`,
    the radtan coefficients included."""
    return PinholeCamera(
        fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
        width=int(cam.width), height=int(cam.height),
        **{k: float(getattr(cam, k, 0.0)) for k in ("k1", "k2", "p1", "p2")},
    )


def depth_from_numpy(depth, device) -> torch.Tensor:
    """A depth image (H, W), or a stack of them, in raw sensor units (TUM:
    16-bit, 5000 per metre) as f32 on `device`; 16-bit values are exact."""
    return _tensor(depth, device)


def pyramid_from_numpy(pyr, device) -> FramePyramid:
    """From an object with the fields of `uwslam_tpu.image.FramePyramid`
    (images, grad_x, grad_y, grad_mag: one (B, H_l, W_l) array per level)."""
    return FramePyramid(
        *(tuple(_tensor(x, device) for x in getattr(pyr, f))
          for f in FramePyramid._fields)
    )


def points_from_numpy(pts, device) -> TrackPoints:
    """From an object with the fields of `uwslam_tpu.tracking.TrackPoints`
    ((B, N, ...) arrays; gx0/gy0 may be None)."""
    def opt(x):
        return None if x is None else _tensor(x, device)

    return TrackPoints(
        uv=_tensor(pts.uv, device),
        p3d=_tensor(pts.p3d, device),
        intensity=_tensor(pts.intensity, device),
        valid=_tensor(pts.valid, device, dtype=bool),
        gx0=opt(pts.gx0),
        gy0=opt(pts.gy0),
    )


def descriptor_projection_from_numpy(m, device) -> torch.Tensor:
    """The (64, 64) descriptor projection as the port's `describe` takes it
    (`proj=`), from the JAX package's `_projection_matrix(64, 64)`."""
    t = _tensor(m, device)
    if tuple(t.shape) != (64, 64):
        raise ValueError(f"descriptor projection must be (64, 64), got {tuple(t.shape)}")
    return t


def texture_from_numpy(freqs, phases, amps) -> Texture:
    """Sinusoid coefficients (12, 2), (12,), (12,) of a smooth texture."""
    return Texture(
        freqs=np.asarray(freqs, np.float32),
        phases=np.asarray(phases, np.float32),
        amps=np.asarray(amps, np.float32),
    )
