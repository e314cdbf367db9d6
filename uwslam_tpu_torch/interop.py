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
    """From an object with the fields of `uwslam_tpu.camera.PinholeCamera`.
    The port's camera has no distortion; a distorted camera is refused."""
    for name in ("k1", "k2", "p1", "p2"):
        if abs(float(getattr(cam, name, 0.0))) > 1e-12:
            raise ValueError(f"camera has distortion ({name}); not ported")
    return PinholeCamera(
        fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
        width=int(cam.width), height=int(cam.height),
    )


def pyramid_from_numpy(pyr, device="cpu") -> FramePyramid:
    """From an object with the fields of `uwslam_tpu.image.FramePyramid`
    (images, grad_x, grad_y, grad_mag: one (B, H_l, W_l) array per level)."""
    return FramePyramid(
        *(tuple(_tensor(x, device) for x in getattr(pyr, f))
          for f in FramePyramid._fields)
    )


def points_from_numpy(pts, device="cpu") -> TrackPoints:
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


def texture_from_numpy(freqs, phases, amps) -> Texture:
    """Sinusoid coefficients (12, 2), (12,), (12,) of a smooth texture."""
    return Texture(
        freqs=np.asarray(freqs, np.float32),
        phases=np.asarray(phases, np.float32),
        amps=np.asarray(amps, np.float32),
    )
