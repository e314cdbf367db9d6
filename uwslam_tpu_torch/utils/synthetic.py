"""Synthetic textured-plane views with exact ground truth, in PyTorch.

Counterpart of `smooth_texture`, `render_plane_view`,
`render_plane_view_distorted` and `plane_depth` in
`uwslam_tpu.utils.synthetic`. The JAX package draws the texture's
sinusoid coefficients from `jax.random` with a seed; the port carries the
seed-0 coefficients (the benchmark scene) as literals, so both packages
render the same scene. `tests/test_torch_synthetic.py` checks the literals
against `jax.random`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..camera.model import PinholeCamera
from ..lie import se3


class Texture(NamedTuple):
    """A sum of 12 sinusoids: amps[i] sin(freqs[i] . (x, y) + phases[i])."""

    freqs: np.ndarray    # (12, 2) f32
    phases: np.ndarray   # (12,) f32
    amps: np.ndarray     # (12,) f32


# jax.random coefficients of smooth_texture(seed=0, detail=1.0).
TEXTURE_SEED0 = Texture(
    freqs=np.array(
        [
            [5.13272762298584, 1.503082513809204],
            [1.7494795322418213, 1.1639909744262695],
            [1.55497407913208, 4.47108268737793],
            [4.709950923919678, 1.3389724493026733],
            [5.734384536743164, 0.6612075567245483],
            [1.042907953262329, 3.542287826538086],
            [1.1844590902328491, 3.7700912952423096],
            [5.7771992683410645, 4.31274938583374],
            [4.482527732849121, 2.249903917312622],
            [5.010393142700195, 4.025644302368164],
            [1.946427345275879, 1.5560879707336426],
            [4.767398357391357, 5.208416938781738],
        ],
        dtype=np.float32,
    ),
    phases=np.array(
        [
            0.0458051934838295, 0.13119667768478394, 3.6513586044311523,
            2.2723426818847656, 1.400676965713501, 0.7491307258605957,
            0.7877565026283264, 3.873692512512207, 0.5966458916664124,
            6.175893783569336, 2.6678829193115234, 5.227974891662598,
        ],
        dtype=np.float32,
    ),
    amps=np.array(
        [
            0.931714653968811, 0.938605010509491, 0.5387333631515503,
            0.4540637731552124, 0.7538636922836304, 0.6552746295928955,
            0.8020430207252502, 0.45794880390167236, 0.7137130498886108,
            0.34773892164230347, 0.4261920750141144, 0.9729185104370117,
        ],
        dtype=np.float32,
    ),
)


def smooth_texture(
    x: torch.Tensor, y: torch.Tensor, texture: Texture = TEXTURE_SEED0
) -> torch.Tensor:
    """Band-limited texture in [0, 255] at plane coordinates (x, y)."""
    acc = torch.zeros_like(x)
    for (fx, fy), ph, a in zip(texture.freqs, texture.phases, texture.amps):
        acc = acc + float(a) * torch.sin(float(fx) * x + float(fy) * y + float(ph))
    # f32 sum in index order, as the JAX package's reduction adds them.
    hi = float(functools.reduce(lambda s, a: np.float32(s + a), texture.amps))
    return (acc + hi) / (2.0 * hi) * 255.0


def _plane_hit(cam: PinholeCamera, T_cam_world: torch.Tensor, plane_z: float,
               undistort: bool = False):
    """Ray parameter t and world (x, y) where each pixel's ray meets the
    plane z = plane_z; T_cam_world (..., 4, 4) -> (..., H, W) each. With
    undistort=True a pixel's ray is its undistorted normalized coordinate
    (the pixels are those of the raw, distorted image)."""
    dev, dt = T_cam_world.device, T_cam_world.dtype
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=dt, device=dev),
        torch.arange(cam.width, dtype=dt, device=dev),
        indexing="ij",
    )
    xy = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy], dim=-1)
    if undistort:
        xy = cam.undistort_normalized(xy)
    d = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)   # (H, W, 3)
    T_world_cam = se3.inverse(T_cam_world)
    o_w = se3.translation(T_world_cam)[..., None, None, :]  # (..., 1, 1, 3)
    d_w = torch.einsum("...ij,hwj->...hwi", se3.rotation(T_world_cam), d)
    dz = d_w[..., 2]
    t = (plane_z - o_w[..., 2]) / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    return t, o_w[..., 0] + t * d_w[..., 0], o_w[..., 1] + t * d_w[..., 1]


def render_plane_view(
    cam: PinholeCamera,
    T_cam_world: torch.Tensor,
    plane_z: float = 2.0,
    texture: Texture = TEXTURE_SEED0,
) -> torch.Tensor:
    """View of the textured world plane z = plane_z from camera pose(s)
    T_cam_world (..., 4, 4) -> (..., H, W) f32 (world frame == the identity
    view's camera frame)."""
    t, px, py = _plane_hit(cam, T_cam_world, plane_z)
    return torch.where(t <= 0, 0.0, smooth_texture(px, py, texture))


def render_plane_view_distorted(
    cam: PinholeCamera,
    T_cam_world: torch.Tensor,
    plane_z: float = 2.0,
    texture: Texture = TEXTURE_SEED0,
) -> torch.Tensor:
    """`render_plane_view` as a distorted camera sees it (`cam` carries the
    radtan coefficients): the input of the rectification path."""
    t, px, py = _plane_hit(cam, T_cam_world, plane_z, undistort=True)
    return torch.where(t <= 0, 0.0, smooth_texture(px, py, texture))


def plane_depth(
    cam: PinholeCamera, T_cam_world: torch.Tensor, plane_z: float = 2.0
) -> torch.Tensor:
    """Exact camera-frame depth of the plane per pixel (rays have unit z)."""
    t, _, _ = _plane_hit(cam, T_cam_world, plane_z)
    return torch.clamp(t, min=0.0)
