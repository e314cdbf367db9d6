"""Synthetic textured-plane views with exact ground truth, in PyTorch.

Counterpart of `smooth_texture`, `fractal_texture`, `render_plane_view`,
`render_plane_view_distorted`, `plane_depth`, the two-depth scene
(`render_two_plane_view`, `two_plane_depth`), the multi-plane scene
(`PlaneSpec`, `make_plane`, `default_scene`, `render_scene_view`,
`scene_depth`, `render_scene_view_distorted`), `apply_photometric`,
`depth_holes` and `orbit_trajectory` in `uwslam_tpu.utils.synthetic`. The
JAX package draws the texture's sinusoid coefficients from `jax.random`
with a seed; the port carries the seed-0 coefficients (the benchmark scene)
as literals, so both packages render the same scene.
`tests/test_torch_synthetic.py` checks the literals against `jax.random`.
The textures of the multi-plane scenes are literals too (`_scene_textures`:
the smooth ones keyed by seed and detail, the broadband ones of the
evaluation's scene by seed, detail and octaves).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..camera.model import PinholeCamera
from ..lie import se3
from ._scene_textures import COEFFICIENTS, FRACTAL_COEFFICIENTS


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


class FractalTexture(NamedTuple):
    """A broadband (1/f) texture: `octaves` bands of four sinusoids, the
    frequency doubling and the amplitude falling by 0.55 per band."""

    freqs: np.ndarray    # (4 octaves, 2) f32
    phases: np.ndarray   # (4 octaves,) f32
    amps: np.ndarray     # (4 octaves,) f32, the 0.55^o factor included
    octaves: int


def fractal_texture(x: torch.Tensor, y: torch.Tensor, texture: FractalTexture) -> torch.Tensor:
    """Broadband texture in [0, 255] at plane coordinates (x, y): every
    pyramid level keeps signal, where the narrowband `smooth_texture`
    aliases at coarse levels and repeats its minima at fine ones."""
    acc = torch.zeros_like(x)
    for (fx, fy), ph, a in zip(texture.freqs, texture.phases, texture.amps):
        acc = acc + float(a) * torch.sin(float(fx) * x + float(fy) * y + float(ph))
    # The static bound of the sum (every amplitude at most 0.55^o).
    bound = sum(4 * (0.55 ** o) for o in range(texture.octaves))
    return (acc + bound) / (2.0 * bound) * 255.0


def fractal_scene_texture(seed: int, detail: float, octaves: int) -> FractalTexture:
    """The JAX package's `fractal_texture(seed=seed, detail=detail,
    octaves=octaves)` coefficients, for the triples carried as literals."""
    try:
        return FractalTexture(*FRACTAL_COEFFICIENTS[(seed, detail, octaves)], octaves=octaves)
    except KeyError:
        raise KeyError(
            f"no fractal texture literals for seed={seed}, detail={detail}, "
            f"octaves={octaves}; known: {sorted(FRACTAL_COEFFICIENTS)}"
        ) from None


def apply_photometric(image: torch.Tensor, generator: torch.Generator | None = None,
                      noise_sigma: float = 2.0, gain: float = 1.0,
                      bias: float = 0.0) -> torch.Tensor:
    """Photometric degradation: brightness drift (gain and bias, as the JAX
    package applies them: image * gain + bias) and additive Gaussian sensor
    noise of `noise_sigma`, clipped to [0, 255]. The noise comes from
    `generator` (on the image's device), so it is reproducible but not the
    JAX package's draw: `jax.random.normal` cannot be reproduced here."""
    img = image * gain + bias
    if noise_sigma > 0:
        noise = torch.randn(image.shape, generator=generator, dtype=image.dtype,
                            device=image.device)
        img = img + noise_sigma * noise
    return torch.clamp(img, 0.0, 255.0)


def _normalized_grid(cam: PinholeCamera, dev, dt) -> torch.Tensor:
    """Every pixel's normalized coordinate ((u - cx) / fx, (v - cy) / fy):
    (H, W, 2)."""
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=dt, device=dev),
        torch.arange(cam.width, dtype=dt, device=dev),
        indexing="ij",
    )
    return torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy], dim=-1)


def _unit_z(xy: torch.Tensor) -> torch.Tensor:
    """Rays (..., 3) with unit z through normalized coordinates (..., 2)."""
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _plane_hit(cam: PinholeCamera, T_cam_world: torch.Tensor, plane_z: float,
               undistort: bool = False):
    """Ray parameter t and world (x, y) where each pixel's ray meets the
    plane z = plane_z; T_cam_world (..., 4, 4) -> (..., H, W) each. With
    undistort=True a pixel's ray is its undistorted normalized coordinate
    (the pixels are those of the raw, distorted image)."""
    xy = _normalized_grid(cam, T_cam_world.device, T_cam_world.dtype)
    if undistort:
        xy = cam.undistort_normalized(xy)
    d = _unit_z(xy)   # (H, W, 3)
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


def _two_plane_hit(cam: PinholeCamera, T_cam_world: torch.Tensor, z_near: float,
                   z_far: float):
    """Ray parameter t and world (x, y) of the two-depth scene: world x < 0
    lies on the plane z = z_near, x >= 0 on z = z_far."""
    t1, px1, py1 = _plane_hit(cam, T_cam_world, z_near)
    t2, px2, py2 = _plane_hit(cam, T_cam_world, z_far)
    near = px1 < 0.0
    return (torch.where(near, t1, t2), torch.where(near, px1, px2),
            torch.where(near, py1, py2))


def render_two_plane_view(
    cam: PinholeCamera,
    T_cam_world: torch.Tensor,
    z_near: float = 2.0,
    z_far: float = 3.5,
    texture: Texture = TEXTURE_SEED0,
) -> torch.Tensor:
    """View of the two-depth scene from camera pose(s) T_cam_world
    (..., 4, 4) -> (..., H, W) f32. A single plane is degenerate for
    two-view geometry and for joint pose-and-depth refinement (the
    plane-induced homography); this scene has depth structure."""
    t, px, py = _two_plane_hit(cam, T_cam_world, z_near, z_far)
    return torch.where(t <= 0, 0.0, smooth_texture(px, py, texture))


def two_plane_depth(
    cam: PinholeCamera, T_cam_world: torch.Tensor, z_near: float = 2.0, z_far: float = 3.5
) -> torch.Tensor:
    """Exact camera-frame depth of `render_two_plane_view`'s scene per pixel
    (rays have unit z, so depth is the ray parameter)."""
    t, _, _ = _two_plane_hit(cam, T_cam_world, z_near, z_far)
    return torch.clamp(t, min=0.0)


class PlaneSpec(NamedTuple):
    """A finite textured plane patch: a point p0, unit orthogonal in-plane
    axes e1 and e2, half extents (a1, a2) along them (<= 0: infinite) and a
    texture, for scenes of several planes with real occlusion boundaries."""

    p0: np.ndarray       # (3,) f32 a point of the plane (world frame)
    e1: np.ndarray       # (3,) f32 in-plane axis
    e2: np.ndarray       # (3,) f32 in-plane axis
    a1: float
    a2: float
    texture: Texture | FractalTexture


def scene_texture(seed: int, detail: float) -> Texture:
    """The JAX package's `smooth_texture(seed=seed, detail=detail)`
    coefficients, for the (seed, detail) pairs carried as literals."""
    try:
        return Texture(*COEFFICIENTS[(seed, detail)])
    except KeyError:
        raise KeyError(
            f"no texture literals for seed={seed}, detail={detail}; known: "
            f"{sorted(COEFFICIENTS)}"
        ) from None


def make_plane(center, normal=(0.0, 0.0, -1.0), extent=(0.0, 0.0), seed: int = 0,
               detail: float = 1.0, texture: Texture | FractalTexture | None = None,
               octaves: int = 1) -> PlaneSpec:
    """A PlaneSpec from a centre and an outward normal; the in-plane axes
    complete the normal to an orthonormal frame and texture coordinates are
    measured along them. The texture is `texture`, else the literals for
    (seed, detail): the narrowband smooth texture at `octaves` 1 (seed 0 at
    detail 1 is the benchmark texture), the broadband fractal one above."""
    n = np.asarray(normal, np.float32)
    n = n / np.linalg.norm(n)
    up = np.asarray([0.0, 1.0, 0.0] if abs(n[1]) < 0.9 else [1.0, 0.0, 0.0], np.float32)
    e1 = np.cross(up, n)
    e1 = (e1 / np.linalg.norm(e1)).astype(np.float32)
    e2 = np.cross(n, e1).astype(np.float32)
    if texture is None and octaves > 1:
        texture = fractal_scene_texture(seed, detail, octaves)
    elif texture is None:
        texture = TEXTURE_SEED0 if (seed, detail) == (0, 1.0) else scene_texture(seed, detail)
    return PlaneSpec(p0=np.asarray(center, np.float32), e1=e1, e2=e2,
                     a1=float(extent[0]), a2=float(extent[1]), texture=texture)


def default_scene() -> tuple[PlaneSpec, ...]:
    """The canonical non-planar test scene: an infinite, slightly tilted
    background plane at z = 4, a large tilted slab on the left and two
    closer occluding patches. Every view from near the origin sees
    occlusion boundaries and at least three depths: what a constant-depth
    assumption gets wrong."""
    return (
        make_plane((0.0, 0.0, 4.0), normal=(0.05, -0.02, -1.0), seed=3, detail=0.9),
        make_plane((-0.9, 0.1, 2.6), normal=(0.35, 0.1, -1.0), extent=(1.1, 1.4),
                   seed=7, detail=1.2),
        make_plane((0.55, -0.25, 1.8), normal=(-0.1, 0.05, -1.0), extent=(0.45, 0.5),
                   seed=11, detail=1.5),
        make_plane((-0.1, 0.75, 2.1), normal=(0.0, -0.3, -1.0), extent=(0.9, 0.25),
                   seed=5, detail=1.3),
    )


def _raycast_scene(cam: PinholeCamera, T_cam_world: torch.Tensor, scene,
                   rays: torch.Tensor | None = None):
    """Nearest hit of every pixel's ray: (t, px, py, plane index), each
    (H, W); t is the ray parameter, equal to the camera-frame depth (rays
    have unit z); index -1 where nothing is hit. `rays` (H, W, 3) overrides
    the pinhole grid (a distorted camera's rays)."""
    dev, dt = T_cam_world.device, T_cam_world.dtype
    if rays is None:
        rays = _unit_z(_normalized_grid(cam, dev, dt))
    d = rays
    T_world_cam = se3.inverse(T_cam_world)
    twc = se3.translation(T_world_cam)
    d_w = torch.einsum("ij,hwj->hwi", se3.rotation(T_world_cam), d)

    t_best = torch.full(d.shape[:2], 1e9, dtype=dt, device=dev)
    px_best = torch.zeros(d.shape[:2], dtype=dt, device=dev)
    py_best = torch.zeros(d.shape[:2], dtype=dt, device=dev)
    idx_best = torch.full(d.shape[:2], -1, dtype=torch.int32, device=dev)
    for i, pl in enumerate(scene):
        p0, e1, e2 = (torch.from_numpy(a).to(dev) for a in (pl.p0, pl.e1, pl.e2))
        n = torch.linalg.cross(e1, e2)
        denom = d_w @ n
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        t = torch.dot(p0 - twc, n) / denom
        rel = twc + t[..., None] * d_w - p0
        s1, s2 = rel @ e1, rel @ e2
        inside = torch.ones_like(t, dtype=torch.bool)
        if pl.a1 > 0:
            inside &= torch.abs(s1) <= pl.a1
        if pl.a2 > 0:
            inside &= torch.abs(s2) <= pl.a2
        hit = (t > 1e-4) & inside & (t < t_best)
        t_best = torch.where(hit, t, t_best)
        px_best = torch.where(hit, s1, px_best)
        py_best = torch.where(hit, s2, py_best)
        idx_best = torch.where(hit, i, idx_best)
    return t_best, px_best, py_best, idx_best


def render_scene_view(cam: PinholeCamera, T_cam_world: torch.Tensor,
                      scene: tuple[PlaneSpec, ...] | None = None) -> torch.Tensor:
    """View (H, W) of a scene of occluding planes from the camera pose
    T_cam_world (4, 4): nearest-hit ray cast against every plane, each with
    its own texture (at 3 x the plane coordinates); 0 where nothing is hit."""
    scene = default_scene() if scene is None else scene
    return _shade(scene, *_raycast_scene(cam, T_cam_world, scene))


def _shade(scene, t, px, py, idx) -> torch.Tensor:
    """Each pixel's texture value on the plane it hit (3 x the plane
    coordinates); 0 where nothing is hit."""
    img = torch.zeros_like(t)
    for i, pl in enumerate(scene):
        texture = fractal_texture if isinstance(pl.texture, FractalTexture) else smooth_texture
        img = torch.where(idx == i, texture(px * 3.0, py * 3.0, pl.texture), img)
    return torch.where(idx >= 0, img, 0.0)


def scene_depth(cam: PinholeCamera, T_cam_world: torch.Tensor,
                scene: tuple[PlaneSpec, ...] | None = None) -> torch.Tensor:
    """Exact camera-frame depth (H, W) of `render_scene_view`'s geometry; 0
    where no plane is hit."""
    scene = default_scene() if scene is None else scene
    t, _, _, idx = _raycast_scene(cam, T_cam_world, scene)
    return torch.where(idx >= 0, t, 0.0)


def render_scene_view_distorted(cam: PinholeCamera, T_cam_world: torch.Tensor,
                                scene: tuple[PlaneSpec, ...] | None = None) -> torch.Tensor:
    """`render_scene_view` as a distorted camera sees it (`cam` carries the
    radtan coefficients): each raw pixel's ray is the undistorted normalized
    coordinate. The EUROC-style input of the rectification path on
    occluding geometry."""
    scene = default_scene() if scene is None else scene
    xy = cam.undistort_normalized(_normalized_grid(cam, T_cam_world.device, T_cam_world.dtype))
    return _shade(scene, *_raycast_scene(cam, T_cam_world, scene, rays=_unit_z(xy)))


def depth_hole_mask(uniforms: torch.Tensor, shape: tuple[int, int], hole_frac: float,
                    block: int) -> torch.Tensor:
    """The blocks of `depth_holes` knocked out by (Hb, Wb) uniforms in
    [0, 1): a block is dropped where its uniform is below `hole_frac`;
    -> (H, W) bool, each block `block` pixels square, cut to `shape`."""
    drop = uniforms < hole_frac
    full = drop.repeat_interleave(block, 0).repeat_interleave(block, 1)
    return full[:shape[0], :shape[1]]


def depth_holes(depth: torch.Tensor, generator: torch.Generator | None = None,
                hole_frac: float = 0.2, block: int = 16) -> torch.Tensor:
    """Knock out random blocks of a depth map (0 is invalid): the holes real
    TUM depth images carry at occlusion boundaries and on reflective
    surfaces. `hole_frac` is the expected fraction of blocks lost. The
    uniforms come from `generator` (on the depth's device), so the blocks
    are reproducible but not the JAX package's draw."""
    H, W = depth.shape
    u = torch.rand((-(-H // block), -(-W // block)), generator=generator, device=depth.device)
    return torch.where(depth_hole_mask(u, (H, W), hole_frac, block), 0.0, depth)


def orbit_trajectory(num_frames: int, radius: float = 0.05, step: float = 0.02,
                     device=None) -> torch.Tensor:
    """A gentle camera path: slow sideways drift and a little yaw ->
    (num_frames, 4, 4) camera-from-world poses."""
    i = torch.arange(num_frames, dtype=torch.float32, device=device)
    xi = torch.stack([radius * torch.sin(0.3 * i),
                      0.5 * radius * torch.cos(0.21 * i) - 0.5 * radius,
                      step * 0.3 * i, 0.002 * i, 0.015 * torch.sin(0.2 * i), 0.003 * i], dim=-1)
    return se3.exp(xi)
