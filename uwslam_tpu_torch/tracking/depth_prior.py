"""Monocular depth bootstrapping: triangulated sparse depth -> dense prior.

Counterpart of `uwslam_tpu.tracking.depth_prior`. Pure monocular tracking
starts from a constant depth (uw-slam src/Tracker.cpp:1228-1232), exact only
for a fronto-parallel plane. This module (1) triangulates the feature
matches of the front end against the tracked relative pose, (2) rasterizes
the inverse depths into a coarse grid of `block`-pixel cells and (3) fills
unobserved cells and samples the grid bilinearly at the next frame's track
points. Inverse depth is the interpolation variable: the photometric warp is
linear in it.

The JAX package rasterizes with segment sums; here the sum over the points
of a cell is a product with the points' one-hot cell table, which adds in a
fixed order on a CUDA device too (a scatter-add would use float atomics and
change its bits from run to run).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..features.geometry import triangulate_linear
from ..lie import se3


class DepthPrior(NamedTuple):
    """Coarse inverse-depth grid over the image."""

    inv_depth: torch.Tensor   # (Hb, Wb) f32 inverse depth per cell
    weight: torch.Tensor      # (Hb, Wb) f32 support count
    block: int                # cell size in pixels

    @property
    def ok(self) -> torch.Tensor:
        return self.weight.sum() > 0


class TriangulatedDepth(NamedTuple):
    depth_a: torch.Tensor     # (K,) depth in frame a at uv_a
    depth_b: torch.Tensor     # (K,) depth in frame b at uv_b
    good: torch.Tensor        # (K,) bool quality gate


def triangulate_matches(
    cam: PinholeCamera,
    T_ba: torch.Tensor,
    uv_a: torch.Tensor,
    uv_b: torch.Tensor,
    valid: torch.Tensor,
    min_depth: float = 0.05,
    max_depth: float = 50.0,
    max_reproj_px: float = 2.0,
    min_parallax: float = 2e-3,
) -> TriangulatedDepth:
    """Triangulate matched pixels against the relative pose T_ba (b <- a).

    Gates: cheirality in both frames, depth bounds, reprojection error in b
    and a minimum parallax angle (rad) between the rays: a triangulation
    over a tiny baseline has unbounded depth variance."""
    ones = torch.ones(uv_a.shape[:-1], dtype=uv_a.dtype, device=uv_a.device)
    xy_a = cam.unproject(uv_a, ones)[..., :2]
    xy_b = cam.unproject(uv_b, ones)[..., :2]
    eye = torch.eye(4, dtype=T_ba.dtype, device=T_ba.device)
    pts_a = triangulate_linear(eye, T_ba, xy_a, xy_b)          # frame a
    z_a = pts_a[:, 2]
    pts_b = se3.apply(T_ba, pts_a)
    z_b = pts_b[:, 2]
    reproj = torch.linalg.norm(cam.project(pts_b) - uv_b, dim=-1)

    # Parallax: the angle between the two observation rays, in frame a.
    ra = torch.cat([xy_a, ones[:, None]], dim=-1)
    R_ab = se3.rotation(se3.inverse(T_ba))
    rb = torch.cat([xy_b, ones[:, None]], dim=-1) @ R_ab.T
    cosang = (ra * rb).sum(-1) / (torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1))
    parallax = torch.arccos(torch.clamp(cosang, -1.0, 1.0))

    good = (
        valid
        & (z_a > min_depth) & (z_a < max_depth)
        & (z_b > min_depth) & (z_b < max_depth)
        & (reproj < max_reproj_px)
        & (parallax > min_parallax)
    )
    return TriangulatedDepth(depth_a=z_a, depth_b=z_b, good=good)


def prior_from_points(
    uv: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    height: int,
    width: int,
    block: int = 32,
    weights: torch.Tensor | None = None,
) -> DepthPrior:
    """Rasterize sparse depths (N,) at pixels (N, 2) into a coarse
    inverse-depth grid: per cell the weighted mean inverse depth and the
    weight sum. `weights` are optional confidences per point; without them
    every valid point votes once."""
    Hb = -(-height // block)
    Wb = -(-width // block)
    # NaN pixels (a point behind the camera) are invalid already; route
    # them to cell 0 with weight 0.
    u = torch.nan_to_num(uv[:, 0], nan=0.0, posinf=0.0, neginf=0.0)
    v = torch.nan_to_num(uv[:, 1], nan=0.0, posinf=0.0, neginf=0.0)
    cx = torch.clamp(torch.floor(u / block), 0, Wb - 1).long()
    cy = torch.clamp(torch.floor(v / block), 0, Hb - 1).long()
    cell = cy * Wb + cx
    inv = torch.where(valid, 1.0 / torch.clamp(depth, min=1e-6), 0.0)
    w = valid.to(torch.float32)
    if weights is not None:
        w = w * torch.clamp(weights, min=0.0)
    onehot = (cell[None, :] == torch.arange(Hb * Wb, device=uv.device)[:, None]).float()
    sums = onehot @ torch.stack([inv * w, w], dim=-1)          # (Hb*Wb, 2)
    num, den = sums[:, 0], sums[:, 1]
    inv_grid = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return DepthPrior(inv_depth=inv_grid.reshape(Hb, Wb), weight=den.reshape(Hb, Wb),
                      block=block)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of x over mask (the element at (n - 1) // 2 of the sorted
    masked values); 1 for an empty mask."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, torch.inf).reshape(-1)).values
    idx = torch.clamp((n - 1) // 2, 0, x.numel() - 1)
    # index_select: indexing by a 0-dim tensor would read it on the host.
    return torch.where(n > 0, s.index_select(0, idx.reshape(1))[0], 1.0)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x moved by (dy, dx) cells, zeros entering at the edge."""
    out = torch.zeros_like(x)
    H, W = x.shape
    ys = slice(max(dy, 0), H + min(dy, 0))
    yt = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xt = slice(max(-dx, 0), W + min(-dx, 0))
    out[ys, xs] = x[yt, xt]
    return out


def fill_prior(prior: DepthPrior) -> DepthPrior:
    """Fill unobserved cells: 3 rounds of neighbour averaging (weighted by
    support), then the global median for whatever is still empty. A grid
    with no support at all stays zero (`sample_prior` then falls back), so
    callers can fuse sources gated on the device without a host check."""
    inv, w = prior.inv_depth, torch.clamp(prior.weight, max=8.0)

    def spread(inv, w):
        acc_v = inv * w
        acc_w = w
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            acc_v = acc_v + 0.5 * _shift(inv * w, dy, dx)
            acc_w = acc_w + 0.5 * _shift(w, dy, dx)
        new_inv = torch.where(acc_w > 0, acc_v / torch.clamp(acc_w, min=1e-6), 0.0)
        # Observed cells keep their value; empty ones adopt the neighbourhood.
        keep = w > 0
        return torch.where(keep, inv, new_inv), torch.where(
            keep, w, (acc_w > 0).to(w.dtype) * 0.25
        )

    for _ in range(3):
        inv, w = spread(inv, w)
    med = _masked_median(inv, w > 0)
    med = torch.where(prior.weight.sum() > 0, med, 0.0)
    inv = torch.where(w > 0, inv, med)
    return DepthPrior(inv_depth=inv, weight=torch.clamp(w, min=1e-3), block=prior.block)


def gauge_ratio(new: DepthPrior, ref: DepthPrior, min_weight: float = 0.2) -> torch.Tensor:
    """Median ratio new / ref of inverse depths over jointly supported cells
    (1 with fewer than 8 of them). Monocular scale is a gauge freedom:
    dividing each measurement grid by this ratio pins its scale to the
    geometrically propagated prior, so the scale fixed at the bootstrap is
    carried and never re-estimated from per-frame noise."""
    mask = (
        (new.weight >= min_weight) & (ref.weight >= min_weight)
        & (new.inv_depth > 1e-6) & (ref.inv_depth > 1e-6)
    )
    ratio = new.inv_depth / torch.clamp(ref.inv_depth, min=1e-6)
    return torch.where(mask.sum() >= 8, _masked_median(ratio, mask), 1.0)


def _sample_prior_taps(prior: DepthPrior, uv: torch.Tensor):
    """Bilinear read of the grid at pixels (..., 2) (cells are centred at
    (i + 0.5) * block) -> (value (...), the four taps (4, ...))."""
    Hb, Wb = prior.inv_depth.shape
    gx = uv[..., 0] / prior.block - 0.5
    gy = uv[..., 1] / prior.block - 0.5
    x0 = torch.clamp(torch.floor(gx), 0, Wb - 2)
    y0 = torch.clamp(torch.floor(gy), 0, Hb - 2)
    dx = torch.clamp(gx - x0, 0.0, 1.0)
    dy = torch.clamp(gy - y0, 0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    g = prior.inv_depth
    i00 = g[y0, x0]
    i01 = g[y0, x0 + 1]
    i10 = g[y0 + 1, x0]
    i11 = g[y0 + 1, x0 + 1]
    inv = (
        i00 * (1 - dx) * (1 - dy)
        + i01 * dx * (1 - dy)
        + i10 * (1 - dx) * dy
        + i11 * dx * dy
    )
    return inv, torch.stack([i00, i01, i10, i11])


def _shrunk(prior: DepthPrior, inv: torch.Tensor, shrink: float) -> torch.Tensor:
    if shrink >= 1.0:
        return inv
    med = _masked_median(prior.inv_depth, prior.weight > 0)
    return torch.where(inv > 1e-6, shrink * inv + (1.0 - shrink) * med, inv)


def sample_prior(prior: DepthPrior, uv: torch.Tensor, fallback: float = 1.0,
                 shrink: float = 1.0) -> torch.Tensor:
    """Bilinear sample of the inverse-depth grid at pixels (..., 2); returns
    DEPTH, `fallback` where the grid has none. `shrink` < 1 blends each read
    toward the grid's median inverse depth."""
    inv, _ = _sample_prior_taps(prior, uv)
    inv = _shrunk(prior, inv, shrink)
    return torch.where(inv > 1e-6, 1.0 / torch.clamp(inv, min=1e-6), fallback)


def sample_prior_checked(
    prior: DepthPrior,
    uv: torch.Tensor,
    fallback: float = 1.0,
    max_edge_ratio: float = 1.6,
    min_support: float = 0.5,
    shrink: float = 1.0,
):
    """`sample_prior` with a discontinuity flag -> (depth, ok). ok is False
    where the four interpolation cells differ by more than `max_edge_ratio`
    (a bilinear read across a depth edge lands between the surfaces) or
    where the interpolated support is below `min_support` (hole-filled
    cells carry a token weight)."""
    inv, taps = _sample_prior_taps(prior, uv)
    tmin, tmax = taps.amin(0), taps.amax(0)
    w, _ = _sample_prior_taps(DepthPrior(prior.weight, prior.weight, prior.block), uv)
    ok = (inv > 1e-6) & (tmin > 1e-6) & (tmax <= tmin * max_edge_ratio) & (w >= min_support)
    inv = _shrunk(prior, inv, shrink)
    return torch.where(ok, 1.0 / torch.clamp(inv, min=1e-6), fallback), ok


def propagate_prior(prior: DepthPrior, T_ba: torch.Tensor, cam: PinholeCamera) -> DepthPrior:
    """Warp a frame-a prior into frame b by the relative pose T_ba: unproject
    the cell centres at their depths, transform, rasterize again. Keeps the
    prior alive across frames without matches; the propagated support
    decays so that fresh triangulations dominate."""
    Hb, Wb = prior.inv_depth.shape
    dev = prior.inv_depth.device
    yy, xx = torch.meshgrid(
        torch.arange(Hb, dtype=torch.float32, device=dev),
        torch.arange(Wb, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    uv = torch.stack(
        [(xx.reshape(-1) + 0.5) * prior.block, (yy.reshape(-1) + 0.5) * prior.block], dim=-1
    )
    inv = prior.inv_depth.reshape(-1)
    w = prior.weight.reshape(-1)
    p_b = se3.apply(T_ba, cam.unproject(uv, 1.0 / torch.clamp(inv, min=1e-6)))
    uv_b = cam.project(p_b)
    valid = (
        (w > 0) & (inv > 1e-6) & (p_b[:, 2] > 1e-3)
        & (uv_b[:, 0] >= 0) & (uv_b[:, 0] < cam.width)
        & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < cam.height)
    )
    new = prior_from_points(uv_b, p_b[:, 2], valid, cam.height, cam.width, block=prior.block)
    return new._replace(weight=torch.clamp(new.weight, max=4.0) * 0.5)
