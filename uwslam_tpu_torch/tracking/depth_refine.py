"""Per-point photometric refinement of inverse depth (an LSD-SLAM-style
filter), counterpart of `uwslam_tpu.tracking.depth_refine`.

Given a tracked relative pose T (target <- reference), the inverse depth rho
of each reference point is refined by Gauss-Newton on the photometric
residual of the pose tracker, in its one depth direction:

    r(rho) = I_tgt(pi(R x + rho t)) - I_ref,   x = K^-1 [u, v, 1]

(pi is scale invariant, so pi((1 / rho) R x + t) = pi(R x + rho t) for
rho > 0) with dr/drho = grad I_tgt . J_pi(R x + rho t) . t.

Each of the `iters` + 1 evaluations samples the target's intensity and both
gradients at the projected points: one launch of kernel K3 on the frame's
texels (`ops.cuda_sample`, C = 3) for a CUDA tensor, its plain version for
a CPU tensor. Points and images carry the leading batch dimension of the
port's `TrackPoints` and pyramid levels (B = 1 on the live path).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..lie import se3
from ..ops.cuda_sample import cuda_bilinear_sample, pack_texels
from .photometric import _affine_residual
from .points import TrackPoints


class RefinedDepth(NamedTuple):
    inv_depth: torch.Tensor   # (B, N) refined inverse depths (reference frame)
    good: torch.Tensor        # (B, N) refinement believed (converged, observable)
    slope: torch.Tensor       # (B, N) |dr/drho| at convergence: the estimate's
    #                           observability; its square ~ inverse variance


def refine_inverse_depth(
    pts: TrackPoints,
    T: torch.Tensor,
    image: torch.Tensor,
    grad_x: torch.Tensor,
    grad_y: torch.Tensor,
    cam: PinholeCamera,
    iters: int = 4,
    min_depth: float = 0.05,
    max_depth: float = 50.0,
    min_slope: float = 0.5,
    max_residual: float = 12.0,
    ab: torch.Tensor | None = None,
) -> RefinedDepth:
    """Gauss-Newton on the inverse depth of every point at the fixed pose T
    (4, 4), against the target's level-0 image and gradients (B, H, W).
    A point is `good` when its depth slope |dr/drho| is observable (parallax
    times texture), its final residual small and its depth in bounds;
    otherwise it keeps its refined value but is not believed.

    `ab` (2,) or (B, 2): the tracker's affine brightness estimate for the
    pair; the residual is compensated by the model the pose was solved
    under."""
    R = se3.rotation(T)
    t = se3.translation(T)
    ones = torch.ones(pts.uv.shape[:-1], dtype=pts.uv.dtype, device=pts.uv.device)
    Rx = cam.unproject(pts.uv, ones) @ R.T                     # (B, N, 3)
    rho = 1.0 / torch.clamp(pts.p3d[..., 2], min=1e-6)
    texels = pack_texels(image, grad_x, grad_y)                # (B, H, W, 4)
    if ab is not None:
        ab = ab.reshape(-1, 2)

    def eval_at(rho):
        p = Rx + rho[..., None] * t                            # ~ target direction
        vals, inb = cuda_bilinear_sample(texels, cam.project(p), texels=True)   # K3
        r = vals[:, 0] - pts.intensity
        if ab is not None:
            r = _affine_residual(r, pts.intensity, ab, torch.ones_like(inb))
        duv = cam.project_jacobian(p) @ t                      # (B, N, 2)
        g = vals[:, 1] * duv[..., 0] + vals[:, 2] * duv[..., 1]   # dr/drho
        return r, g, inb & (p[..., 2] > 1e-6)

    for _ in range(iters):
        r, g, ok = eval_at(rho)
        step = torch.where(ok, g * r / (g * g + 1e-4), 0.0)
        # Trust region: inverse depth moves at most 30% per iteration.
        step = torch.maximum(torch.minimum(step, 0.3 * rho), -0.3 * rho)
        rho = torch.clamp(rho - step, 1.0 / max_depth, 1.0 / min_depth)

    r, g, ok = eval_at(rho)
    good = (
        pts.valid & ok
        & (torch.abs(g) > min_slope)          # depth observable at this point
        & (torch.abs(r) < max_residual)       # the alignment explains it
        & (rho > 1.0 / max_depth) & (rho < 1.0 / min_depth)
    )
    return RefinedDepth(inv_depth=rho, good=good, slope=torch.abs(g))


def transfer_depths(pts: TrackPoints, inv_depth: torch.Tensor, good: torch.Tensor,
                    T: torch.Tensor, cam: PinholeCamera):
    """Carry refined reference-frame depths into the target frame: transform
    the refined 3D points by T and project -> (uv_tgt, depth_tgt, ok), ready
    to rasterize into the target frame's depth prior."""
    p_t = se3.apply(T, cam.unproject(pts.uv, 1.0 / torch.clamp(inv_depth, min=1e-6)))
    uv_t = cam.project(p_t)
    ok = (
        good & (p_t[..., 2] > 1e-3)
        & (uv_t[..., 0] >= 0) & (uv_t[..., 0] <= cam.width - 1)
        & (uv_t[..., 1] >= 0) & (uv_t[..., 1] <= cam.height - 1)
    )
    return uv_t, p_t[..., 2], ok
