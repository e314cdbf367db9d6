"""Debug panels as PNG files, in place of uw-slam's interactive imshow
windows (src/Tracker.cpp): DebugShowCandidatePoints (:1657),
DebugShowResidual (:1673), DebugShowWarpedPerspective (:1694) and
DebugShowJacobians (:1541).

Counterpart of `uwslam_tpu.viz.debug`. The drawing is host numpy; the
quantities drawn come from the port's tracker on the points' device:
`save_warped_panels` samples with `image.pyramid.bilinear_sample` (kernel
K3 on a CUDA tensor, its plain version on a CPU one) and
`save_jacobian_panels` calls `tracking.photometric.residuals_and_jacobian`.
Points are one frame's `TrackPoints`, with or without a leading batch
axis of 1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..image.pyramid import bilinear_sample


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = np.percentile(img, [1, 99])
    img = (img - lo) / max(hi - lo, 1e-6)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _save(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x, dev) -> torch.Tensor:
    """An array or tensor as f32 on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def save_candidate_points(path: str, image, pts_uv, valid) -> None:
    """The valid points drawn red on the image (DebugShowCandidatePoints)."""
    img = np.stack([_to_u8(_np(image))] * 3, axis=-1)
    uv = _np(pts_uv).reshape(-1, 2)[_np(valid).reshape(-1)]
    H, W = img.shape[:2]
    u = np.clip(uv[:, 0].astype(int), 0, W - 1)
    v = np.clip(uv[:, 1].astype(int), 0, H - 1)
    img[v, u] = (255, 32, 32)
    _save(path, img)


def save_residual_map(path: str, image, pts_uv, residuals, valid) -> None:
    """Residuals at their pixels, positive red and negative blue, scaled by
    their 95th percentile of |r| (DebugShowResidual)."""
    img = np.stack([_to_u8(_np(image))] * 3, axis=-1)
    uv = _np(pts_uv).reshape(-1, 2)
    r = _np(residuals).reshape(-1)
    m = _np(valid).reshape(-1)
    H, W = img.shape[:2]
    u = np.clip(uv[m, 0].astype(int), 0, W - 1)
    v = np.clip(uv[m, 1].astype(int), 0, H - 1)
    rr = r[m]
    scale = max(float(np.percentile(np.abs(rr), 95)), 1e-6)
    pos = np.clip(rr / scale, 0, 1)
    neg = np.clip(-rr / scale, 0, 1)
    img[v, u, 0] = (255 * pos).astype(np.uint8)
    img[v, u, 2] = (255 * neg).astype(np.uint8)
    img[v, u, 1] = 0
    _save(path, img)


def save_warped_panels(path_prefix: str, ref_img, tgt_img, pts, T, cam) -> None:
    """The tracker's result in four panels (DebugShowWarpedPerspective):
    reference, target, the points warped by T (4, 4) (reference to target)
    drawn on the target, and their residual map."""
    from ..lie import se3

    dev = pts.p3d.device
    uv_t = cam.project(se3.apply(_on(T, dev).reshape(4, 4), pts.p3d.reshape(-1, 3)))
    i_t, inb = bilinear_sample(_on(tgt_img, dev), uv_t)
    r = _np(i_t) - _np(pts.intensity).reshape(-1)
    valid = _np(pts.valid).reshape(-1) & _np(inb)
    uv_t = _np(uv_t)
    _save(path_prefix + "_ref.png", _to_u8(_np(ref_img)))
    _save(path_prefix + "_tgt.png", _to_u8(_np(tgt_img)))
    save_candidate_points(path_prefix + "_warped.png", tgt_img, uv_t, valid)
    save_residual_map(path_prefix + "_residual.png", tgt_img, uv_t, r, valid)


def save_jacobian_panels(path_prefix: str, ref_pyr_level, pts, T, cam) -> None:
    """|J| of each twist column at the points, one panel per column
    (DebugShowJacobians); `ref_pyr_level` is (image, grad_x, grad_y) of one
    level, (H, W) each."""
    from ..tracking.photometric import residuals_and_jacobian
    from ..tracking.points import TrackPoints

    dev = pts.p3d.device

    def batch1(x, tail):
        return None if x is None else x.reshape(1, -1, *tail)

    p1 = TrackPoints(uv=batch1(pts.uv, (2,)), p3d=batch1(pts.p3d, (3,)),
                     intensity=batch1(pts.intensity, ()), valid=batch1(pts.valid, ()),
                     gx0=batch1(pts.gx0, ()), gy0=batch1(pts.gy0, ()))
    planes = [_on(x, dev)[None] for x in ref_pyr_level]
    _, J, valid = residuals_and_jacobian(_on(T, dev).reshape(1, 4, 4), p1, p1.intensity,
                                         *planes, cam)
    J, valid = _np(J[0]), _np(valid[0])
    for col, name in enumerate(("vx", "vy", "vz", "wx", "wy", "wz")):
        save_residual_map(f"{path_prefix}_J_{name}.png", _np(ref_pyr_level[0]), _np(pts.uv),
                          J[:, col], valid)
