"""PnP RANSAC: camera pose from 2D-3D correspondences, in PyTorch.

Counterpart of `uwslam_tpu.features.pnp` (`_dlt_pose`, `_planar_poses`,
`_reproj_sq`, `_gn_polish_pose`, `pnp_ransac`, `pnp_from_pixels`), with the
hypotheses as a batch dimension where the JAX package vmaps.

The JAX package draws its minimal samples inside `pnp_ransac` from a
`jax.random` key. The port splits that step out: `sample_hypotheses` draws
Gumbel keys from a `torch.Generator` (on the host, so CPU and card draw the
same samples) and the solver takes the resulting `sample_idx`, so a test
can hand both packages the same samples. The GN polish uses the analytic
Jacobian of the projection under the right update T exp(xi), where the JAX
package differentiates the same residual with `jax.jacfwd`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import se3, so3
from ..utils.linalg import cholesky_solve_unrolled, smallest_eigvec_spd, svd3, sym3_eigh


class PnPResult(NamedTuple):
    T: torch.Tensor            # (4, 4) camera <- points' frame
    inliers: torch.Tensor      # (K,) bool
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor           # () bool


def _diag3(d: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) diag(1, 1, d)."""
    one = torch.ones_like(d)
    return torch.diag_embed(torch.stack([one, one, d], dim=-1))


def _nearest_rotation(M: torch.Tensor) -> torch.Tensor:
    U, _, Vt = svd3(M)
    return U @ _diag3(torch.sign(torch.linalg.det(U @ Vt))) @ Vt


def _dlt_pose(p3d: torch.Tensor, xy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT for (H, M) samples: projection matrix from the null
    vector of A^T A, its sign fixed by cheirality, then the nearest rigid
    (R, t). p3d (H, M, 3), xy (H, M, 2) normalized, w (H, M) -> (H, 4, 4)."""
    X = torch.cat([p3d, torch.ones_like(p3d[..., :1])], dim=-1)      # (H, M, 4)
    zero = torch.zeros_like(X)
    x, y = xy[..., 0:1], xy[..., 1:2]
    rows_u = torch.cat([X, zero, -x * X], dim=-1)                     # (H, M, 12)
    rows_v = torch.cat([zero, X, -y * X], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    P = smallest_eigvec_spd(A.transpose(-1, -2) @ A).reshape(-1, 3, 4)
    # The null vector's sign is arbitrary: fix it by cheirality BEFORE the
    # factorization (with P = -sR the nearest-rotation problem is degenerate).
    depth = torch.einsum("hmi,hi->hm", p3d, P[:, 2, :3]) + P[:, 2, 3:]
    s_z = torch.where(w > 0, torch.sign(depth), 0.0).sum(-1)
    P = P * torch.where(s_z < 0, -1.0, 1.0)[:, None, None]
    M, m = P[:, :, :3], P[:, :, 3]
    U, S, Vt = svd3(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    R = U @ _diag3(d) @ Vt
    scale = S.mean(-1) * d
    t = m / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[:, None]
    z = (p3d @ R.transpose(-1, -2) + t[:, None, :])[..., 2]
    flip = torch.where(w > 0, torch.sign(z), 0.0).sum(-1) < 0
    R = torch.where(flip[:, None, None], -R, R)   # (-R, -t) solves the DLT too
    t = torch.where(flip[:, None], -t, t)
    return se3.from_rotation_translation(_nearest_rotation(R), t)


def _planar_poses(p3d: torch.Tensor, xy: torch.Tensor):
    """Two candidate poses per (near-)coplanar minimal sample from the
    plane -> image homography H ~ [R e1, R e2, R c + t] (DLT on the
    projection matrix is degenerate for coplanar points). p3d (H, M, 3),
    xy (H, M, 2) -> (T_plus, T_minus), each (H, 4, 4): both scale signs."""
    c = p3d.mean(dim=-2)                                              # (H, 3)
    Q = p3d - c[:, None, :]
    _, V = sym3_eigh(Q.transpose(-1, -2) @ Q)
    e1, e2 = V[..., :, 2], V[..., :, 1]          # in-plane basis
    u = torch.einsum("hmi,hi->hm", Q, e1)
    v = torch.einsum("hmi,hi->hm", Q, e2)
    x, y = xy[..., 0], xy[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rows_x = torch.stack([u, v, one, zero, zero, zero, -x * u, -x * v, -x], -1)
    rows_y = torch.stack([zero, zero, zero, u, v, one, -y * u, -y * v, -y], -1)
    A = torch.cat([rows_x, rows_y], dim=-2)
    Hm = smallest_eigvec_spd(A.transpose(-1, -2) @ A).reshape(-1, 3, 3)
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)

    def pose_from(lam):
        r1 = lam[:, None] * Hm[:, :, 0]
        r2 = lam[:, None] * Hm[:, :, 1]
        t_pl = lam[:, None] * Hm[:, :, 2]
        Rp = _nearest_rotation(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1))
        R = Rp @ B.transpose(-1, -2)
        t = t_pl - so3.apply(R, c)
        return se3.from_rotation_translation(R, t)

    lam = 2.0 / (torch.linalg.vector_norm(Hm[:, :, 0], dim=-1)
                 + torch.linalg.vector_norm(Hm[:, :, 1], dim=-1) + 1e-12)
    return pose_from(lam), pose_from(-lam)


def _camera_points(T: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) poses applied to (K, 3) points -> (..., K, 3)."""
    return p3d @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _reproj_sq(T, p3d, xy, scale):
    """Squared reprojection error per axis-scaled (pass (fx, fy) to measure
    in pixels); +inf behind the camera. T (..., 4, 4) -> (..., K)."""
    pc = _camera_points(T, p3d)
    z = pc[..., 2]
    proj = pc[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)[..., None]
    d = (((proj - xy) * scale) ** 2).sum(-1)
    return torch.where(z > 1e-6, d, torch.inf)


def _gn_polish_pose(T0, p3d, xy, valid, t2: float, scale, iters: int = 8):
    """Robust Gauss-Newton on SE(3) for a batch of poses T0 (P, 4, 4),
    minimizing the truncated reprojection error; returns the best pose seen
    and its score, (P, 4, 4) and (P,)."""
    vw = valid.float()
    hat_p = -so3.hat(p3d)                                              # (K, 3, 3)

    def score(T):
        d = _reproj_sq(T, p3d, xy, scale)
        return torch.where(valid, torch.clamp(d, max=t2), 0.0).sum(-1)

    T, best_T, best_s = T0, T0, score(T0)
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        R = T[:, :3, :3]
        pc = _camera_points(T, p3d)                                    # (P, K, 3)
        zg = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        guarded = torch.abs(pc[..., 2]) < 1e-9
        r = ((pc[..., :2] / zg[..., None] - xy) * scale).reshape(T.shape[0], -1)
        # d pc / d xi = [R | -R hat(p)]; d proj / d pc = [I/z | -xy_c/z^2]
        # (no z term where the 1e-9 guard holds the depth constant).
        dpc = torch.cat([R[:, None].expand(-1, p3d.shape[0], -1, -1),
                         R[:, None] @ hat_p[None]], dim=-1)            # (P, K, 3, 6)
        inv_z = 1.0 / zg
        dz = torch.where(guarded, 0.0, -inv_z * inv_z)
        Jx = inv_z[..., None] * dpc[..., 0, :] + (pc[..., 0] * dz)[..., None] * dpc[..., 2, :]
        Jy = inv_z[..., None] * dpc[..., 1, :] + (pc[..., 1] * dz)[..., None] * dpc[..., 2, :]
        J = torch.stack([Jx * scale[0], Jy * scale[1]], dim=-2).reshape(T.shape[0], -1, 6)
        d = _reproj_sq(T, p3d, xy, scale)
        wr = (vw * torch.where(d < t2, 1.0 / (1.0 + d / t2), 0.0)).repeat_interleave(2, dim=-1)
        A = torch.einsum("pki,pk,pkj->pij", J, wr, J)
        g = torch.einsum("pki,pk->pi", J, wr * r)
        xi = -cholesky_solve_unrolled(A + 1e-8 * eye6, g)
        T = se3.normalize(se3.compose(T, se3.exp(xi)))
        s = score(T)
        better = s <= best_s
        best_T = torch.where(better[:, None, None], T, best_T)
        best_s = torch.where(better, s, best_s)
    return best_T, best_s


def sample_hypotheses(
    valid: torch.Tensor, num_hypotheses: int = 128, generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(num_hypotheses, 6) minimal samples of distinct valid indices: the top
    six of Gumbel keys per hypothesis (invalid entries keyed -inf, so they are
    drawn only when fewer than six are valid). The keys are drawn on the host
    from `generator` and moved to `valid`'s device."""
    K = valid.shape[0]
    u = torch.rand((num_hypotheses, K), generator=generator) * (1.0 - 1e-9) + 1e-9
    gumbel = (-torch.log(-torch.log(u))).to(valid.device)
    keys = torch.where(valid[None, :], gumbel, -torch.inf)
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :6]


def pnp_ransac(
    p3d: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    sample_idx: torch.Tensor,
    threshold_norm: float = 3.0 / 500.0,
    min_inliers: int = 12,
    axis_scale=(1.0, 1.0),
) -> PnPResult:
    """Robust camera pose from 2D-3D matches: p3d (K, 3) in the reference
    frame, xy (K, 2) normalized observations, valid (K,), sample_idx (H, 6)
    minimal samples. Each sample gives a DLT and two planar hypotheses; MSAC
    scores all 3H; the best four are polished by robust GN and the best
    polished pose is returned (camera <- reference). axis_scale with a
    threshold in pixels measures the error isotropically in pixels."""
    t2 = threshold_norm * threshold_norm
    scale = torch.tensor(axis_scale, dtype=torch.float32, device=p3d.device)
    P, X = p3d[sample_idx], xy[sample_idx]                             # (H, 6, .)
    T_dlt = _dlt_pose(P, X, torch.ones(P.shape[:2], device=p3d.device))
    T_hp, T_hm = _planar_poses(P, X)
    Ts = torch.stack([T_dlt, T_hp, T_hm], dim=1).reshape(-1, 4, 4)     # (3H, 4, 4)

    def msac(T):
        d = _reproj_sq(T, p3d, xy, scale)
        return valid & (d < t2), torch.where(valid, torch.clamp(d, max=t2), 0.0).sum(-1)

    _, scores = msac(Ts)
    k = min(4, sample_idx.shape[0])
    top = torch.sort(scores, stable=True).indices[:k]   # lax.top_k(-scores): ties low
    T_pol, score_pol = _gn_polish_pose(Ts[top], p3d, xy, valid, t2, scale)
    T_best = T_pol[torch.argmin(score_pol)]
    inliers, _ = msac(T_best)
    n = inliers.sum()
    return PnPResult(T=T_best, inliers=inliers, num_inliers=n, ok=n >= min_inliers)


def pnp_from_pixels(
    cam,
    p3d: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    sample_idx: torch.Tensor,
    threshold_px: float = 3.0,
    min_inliers: int = 12,
) -> PnPResult:
    """PnP from pixel observations: normalized with the intrinsics, the
    threshold in pixels per axis."""
    f = torch.tensor([cam.fx, cam.fy], dtype=torch.float32, device=uv.device)
    c = torch.tensor([cam.cx, cam.cy], dtype=torch.float32, device=uv.device)
    return pnp_ransac(
        p3d, (uv - c) / f, valid, sample_idx,
        threshold_norm=threshold_px, min_inliers=min_inliers,
        axis_scale=(float(cam.fx), float(cam.fy)),
    )
