"""Masked, batched RANSAC for fundamental and essential matrices.

Counterpart of `uwslam_tpu.features.ransac` (uw-slam's geometric
verification, src/Tracker.cpp:105-169: findFundamentalMat RANSAC at 3.0 px;
and the essential-matrix prototype, src/feature_detector.cpp:262-269):

- a fixed batch of hypotheses evaluated at once, no adaptive termination;
- each hypothesis a Hartley-normalized 8-point solve, scored by MSAC on
  Sampson distances; the best eight refit by IRLS; for essential matrices a
  Gauss-Newton polish on the manifold from those and from a grid of starts;
- invalid matches are masked out of the sampling and of the scores.

The minimal samples are the top eight Gumbel keys of each hypothesis over
the valid matches. The JAX package draws the uniforms behind the keys from
`jax.random` inside the solver; here `draw_uniforms` draws the (H, K) table
on the host from a `torch.Generator` and the solvers take it as an
argument, so a caller can seed it per frame, copy it into a captured
graph's input, or feed both packages one table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import so3
from ..utils.linalg import (
    cholesky_solve_unrolled,
    smallest_eigvec_subspace,
    svd3_jacobi,
    sym3_eigh_jacobi,
)
from .geometry import _proper, _w_matrix

RANSAC_THRESH_PX = 3.0   # uw-slam src/Tracker.cpp:150
NUM_HYPOTHESES = 256     # covers ~35% outliers at 0.99 confidence, the rate
                         # left by the ratio test


class RansacResult(NamedTuple):
    F: torch.Tensor            # (3, 3) best model (fundamental or essential)
    inliers: torch.Tensor      # (K,) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor           # bool: enough inliers found


def draw_uniforms(num_matches: int, num_hypotheses: int = NUM_HYPOTHESES,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """(num_hypotheses, num_matches) uniforms in [1e-9, 1) on the host."""
    u = torch.rand((num_hypotheses, num_matches), generator=generator)
    return u * (1.0 - 1e-9) + 1e-9


def sample_minimal(uniforms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(H, 8) distinct valid indices per hypothesis: the top eight Gumbel
    keys -log(-log u), invalid matches keyed -inf (drawn only when fewer than
    eight are valid; ties go to the lower index)."""
    gumbel = -torch.log(-torch.log(uniforms.to(valid.device)))
    keys = torch.where(valid[None, :], gumbel, -torch.inf)
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :8]


def _normalize_points(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization over the valid points: zero mean, mean distance
    sqrt(2) -> (normalized (K, 2), the (3, 3) transform)."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = torch.linalg.norm(uv - mean, dim=-1)
    scale = (2.0 ** 0.5) / torch.clamp((d * w).sum() / n, min=1e-6)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (uv - mean) * scale, T


def _eight_point(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point on normalized coordinates pa, pb (..., M, 2) with
    weights w (..., M) -> (..., 3, 3) of rank 2. Rows are
    w_i [xb xa, xb ya, xb, yb xa, yb ya, yb, xa, ya, 1]; f minimizes |A f|;
    the smallest singular value is dropped as F (I - v3 v3^T) with v3 the
    smallest eigenvector of F^T F. The result's sign is the eigenvector's."""
    xa, ya = pa[..., 0], pa[..., 1]
    xb, yb = pb[..., 0], pb[..., 1]
    A = torch.stack(
        [xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya, torch.ones_like(xa)], dim=-1
    ) * w[..., None]
    f = smallest_eigvec_subspace(torch.matmul(A.transpose(-1, -2), A))
    F = f.reshape(*f.shape[:-1], 3, 3)
    _, Vf = sym3_eigh_jacobi(torch.matmul(F.transpose(-1, -2), F))
    v3 = Vf[..., :, 0]
    Fv = torch.matmul(F, v3[..., None])[..., 0]
    return F - Fv[..., :, None] * v3[..., None, :]


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def sampson_distance(F: torch.Tensor, uv_a: torch.Tensor, uv_b: torch.Tensor):
    """First-order geometric (Sampson) distance of each correspondence:
    F (..., 3, 3), uv (K, 2) -> (..., K)."""
    xa, xb = _homogeneous(uv_a), _homogeneous(uv_b)
    Fxa = torch.matmul(xa, F.transpose(-1, -2))      # rows F xa: epipolar lines in b
    Ftxb = torch.matmul(xb, F)                       # rows F^T xb
    num = (xb * Fxa).sum(-1) ** 2
    den = Fxa[..., 0] ** 2 + Fxa[..., 1] ** 2 + Ftxb[..., 0] ** 2 + Ftxb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _project_essential(F: torch.Tensor) -> torch.Tensor:
    """Onto the essential manifold: singular values -> (s, s, 0)."""
    U, S, Vt = svd3_jacobi(F)
    s = 0.5 * (S[..., 0] + S[..., 1])
    return torch.matmul(U * torch.stack([s, s, torch.zeros_like(s)], dim=-1)[..., None, :], Vt)


def _decompose_rt(E: torch.Tensor):
    """One (R, t) with [t]x R proportional to E (Sampson is invariant to the
    sign, so any of the four decompositions names the same manifold point)."""
    U, _, Vt = svd3_jacobi(E)
    U, Vt = _proper(U), _proper(Vt)
    return U @ _w_matrix(E) @ Vt, U[..., :, 2]


def _gn_polish_essential(R0, t0, xy_a, xy_b, valid, t2: float, iters: int = 8):
    """Gauss-Newton on the essential manifold (5 dof: so(3) x the tangent of
    S^2) on robustly weighted signed Sampson residuals, from the starts
    R0 (P, 3, 3), t0 (P, 3) -> (E (P, 3, 3) of unit norm, MSAC score (P,)).
    The 8-point solve with singular-value projection is not a descent
    method on geometric error and fails on near-planar scenes; GN from
    several starts is the substitute."""
    ha, hb = _homogeneous(xy_a), _homogeneous(xy_b)            # (K, 3)
    vw = valid.to(xy_a.dtype)
    dev, dt = xy_a.device, xy_a.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye5 = torch.eye(5, dtype=dt, device=dev)
    gen = so3.hat(eye3)                                        # (3, 3, 3): hat(e_k)

    def basis_perp(t):
        """Two unit vectors spanning the plane normal to t."""
        a = torch.where((torch.abs(t[:, 0]) < 0.9)[:, None], eye3[0], eye3[1])
        b1 = torch.linalg.cross(t, a, dim=-1)
        b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
        return b1, torch.linalg.cross(t, b1, dim=-1)

    def parts(E):
        Ex = torch.matmul(ha, E.transpose(-1, -2))             # (..., K, 3) rows E xa
        Etx = torch.matmul(hb, E)                              # rows E^T xb
        return Ex, Etx

    def residuals(R, t):
        Ex, Etx = parts(torch.matmul(so3.hat(t), R))
        num = (hb * Ex).sum(-1)
        den = torch.sqrt(Ex[..., 0] ** 2 + Ex[..., 1] ** 2 + Etx[..., 0] ** 2
                         + Etx[..., 1] ** 2 + 1e-18)
        return num / den, (Ex, Etx, num, den)

    def score(R, t):
        d = residuals(R, t)[0] ** 2
        return torch.where(valid, torch.clamp(d, max=t2), 0.0).sum(-1)

    def retract(R, t, delta, b1, b2):
        Rn = torch.matmul(R, so3.exp(delta[:, :3]))
        tn = t + delta[:, 3:4] * b1 + delta[:, 4:5] * b2
        return Rn, tn / torch.clamp(torch.linalg.norm(tn, dim=-1, keepdim=True), min=1e-12)

    R, t = R0, t0
    best_R, best_t, best_s = R0, t0, score(R0, t0)
    for _ in range(iters):
        b1, b2 = basis_perp(t)
        r, (Ex, Etx, num, den) = residuals(R, t)               # (P, K)
        # dE/dtheta at theta = 0: hat(t) R hat(e_k) for the rotation, hat(b_i) R
        # for the translation direction (t is a unit vector and b_i normal to it).
        tR = torch.matmul(so3.hat(t), R)
        dE = torch.cat([
            torch.matmul(tR[:, None], gen[None]),
            torch.matmul(so3.hat(torch.stack([b1, b2], dim=1)), R[:, None]),
        ], dim=1)                                              # (P, 5, 3, 3)
        dEx, dEtx = parts(dE)                                  # (P, 5, K, 3)
        dnum = (hb * dEx).sum(-1)                              # (P, 5, K)
        dden = (
            Ex[:, None, :, 0] * dEx[..., 0] + Ex[:, None, :, 1] * dEx[..., 1]
            + Etx[:, None, :, 0] * dEtx[..., 0] + Etx[:, None, :, 1] * dEtx[..., 1]
        ) / den[:, None]
        J = (dnum / den[:, None] - (num / (den * den))[:, None] * dden).transpose(1, 2)
        d = r * r
        wrob = vw * torch.where(d < t2, 1.0 / (1.0 + d / t2), 0.0)   # (P, K)
        A = torch.matmul(J.transpose(1, 2) * wrob[:, None, :], J)    # (P, 5, 5)
        g = torch.matmul(J.transpose(1, 2), (wrob * r)[..., None])[..., 0]
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        delta = -cholesky_solve_unrolled(A + 1e-8 * eye5 + 1e-10 * tr * eye5, g)
        R, t = retract(R, t, delta, b1, b2)
        s = score(R, t)
        better = s <= best_s
        best_R = torch.where(better[:, None, None], R, best_R)
        best_t = torch.where(better[:, None], t, best_t)
        best_s = torch.where(better, s, best_s)
    E = torch.matmul(so3.hat(best_t), best_R)
    nrm = torch.sqrt((E * E).sum((-2, -1), keepdim=True))
    return E / torch.clamp(nrm, min=1e-12), best_s


def _take_first_min(x: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """x[i] for the smallest score i, the lowest index among ties. (Indexing
    by a 0-dim tensor would read it on the host.)"""
    return x.index_select(0, torch.sort(score, stable=True).indices[:1])[0]


def _ransac_core(uv_a, uv_b, valid, uniforms, threshold: float, min_inliers: int,
                 essential: bool) -> RansacResult:
    """RANSAC F / E matrix with MSAC scoring and iterated inlier refit.

    uv_a, uv_b (K, 2) matched coordinates, valid (K,), uniforms (H, K). With
    `essential`, every hypothesis is projected onto the essential manifold
    BEFORE scoring: projecting only the winner can turn the best F into a
    badly wrong E."""
    pa_n, Ta = _normalize_points(uv_a, valid)
    pb_n, Tb = _normalize_points(uv_b, valid)
    sample_idx = sample_minimal(uniforms, valid)                     # (H, 8)
    ones8 = torch.ones(sample_idx.shape, dtype=uv_a.dtype, device=uv_a.device)
    Fs_n = _eight_point(pa_n[sample_idx], pb_n[sample_idx], ones8)   # (H, 3, 3)

    def denormalize(Fn):
        F = torch.matmul(torch.matmul(Tb.T, Fn), Ta)   # the threshold is in pixels
        return _project_essential(F) if essential else F

    Fs = denormalize(Fs_n)
    t2 = threshold * threshold

    def msac(F):
        """Inliers and the sum of truncated squared Sampson distances: a
        binary inlier count is too coarse to tell a model that barely absorbs
        one more outlier from the true one."""
        d = sampson_distance(F, uv_a, uv_b)
        return valid & (d < t2), torch.where(valid, torch.clamp(d, max=t2), 0.0).sum(-1)

    _, scores_h = msac(Fs)
    # Locally optimized RANSAC: refit the best eight minimal hypotheses by
    # IRLS (Sampson-weighted 8-point), each on its own, and keep the best
    # model any chain visited: one chain from the one best sample can stay
    # in a wrong basin.
    k = min(8, Fs.shape[0])
    F = Fs[torch.sort(scores_h, stable=True).indices[:k]]
    best_F, best_score = F, msac(F)[1]
    for _ in range(3):
        d = sampson_distance(F, uv_a, uv_b)
        w = torch.where(valid & (d < t2), 1.0 / (1.0 + d / t2), 0.0)     # (k, K)
        F = denormalize(_eight_point(pa_n, pb_n, w))
        score = msac(F)[1]
        better = score <= best_score
        best_F = torch.where(better[:, None, None], F, best_F)
        best_score = torch.where(better, score, best_score)
    F_ref, score_ref = best_F, best_score

    if essential:
        # Manifold GN polish. A near-planar scene has two strong local minima
        # (the homography's two-fold ambiguity), possibly far apart on the
        # sphere of t: polish from each refined model and from a fixed grid
        # of translation directions crossed with both decomposition
        # rotations of the best model and the identity.
        Rs, ts = _decompose_rt(F_ref)
        U, _, Vt = svd3_jacobi(_take_first_min(F_ref, score_ref))
        U, Vt = _proper(U), _proper(Vt)
        W = _w_matrix(U)
        eye = torch.eye(3, dtype=U.dtype, device=U.device)
        R_cands = torch.stack([U @ W @ Vt, U @ W.T @ Vt, eye])
        phi = 1.618034
        t_grid = torch.tensor(
            [
                [0.0, 1.0, phi], [0.0, 1.0, -phi],
                [1.0, phi, 0.0], [1.0, -phi, 0.0],
                [phi, 0.0, 1.0], [-phi, 0.0, 1.0],
                [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                [1.0, 1.0, 1.0],
            ],
            dtype=U.dtype, device=U.device,
        )
        t_grid = t_grid / torch.linalg.norm(t_grid, dim=-1, keepdim=True)
        R_all = torch.cat([Rs, R_cands.repeat_interleave(t_grid.shape[0], dim=0)])
        t_all = torch.cat([ts, t_grid.repeat(R_cands.shape[0], 1)])
        F_pol, score_pol = _gn_polish_essential(R_all, t_all, uv_a, uv_b, valid, t2)
        F_ref = torch.cat([F_ref, F_pol])
        score_ref = torch.cat([score_ref, score_pol])

    F_final = _take_first_min(F_ref, score_ref)
    inliers, _ = msac(F_final)
    n = inliers.sum()
    return RansacResult(
        F=F_final / torch.clamp(torch.abs(F_final[2, 2]), min=1e-12),
        inliers=inliers, num_inliers=n, ok=n >= min_inliers,
    )


def fundamental_ransac(uv_a, uv_b, valid, uniforms, threshold: float = RANSAC_THRESH_PX,
                       min_inliers: int = 15) -> RansacResult:
    """RANSAC fundamental matrix on pixel coordinates (uw-slam's
    findFundamentalMat verification, src/Tracker.cpp:105-169); `uniforms`
    (H, K) from `draw_uniforms` fix the H minimal samples."""
    return _ransac_core(uv_a, uv_b, valid, uniforms, threshold, min_inliers, essential=False)


def essential_ransac(xy_a, xy_b, valid, uniforms, threshold_norm: float = 3.0 / 500.0,
                     min_inliers: int = 15) -> RansacResult:
    """Essential matrix RANSAC on normalized camera coordinates
    (x, y) = K^-1 u: 8-point solves, each projected onto the essential
    manifold (in the role of uw-slam's five-point cv::findEssentialMat,
    src/feature_detector.cpp:262-265)."""
    return _ransac_core(xy_a, xy_b, valid, uniforms, threshold_norm, min_inliers,
                        essential=True)
