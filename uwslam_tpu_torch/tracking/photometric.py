"""Inverse-compositional photometric pose tracking, batched over frame pairs.

Counterpart of `uwslam_tpu.tracking.photometric` in IC mode
(`_cholesky_solve6`, `_solve_damped`, `lm_level_ic`, `track` with its basin
guard); its `_warp_sample` is kernel K2, `ops.cuda_track.warp_and_sample`.
The JAX package vmaps one pair's program over the pairs; here every tensor
carries the pair dimension B first.

The JAX LM loop is a `lax.while_loop`, which under vmap runs until every
lane is done while finished lanes keep their state. Here it is a fixed loop
of `max_iters` steps in which every state field changes only for pairs that
are still active. Nothing in this module reads a value back to the host, so
a whole chunk is one stream of launches.

Convention: T maps reference-camera coordinates to target-camera
coordinates (T_t<-r). Twists are [v, w].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..image.pyramid import FramePyramid
from ..lie import se3, so3
from ..ops.cuda_sample import cuda_bilinear_sample
from ..ops.cuda_track import warp_and_sample
from ..utils.precision import disable_tf32
from .points import TrackPoints
from .robust import WeightKind, mad_sigma, robust_cost, weights

disable_tf32()


class TrackResult(NamedTuple):
    T: torch.Tensor            # (B, 4, 4) refined pose (target <- reference)
    error: torch.Tensor        # (B,) final mean robust error
    iterations: torch.Tensor   # (B,) LM iterations over all levels
    inliers: torch.Tensor      # (B,) valid residual count at the finest level
    converged: torch.Tensor    # (B,) bool


class LMState(NamedTuple):
    T: torch.Tensor           # (B, 4, 4) best accepted pose
    r_best: torch.Tensor      # (B, N) residuals at T
    J: torch.Tensor           # (B, N, 6) constant IC Jacobian
    valid_best: torch.Tensor  # (B, N) validity at T
    error: torch.Tensor       # (B,) robust error at T
    lam: torch.Tensor         # (B,) LM damping
    k: torch.Tensor           # (B,) iterations run
    done: torch.Tensor        # (B,) bool
    n_inlier: torch.Tensor    # (B,) valid count at T


def _cholesky_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems A x = b, A (B, n, n), b (B, n), by an unrolled
    Cholesky whose pivots are clamped at 1e-20 (the JAX package's exact
    operation order; torch.linalg.cholesky would raise where the clamp acts)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n                      # forward solve L y = b
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n                      # back solve L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _solve_damped(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor):
    """Solve (H + lam diag(H) + 1e-8 I) delta = b (LM, Marquardt scaling)."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
    return _cholesky_solve6(Hd + 1e-8 * eye, b)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with a (B,) mask broadcast over the trailing dims."""
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def lm_level_ic(
    T0: torch.Tensor,
    pts: TrackPoints,
    ref_intensity: torch.Tensor,
    ref_grad_x: torch.Tensor,
    ref_grad_y: torch.Tensor,
    image: torch.Tensor,
    cam: PinholeCamera,
    max_iters: int = 10,
    eps: float = 1e-4,
    weight_kind: WeightKind = WeightKind.HUBER,
    init_lambda: float = 1e-4,
) -> LMState:
    """Inverse-compositional LM at one pyramid level for B pairs.

    T0 (B, 4, 4); pts at this level's pixel scale; ref_intensity and the
    reference gradients sampled per point, (B, N); image the target level
    (B, H, W). The Jacobian is built once from the reference gradients at
    the identity warp; each iteration samples only the target intensity
    (kernel K2) and solves a damped 6x6 system per pair."""
    B = T0.shape[0]
    valid_pts = pts.valid
    Jp = cam.project_jacobian(pts.p3d)                        # (B, N, 2, 3)
    g = ref_grad_x[..., None] * Jp[..., 0, :] + ref_grad_y[..., None] * Jp[..., 1, :]
    Jw = torch.einsum("bnj,bnjk->bnk", g, -so3.hat(pts.p3d))
    J = torch.where(valid_pts[..., None], torch.cat([g, Jw], dim=-1), 0.0)
    target = image[:, None]                                   # (B, 1, H, W)

    def sample_target(T):
        vals, ok = warp_and_sample(target, pts.p3d, T, cam)
        valid = valid_pts & ok
        return torch.where(valid, vals[:, 0] - ref_intensity, 0.0), valid

    r0, valid0 = sample_target(T0)
    sigma0 = mad_sigma(r0, valid0)

    def eval_err(r, valid):
        return robust_cost(r, valid, weight_kind, sigma=sigma0)

    def solve_from(r, valid, lam):
        sig = mad_sigma(r, valid) if weight_kind == WeightKind.TUKEY else sigma0
        w = weights(r, valid, weight_kind, sigma=sig)
        Jm = torch.where(valid[..., None], J, 0.0)
        wJ = w[..., None] * Jm
        H = torch.einsum("bni,bnj->bij", Jm, wJ)
        b = -torch.einsum("bni,bn->bi", wJ, r)
        return _solve_damped(H, b, lam)

    def apply_delta(T, delta):
        # With r = I_tgt - I_ref and b = -J^T W r, the reference-side
        # increment is exp(-delta), and T o exp(-delta)^-1 = T o exp(delta).
        return se3.normalize(se3.compose(T, se3.exp(delta)))

    lam = torch.full((B,), init_lambda, dtype=T0.dtype, device=T0.device)
    T = apply_delta(T0, solve_from(r0, valid0, lam))
    T_best, r_best, valid_best, error = T0, r0, valid0, eval_err(r0, valid0)
    k = torch.zeros(B, dtype=torch.int64, device=T0.device)
    done = torch.zeros(B, dtype=torch.bool, device=T0.device)
    n_inlier = valid0.sum(-1)

    for _ in range(max_iters):
        active = ~done & (k < max_iters)
        r, valid = sample_target(T)
        err = eval_err(r, valid)
        accept = (err < error) & torch.isfinite(err)
        T_base = _where(accept, T, T_best)
        r_base = _where(accept, r, r_best)
        v_base = _where(accept, valid, valid_best)
        err_base = torch.where(accept, err, error)
        lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e3)
        delta = solve_from(r_base, v_base, lam_next)
        ok = torch.isfinite(delta).all(-1)
        T_next = _where(ok, apply_delta(T_base, delta), T_base)
        small = torch.linalg.vector_norm(delta, dim=-1) < eps
        done_next = (accept & small) | (lam_next > 500.0) | ~ok
        n_next = torch.where(accept, valid.sum(-1), n_inlier)
        # Commit the step only for pairs still iterating.
        T = _where(active, T_next, T)
        T_best = _where(active, T_base, T_best)
        r_best = _where(active, r_base, r_best)
        valid_best = _where(active, v_base, valid_best)
        error = torch.where(active, err_base, error)
        lam = torch.where(active, lam_next, lam)
        k = k + active.long()
        done = torch.where(active, done_next, done)
        n_inlier = torch.where(active, n_next, n_inlier)

    return LMState(
        T=T_best, r_best=r_best, J=J, valid_best=valid_best, error=error,
        lam=lam, k=k, done=done, n_inlier=n_inlier,
    )


def track(
    ref: FramePyramid,
    tgt: FramePyramid,
    pts: TrackPoints,
    cam: PinholeCamera,
    T_init: torch.Tensor | None = None,
    levels: tuple[int, ...] = (3, 2, 1, 0),
    max_iters: int | tuple[int, ...] = 10,
    weight_kind: WeightKind = WeightKind.HUBER,
    mode: str = "ic",
) -> TrackResult:
    """Coarse-to-fine IC tracking of B pairs -> TrackResult with T (B, 4, 4)
    mapping reference to target coordinates.

    `pts` are level-0 selections in the reference frames; above level 0 the
    reference intensity and both gradients are sampled at uv * 2^-l in one
    kernel K3 call; level 0 uses the values carried from selection.
    `max_iters` is one budget for all levels or one per level, coarse first."""
    if mode != "ic":
        raise NotImplementedError(
            "only inverse-compositional tracking (mode='ic') is ported"
        )
    B = pts.uv.shape[0]
    T = (
        se3.identity((B,), device=pts.uv.device) if T_init is None
        else T_init.contiguous()
    )
    T_start = T
    total_iters = torch.zeros(B, dtype=torch.int64, device=pts.uv.device)
    schedule = (
        max_iters if isinstance(max_iters, tuple) else (max_iters,) * len(levels)
    )
    for lvl, lvl_iters in zip(levels, schedule):
        cam_l = cam.scaled(lvl)
        uv_l = pts.uv * (1.0 / (1 << lvl))
        if lvl == 0 and pts.gx0 is not None:
            ref_int, ref_ok = pts.intensity, pts.valid
            ref_gx, ref_gy = pts.gx0, pts.gy0
        else:
            stack = torch.stack(
                [ref.images[lvl], ref.grad_x[lvl], ref.grad_y[lvl]], dim=1
            )
            vals, ref_ok = cuda_bilinear_sample(stack, uv_l)
            ref_int, ref_gx, ref_gy = vals[:, 0], vals[:, 1], vals[:, 2]
        pts_l = TrackPoints(
            uv=uv_l, p3d=pts.p3d, intensity=ref_int, valid=pts.valid & ref_ok
        )
        out = lm_level_ic(
            T, pts_l, ref_int, ref_gx, ref_gy, tgt.images[lvl], cam_l,
            max_iters=lvl_iters, weight_kind=weight_kind,
        )
        T = out.T
        total_iters = total_iters + out.k

    # Basin guard: on (quasi-)periodic texture the coarse levels can settle
    # a whole period off and the finer levels refine that wrong basin. If
    # the refined pose explains the finest level worse than the initial
    # pose did, keep the initial pose.
    vals_g, ok_g = warp_and_sample(
        tgt.images[levels[-1]][:, None], pts_l.p3d, T_start, cam_l
    )
    valid_g = pts_l.valid & ok_g
    r_g = torch.where(valid_g, vals_g[:, 0] - pts_l.intensity, 0.0)
    e_init = torch.abs(r_g).sum(-1) / torch.clamp(valid_g.sum(-1), min=1)
    e_final = torch.abs(out.r_best).sum(-1) / torch.clamp(
        out.valid_best.sum(-1), min=1
    )
    jumped = e_final > e_init * 1.05
    return TrackResult(
        T=_where(jumped, T_start, T),
        error=torch.where(jumped, e_init, out.error),
        iterations=total_iters,
        inliers=torch.where(jumped, valid_g.sum(-1), out.n_inlier),
        converged=(out.done | (out.error < 1e3)) & ~jumped,
    )
