"""Photometric pose tracking, batched over frame pairs.

Counterpart of `uwslam_tpu.tracking.photometric`: forward-compositional
(`residuals_and_jacobian`, `lm_level`) and inverse-compositional
(`lm_level_ic`) Levenberg-Marquardt, affine brightness (`_affine_residual`,
`_affine_columns`), and the coarse-to-fine `track` with its basin guard.
The JAX package's `_warp_sample` is kernel K2, `ops.cuda_track.warp_and_sample`
(C = 3 in FC: intensity and both target gradients; C = 1 in IC and the
basin guard); its reference-side `bilinear_sample_auto` is kernel K3,
`ops.cuda_sample.cuda_bilinear_sample`. The JAX package vmaps one pair's
program over the pairs; here every tensor carries the pair dimension B
first, and the live path is B = 1 of the same code.

The JAX LM loop is a `lax.while_loop`, which under vmap runs until every
lane is done while finished lanes keep their state. Here it is a fixed loop
of `max_iters` steps in which every state field changes only for pairs that
are still active. Nothing in this module reads a value back to the host, so
a whole chunk (or a live frame) is one stream of launches.

Convention: T maps reference-camera coordinates to target-camera
coordinates (T_t<-r). Twists are [v, w].
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..image.pyramid import FramePyramid
from ..lie import se3, so3
from ..ops.cuda_sample import cuda_bilinear_sample
from ..ops.cuda_track import warp_and_sample
from ..utils.linalg import cholesky_solve_unrolled
from ..utils.precision import disable_tf32
from .points import TrackPoints
from .robust import WeightKind, mad_sigma, robust_cost, weights

disable_tf32()

MODES = ("fc", "ic")


class TrackResult(NamedTuple):
    T: torch.Tensor            # (B, 4, 4) refined pose (target <- reference)
    error: torch.Tensor        # (B,) final mean robust error
    iterations: torch.Tensor   # (B,) LM iterations over all levels
    inliers: torch.Tensor      # (B,) valid residual count at the finest level
    converged: torch.Tensor    # (B,) bool
    affine: torch.Tensor | None = None  # (B, 2) brightness (a, b); 0 unless affine


class LMState(NamedTuple):
    T: torch.Tensor           # (B, 4, 4) best accepted pose
    r_best: torch.Tensor      # (B, N) residuals at T
    J: torch.Tensor           # (B, N, 6|8) FC: Jacobian at T; IC: the constant one
    valid_best: torch.Tensor  # (B, N) validity at T
    error: torch.Tensor       # (B,) robust error at T
    lam: torch.Tensor         # (B,) LM damping
    k: torch.Tensor           # (B,) iterations run
    done: torch.Tensor        # (B,) bool
    n_inlier: torch.Tensor    # (B,) valid count at T
    ab: torch.Tensor | None = None  # (B, 2) affine brightness at T


_cholesky_solve6 = cholesky_solve_unrolled   # the JAX module's name for it


def _solve_damped(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor):
    """Solve (H + lam diag(H) + 1e-8 I) delta = b (LM, Marquardt scaling)."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
    return _cholesky_solve6(Hd + 1e-8 * eye, b)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with a (B,) mask broadcast over the trailing dims."""
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def _affine_residual(r, ref_intensity, ab, valid):
    """Brightness-compensated residual r - a I_ref - b (0 where invalid): the
    model I_tgt(w(x)) = (1 + a) I_ref(x) + b; r is I_tgt - I_ref, ab (B, 2)."""
    return torch.where(valid, r - ab[:, :1] * ref_intensity - ab[:, 1:], 0.0)


def _affine_columns(ref_intensity, valid):
    """d(residual)/d(a, b) = (-I_ref, -1): (B, N, 2), 0 where invalid."""
    ja = torch.where(valid, -ref_intensity, 0.0)
    jb = torch.where(valid, -1.0, 0.0)
    return torch.stack([ja, jb], dim=-1)


def _stack_target(image, grad_x, grad_y) -> torch.Tensor:
    return torch.stack([image, grad_x, grad_y], dim=1).contiguous()


def _residuals_stacked(T, pts, ref_intensity, stacked, cam):
    """`residuals_and_jacobian` on a target already stacked as (B, 3, H, W)."""
    vals, ok = warp_and_sample(stacked, pts.p3d, T, cam)     # K2, C = 3
    i_t, gx, gy = vals[:, 0], vals[:, 1], vals[:, 2]
    r = i_t - ref_intensity
    valid = pts.valid & ok
    R = T[:, :3, :3]
    p_t = torch.einsum("bij,bnj->bni", R, pts.p3d) + T[:, None, :3, 3]
    # dI/d(uv) . d(uv)/dp_t, then dp_t/d(delta) = [R | -R hat(p)] for the
    # right update T exp(delta).
    Jp = cam.project_jacobian(p_t)                            # (B, N, 2, 3)
    g = gx[..., None] * Jp[..., 0, :] + gy[..., None] * Jp[..., 1, :]
    gR = torch.einsum("bnj,bjk->bnk", g, R)
    Jw = torch.einsum("bnj,bnjk->bnk", gR, -so3.hat(pts.p3d))
    J = torch.cat([gR, Jw], dim=-1)
    return torch.where(valid, r, 0.0), torch.where(valid[..., None], J, 0.0), valid


def residuals_and_jacobian(
    T: torch.Tensor,
    pts: TrackPoints,
    ref_intensity: torch.Tensor,
    image: torch.Tensor,
    grad_x: torch.Tensor,
    grad_y: torch.Tensor,
    cam: PinholeCamera,
):
    """One FC pass for B pairs: warp -> project -> sample the target's
    intensity and gradients (kernel K2, C = 3) -> residual and analytic
    Jacobian. T (B, 4, 4); image and gradients (B, H, W). Returns r (B, N),
    J (B, N, 6) in [v, w] order, valid (B, N); r and J are 0 where invalid."""
    return _residuals_stacked(
        T, pts, ref_intensity, _stack_target(image, grad_x, grad_y), cam
    )


def _lm_loop(
    T0: torch.Tensor,
    ab0: torch.Tensor,
    evaluate: Callable,
    max_iters: int,
    eps: float,
    weight_kind: WeightKind,
    init_lambda: float,
    affine: bool,
    J_const: torch.Tensor | None = None,
) -> LMState:
    """Deferred-evaluation LM shared by FC and IC: each iteration evaluates
    the current candidate once (`evaluate(T, ab) -> (r, J, valid)`), accepts
    or rejects the previous step on the rho objective at the level's sigma0,
    and solves the next step from the best state. Huber and none keep
    sigma0; Tukey re-estimates the MAD scale per solve over the current
    validity mask.

    Only state that varies is carried: FC's `evaluate` returns J (zero where
    invalid) and the loop keeps the best state's J; IC's returns None and
    each solve masks the constant `J_const` by the best state's validity.
    The brightness (a, b) is carried only when `affine`; otherwise it stays
    `ab0`."""
    B = T0.shape[0]
    r0, J0, valid0 = evaluate(T0, ab0)
    sigma0 = mad_sigma(r0, valid0)
    carry_J = J0 is not None

    def solve_from(r, J, valid, lam):
        if J is None:
            J = torch.where(valid[..., None], J_const, 0.0)
        sig = mad_sigma(r, valid) if weight_kind == WeightKind.TUKEY else sigma0
        wJ = weights(r, valid, weight_kind, sigma=sig)[..., None] * J
        H = torch.einsum("bni,bnj->bij", J, wJ)
        b = -torch.einsum("bni,bn->bi", wJ, r)
        return _solve_damped(H, b, lam)

    def apply_delta(T, delta):
        # FC: T exp(delta). IC: with r = I_tgt - I_ref and b = -J^T W r the
        # reference-side increment is exp(-delta), and T exp(-delta)^-1 is
        # the same update. Affine brightness (delta[:, 6:]) is additive.
        return se3.normalize(se3.compose(T, se3.exp(delta[:, :6])))

    lam = torch.full((B,), init_lambda, dtype=T0.dtype, device=T0.device)
    delta0 = solve_from(r0, J0, valid0, lam)
    T = apply_delta(T0, delta0)
    ab = ab0 + delta0[:, 6:] if affine else ab0
    T_best, ab_best, r_best, J_best, valid_best = T0, ab0, r0, J0, valid0
    error = robust_cost(r0, valid0, weight_kind, sigma=sigma0)
    k = torch.zeros(B, dtype=torch.int64, device=T0.device)
    done = torch.zeros(B, dtype=torch.bool, device=T0.device)
    n_inlier = valid0.sum(-1)

    for _ in range(max_iters):
        active = ~done & (k < max_iters)
        r, J, valid = evaluate(T, ab)
        err = robust_cost(r, valid, weight_kind, sigma=sigma0)
        accept = (err < error) & torch.isfinite(err)
        T_base = _where(accept, T, T_best)
        r_base = _where(accept, r, r_best)
        J_base = _where(accept, J, J_best) if carry_J else None
        v_base = _where(accept, valid, valid_best)
        err_base = torch.where(accept, err, error)
        lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e3)
        delta = solve_from(r_base, J_base, v_base, lam_next)
        ok = torch.isfinite(delta).all(-1)
        T_next = _where(ok, apply_delta(T_base, delta), T_base)
        small = torch.linalg.vector_norm(delta, dim=-1) < eps
        done_next = (accept & small) | (lam_next > 500.0) | ~ok
        # The inlier count of the best pose, not of a rejected candidate.
        n_next = torch.where(accept, valid.sum(-1), n_inlier)
        # Commit the step only for pairs still iterating.
        T = _where(active, T_next, T)
        T_best = _where(active, T_base, T_best)
        r_best = _where(active, r_base, r_best)
        if carry_J:
            J_best = _where(active, J_base, J_best)
        if affine:
            ab_base = _where(accept, ab, ab_best)
            ab_next = _where(ok, ab_base + delta[:, 6:], ab_base)
            ab = _where(active, ab_next, ab)
            ab_best = _where(active, ab_base, ab_best)
        valid_best = _where(active, v_base, valid_best)
        error = torch.where(active, err_base, error)
        lam = torch.where(active, lam_next, lam)
        k = k + active.long()
        done = torch.where(active, done_next, done)
        n_inlier = torch.where(active, n_next, n_inlier)

    return LMState(
        T=T_best, r_best=r_best, J=J_best if carry_J else J_const,
        valid_best=valid_best, error=error, lam=lam, k=k, done=done,
        n_inlier=n_inlier, ab=ab_best,
    )


def _ab0(T0: torch.Tensor, ab0: torch.Tensor | None) -> torch.Tensor:
    if ab0 is not None:
        return ab0
    return torch.zeros((T0.shape[0], 2), dtype=T0.dtype, device=T0.device)


def lm_level(
    T0: torch.Tensor,
    pts: TrackPoints,
    ref_intensity: torch.Tensor,
    image: torch.Tensor,
    grad_x: torch.Tensor,
    grad_y: torch.Tensor,
    cam: PinholeCamera,
    max_iters: int = 10,
    eps: float = 1e-4,
    weight_kind: WeightKind = WeightKind.HUBER,
    init_lambda: float = 1e-4,
    affine: bool = False,
    ab0: torch.Tensor | None = None,
) -> LMState:
    """Forward-compositional LM at one pyramid level for B pairs.

    T0 (B, 4, 4); pts at this level's pixel scale; ref_intensity (B, N);
    the target level's image and gradients (B, H, W), stacked once per level
    for kernel K2. Each iteration samples all three target channels at the
    warped points and rebuilds the Jacobian there. affine=True estimates
    (a, b) jointly: the state becomes [xi, a, b] with the two constant
    columns (-I_ref, -1). Returns the best accepted state (`T`, `ab`)."""
    stacked = _stack_target(image, grad_x, grad_y)

    def evaluate(T, ab):
        r, J, valid = _residuals_stacked(T, pts, ref_intensity, stacked, cam)
        if affine:
            r = _affine_residual(r, ref_intensity, ab, valid)
            J = torch.cat([J, _affine_columns(ref_intensity, valid)], dim=-1)
        return r, J, valid

    return _lm_loop(T0, _ab0(T0, ab0), evaluate, max_iters, eps, weight_kind,
                    init_lambda, affine)


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
    affine: bool = False,
    ab0: torch.Tensor | None = None,
) -> LMState:
    """Inverse-compositional LM at one pyramid level for B pairs.

    T0 (B, 4, 4); pts at this level's pixel scale; ref_intensity and the
    reference gradients sampled per point, (B, N); image the target level
    (B, H, W). The Jacobian is built once from the reference gradients at
    the identity warp (with the constant affine columns when affine=True);
    each iteration samples only the target intensity (kernel K2, C = 1).
    The returned `J` is that constant Jacobian."""
    valid_pts = pts.valid
    Jp = cam.project_jacobian(pts.p3d)                        # (B, N, 2, 3)
    g = ref_grad_x[..., None] * Jp[..., 0, :] + ref_grad_y[..., None] * Jp[..., 1, :]
    Jw = torch.einsum("bnj,bnjk->bnk", g, -so3.hat(pts.p3d))
    J = torch.where(valid_pts[..., None], torch.cat([g, Jw], dim=-1), 0.0)
    if affine:
        J = torch.cat([J, _affine_columns(ref_intensity, valid_pts)], dim=-1)
    target = image[:, None]                                   # (B, 1, H, W)

    def evaluate(T, ab):
        vals, ok = warp_and_sample(target, pts.p3d, T, cam)
        valid = valid_pts & ok
        r = torch.where(valid, vals[:, 0] - ref_intensity, 0.0)
        if affine:
            r = _affine_residual(r, ref_intensity, ab, valid)
        return r, None, valid

    return _lm_loop(T0, _ab0(T0, ab0), evaluate, max_iters, eps, weight_kind,
                    init_lambda, affine, J_const=J)


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
    affine: bool = False,
) -> TrackResult:
    """Coarse-to-fine tracking of B pairs -> TrackResult with T (B, 4, 4)
    mapping reference to target coordinates.

    `pts` are level-0 selections in the reference frames. mode "fc"
    (forward-compositional: target gradients at the warped points) samples
    the reference intensity at uv * 2^-l with kernel K3 (C = 1); mode "ic"
    (constant reference Jacobian) samples intensity and both gradients in
    one K3 call (C = 3). Level 0 uses the values carried from selection when
    `pts.gx0` is set. `max_iters` is one budget for all levels or one per
    level, coarse first. affine=True threads the brightness (a, b) coarse to
    fine like the pose and reports it in `TrackResult.affine`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    B = pts.uv.shape[0]
    dev = pts.uv.device
    T = se3.identity((B,), device=dev) if T_init is None else T_init.contiguous()
    T_start = T
    ab = torch.zeros((B, 2), dtype=torch.float32, device=dev)
    total_iters = torch.zeros(B, dtype=torch.int64, device=dev)
    schedule = (
        max_iters if isinstance(max_iters, tuple) else (max_iters,) * len(levels)
    )
    for lvl, lvl_iters in zip(levels, schedule):
        cam_l = cam.scaled(lvl)
        uv_l = pts.uv * (1.0 / (1 << lvl))
        ref_gx = ref_gy = None
        if lvl == 0 and pts.gx0 is not None:
            ref_int, ref_ok = pts.intensity, pts.valid
            ref_gx, ref_gy = pts.gx0, pts.gy0
        elif mode == "ic":
            stack = torch.stack(
                [ref.images[lvl], ref.grad_x[lvl], ref.grad_y[lvl]], dim=1
            )
            vals, ref_ok = cuda_bilinear_sample(stack, uv_l)
            ref_int, ref_gx, ref_gy = vals[:, 0], vals[:, 1], vals[:, 2]
        else:
            vals, ref_ok = cuda_bilinear_sample(ref.images[lvl][:, None], uv_l)
            ref_int = vals[:, 0]
        pts_l = TrackPoints(
            uv=uv_l, p3d=pts.p3d, intensity=ref_int, valid=pts.valid & ref_ok
        )
        if mode == "ic":
            out = lm_level_ic(
                T, pts_l, ref_int, ref_gx, ref_gy, tgt.images[lvl], cam_l,
                max_iters=lvl_iters, weight_kind=weight_kind, affine=affine, ab0=ab,
            )
        else:
            out = lm_level(
                T, pts_l, ref_int, tgt.images[lvl], tgt.grad_x[lvl],
                tgt.grad_y[lvl], cam_l, max_iters=lvl_iters,
                weight_kind=weight_kind, affine=affine, ab0=ab,
            )
        T, ab = out.T, out.ab
        total_iters = total_iters + out.k

    # Basin guard: on (quasi-)periodic texture the coarse levels can settle
    # a whole period off and the finer levels refine that wrong basin. If
    # the refined pose explains the finest level worse than the initial
    # pose did (under the final brightness), keep the initial pose.
    vals_g, ok_g = warp_and_sample(
        tgt.images[levels[-1]][:, None], pts_l.p3d, T_start, cam_l
    )
    valid_g = pts_l.valid & ok_g
    r_g = torch.where(valid_g, vals_g[:, 0] - pts_l.intensity, 0.0)
    if affine:
        r_g = _affine_residual(r_g, pts_l.intensity, ab, valid_g)
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
        affine=ab,
    )
