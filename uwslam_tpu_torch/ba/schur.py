"""Sliding-window bundle adjustment: Schur complement and LM, in PyTorch.

Counterpart of `uwslam_tpu.ba.schur`. A fixed-capacity observation table
(observation -> keyframe, landmark, pixel, valid; invalid slots weigh
nothing), every per-observation Jacobian in one batched pass, landmark 3x3
blocks inverted in closed form, the reduced camera system S = U - W V^-1 W^T
built by one einsum and solved densely (6M x 6M) under Levenberg-Marquardt
with gauge fixing on the first keyframes.

Pose convention: T_cw (camera from world), left update exp(delta) T_cw,
twist [v, w].

Two things differ from the JAX package, by construction:

- Its segment sums become products with one-hot matrices (observations x
  keyframes, observations x landmarks), built once per problem in
  `Incidence`. A scatter-add on a CUDA device adds with float atomics in an
  order that changes from run to run; a matrix product does not, so two
  solves of one problem give the same bits.
- Its two `while_loop`s become loops of a fixed length with a `done` mask:
  a finished state takes no further update and `iterations` counts only
  the live passes, so the host never reads the device inside a solve (the
  live loop dispatches a window solve and goes on). The work done is that
  of `lm_passes(max_iters)` passes whatever `iterations` says.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..lie import se3, so3


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem: M keyframes, L landmarks, O observations."""

    T_cw: torch.Tensor       # (M, 4, 4) camera-from-world poses
    points: torch.Tensor     # (L, 3) world landmarks
    obs_kf: torch.Tensor     # (O,) int keyframe index
    obs_lm: torch.Tensor     # (O,) int landmark index
    obs_uv: torch.Tensor     # (O, 2) measured pixels
    obs_valid: torch.Tensor  # (O,) bool


class BAResult(NamedTuple):
    T_cw: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor          # final mean robust cost
    initial_cost: torch.Tensor
    iterations: torch.Tensor    # LM passes that were live (int64 scalar)


class Incidence(NamedTuple):
    """One-hot observation tables of a problem (constant over a solve)."""

    kf: torch.Tensor   # (O, M) f32
    lm: torch.Tensor   # (O, L) f32


def incidence(problem: BAProblem) -> Incidence:
    M, L = problem.T_cw.shape[0], problem.points.shape[0]
    dev = problem.obs_kf.device
    kf = problem.obs_kf.long()[:, None] == torch.arange(M, device=dev)[None, :]
    lm = problem.obs_lm.long()[:, None] == torch.arange(L, device=dev)[None, :]
    return Incidence(kf=kf.float(), lm=lm.float())


def lm_passes(max_iters: int, trim: bool = True) -> int:
    """LM passes a solve executes: `max_iters` of the first loop and, with
    the trim, the most the second can run (it starts at the first loop's
    count, at least 1, and stops at 2 * max_iters)."""
    return max_iters + (max(2 * max_iters - 1, 0) if trim else 0)


def _camera_points(problem: BAProblem):
    T = problem.T_cw[problem.obs_kf.long()]            # (O, 4, 4)
    X = problem.points[problem.obs_lm.long()]          # (O, 3)
    return T, se3.apply(T, X)


def reproject_residuals(problem: BAProblem, cam: PinholeCamera):
    """Residuals (O, 2) and validity (O,) at the problem's state."""
    _, p_c = _camera_points(problem)
    r = cam.project(p_c) - problem.obs_uv
    valid = problem.obs_valid & (p_c[..., 2] > 1e-3)
    return torch.where(valid[:, None], r, 0.0), valid


def _obs_jacobians(problem: BAProblem, cam: PinholeCamera):
    """Per observation: A (2, 6) pose and B (2, 3) point Jacobians, the
    residual and its validity."""
    T, p_c = _camera_points(problem)
    r = cam.project(p_c) - problem.obs_uv
    valid = problem.obs_valid & (p_c[..., 2] > 1e-3)
    Jp = cam.project_jacobian(p_c)                     # (O, 2, 3)
    # Left update exp(delta) T: dp_c/ddelta = [I | -hat(p_c)].
    A = torch.cat([Jp, torch.matmul(Jp, -so3.hat(p_c))], dim=-1)   # (O, 2, 6)
    B = torch.matmul(Jp, se3.rotation(T))              # (O, 2, 3)
    m = valid[:, None, None]
    return (torch.where(m, A, 0.0), torch.where(m, B, 0.0),
            torch.where(valid[:, None], r, 0.0), valid)


def _huber_weights(r: torch.Tensor, valid: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-observation Huber IRLS weight on the residual norm."""
    nrm = torch.linalg.norm(r, dim=-1)
    w = torch.clamp(delta / torch.clamp(nrm, min=1e-9), max=1.0)
    return torch.where(valid, w, 0.0)


def _robust_cost(r: torch.Tensor, valid: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean Huber cost (for LM accept / reject)."""
    nrm = torch.linalg.norm(r, dim=-1)
    c = torch.where(nrm <= delta, 0.5 * nrm * nrm, delta * (nrm - 0.5 * delta))
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, c, 0.0).sum() / n


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def build_normal_equations(
    problem: BAProblem, cam: PinholeCamera, huber_delta: float = 2.0,
    inc: Incidence | None = None,
):
    """One batched pass -> (U (M, 6, 6), V (L, 3, 3), W (L, M, 6, 3),
    g_p (M, 6), g_l (L, 3), cost)."""
    M, L = problem.T_cw.shape[0], problem.points.shape[0]
    inc = incidence(problem) if inc is None else inc
    A, B, r, valid = _obs_jacobians(problem, cam)
    O = A.shape[0]
    w = _huber_weights(r, valid, huber_delta)
    wA = w[:, None, None] * A
    wB = w[:, None, None] * B
    At, Bt = wA.transpose(-1, -2), wB.transpose(-1, -2)
    AtA = torch.matmul(At, A)                          # (O, 6, 6)
    BtB = torch.matmul(Bt, B)                          # (O, 3, 3)
    AtB = torch.matmul(At, B)                          # (O, 6, 3)
    Atr = torch.matmul(At, r[..., None])[..., 0]       # (O, 6)
    Btr = torch.matmul(Bt, r[..., None])[..., 0]       # (O, 3)

    per_kf = inc.kf.T @ torch.cat([AtA.reshape(O, 36), Atr], dim=-1)       # (M, 42)
    U, g_p = per_kf[:, :36].reshape(M, 6, 6), -per_kf[:, 36:]
    # W[l, m] sums the observations of landmark l in keyframe m: each
    # observation's block goes to its keyframe's columns, the landmark's
    # one-hot row does the sum.
    spread = (inc.kf[:, :, None] * AtB.reshape(O, 1, 18)).reshape(O, M * 18)
    per_lm = inc.lm.T @ torch.cat([BtB.reshape(O, 9), Btr, spread], dim=-1)
    V, g_l = per_lm[:, :9].reshape(L, 3, 3), -per_lm[:, 9:12]
    W = per_lm[:, 12:].reshape(L, M, 6, 3)
    return U, V, W, g_p, g_l, _robust_cost(r, valid, huber_delta)


def _mean_diag(X: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.diagonal(X, dim1=-2, dim2=-1).mean(-1), min=1e-6)[..., None, None]


def solve_schur(U, V, W, g_p, g_l, lam, fix_first_pose: bool = True,
                num_fixed_poses: int = 1):
    """Schur-complement solve -> (delta_poses (M, 6), delta_points (L, 3)).

    S = U + lam I - W V_damped^-1 W^T; S dp = g_p - W V^-1 g_l;
    dl = V^-1 (g_l - W^T dp). `num_fixed_poses` gauge anchors: 1 fixes the
    6-dof frame, monocular windows use 2 so that the scale is anchored too."""
    M = U.shape[0]
    dev, dt = U.device, U.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Vinv = _inv3x3(V + lam * eye3 * _mean_diag(V))
    WVinv = torch.matmul(W, Vinv[:, None])                               # (L, M, 6, 3)
    S_red = torch.einsum("lmac,lnbc->manb", WVinv, W)                    # (M, 6, M, 6)
    U_d = U + lam * eye6 * _mean_diag(U)
    block = torch.eye(M, dtype=dt, device=dev)[:, None, :, None]         # (M, 1, M, 1)
    S = block * U_d[:, :, None, :] - S_red
    rhs = g_p - torch.einsum("lmac,lc->ma", WVinv, g_l)

    if fix_first_pose:
        # Gauge fixing: zero rows and columns of the anchored poses, identity
        # on their diagonal.
        n_fix = max(1, num_fixed_poses)
        free = (torch.arange(M, device=dev) >= n_fix).to(dt)
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S = S + block * (1.0 - free)[:, None, None, None] * eye6[None, :, None, :]
        rhs = rhs * free[:, None]

    Sd = S.reshape(M * 6, M * 6) + 1e-8 * torch.eye(M * 6, dtype=dt, device=dev)
    # solve_ex leaves `info` on the device: no host read inside a solve.
    dp = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1)).result.reshape(M, 6)
    dl = torch.matmul(
        Vinv, (g_l - torch.einsum("lmab,ma->lb", W, dp))[..., None]
    )[..., 0]
    return dp, dl


class _BAState(NamedTuple):
    T_cw: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor


def _lm_loop(state: _BAState, passes: int, k_max: int, cost_at, normal_equations,
             fix_first_pose: bool, num_fixed_poses: int) -> _BAState:
    """`passes` LM passes; a pass is live while the state is not done and
    its count is below `k_max`, and a pass that is not live changes nothing."""
    for _ in range(passes):
        s = state
        active = ~s.done & (s.k < k_max)
        U, V, W, g_p, g_l = normal_equations(s.T_cw, s.points)
        cost = cost_at(s.T_cw, s.points)
        dp, dl = solve_schur(U, V, W, g_p, g_l, s.lam, fix_first_pose, num_fixed_poses)
        T_new = se3.normalize(se3.compose(se3.exp(dp), s.T_cw))
        pts_new = s.points + dl
        new_cost = cost_at(T_new, pts_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        step = torch.sqrt((dp * dp).sum() + (dl * dl).sum())
        take = active & accept
        lam_next = torch.clamp(torch.where(accept, s.lam * 0.3, s.lam * 5.0), 1e-9, 1e6)
        state = _BAState(
            T_cw=torch.where(take, T_new, s.T_cw),
            points=torch.where(take, pts_new, s.points),
            lam=torch.where(active, lam_next, s.lam),
            cost=torch.where(active, torch.where(accept, new_cost, cost), s.cost),
            k=s.k + active.long(),
            done=torch.where(active, (accept & (step < 1e-6)) | (s.lam > 1e5), s.done),
        )
    return state


def bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    max_iters: int = 20,
    huber_delta: float = 2.0,
    init_lambda: float = 1e-3,
    fix_first_pose: bool = True,
    trim_px: float | None = 10.0,
    num_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
) -> BAResult:
    """LM bundle adjustment over the window -> refined poses and points.

    With `trim_px`, observations whose residual norm exceeds it after the
    first LM convergence are invalidated and a second LM loop refines
    without them. `pose_prior_weight` > 0 adds a diagonal prior anchoring
    each pose to its initial value (residual log(T T_init^-1), J = I for
    left updates): it pins the weakly constrained directions of short,
    small-baseline windows."""
    dev = problem.T_cw.device
    inc = incidence(problem)
    T_prior_inv = se3.inverse(problem.T_cw)
    eye6 = torch.eye(6, dtype=problem.T_cw.dtype, device=dev)

    def prior_residual(T_cw):
        return se3.log(se3.compose(T_cw, T_prior_inv))

    def equations_of(prob: BAProblem):
        def normal_equations(T_cw, points):
            p = prob._replace(T_cw=T_cw, points=points)
            U, V, W, g_p, g_l, _ = build_normal_equations(p, cam, huber_delta, inc)
            if pose_prior_weight > 0.0:
                U = U + pose_prior_weight * eye6
                g_p = g_p - pose_prior_weight * prior_residual(T_cw)
            return U, V, W, g_p, g_l

        return normal_equations

    def reprojection_cost(prob: BAProblem):
        def cost_at(T_cw, points):
            r, valid = reproject_residuals(prob._replace(T_cw=T_cw, points=points), cam)
            return _robust_cost(r, valid, huber_delta)

        return cost_at

    cost1 = reprojection_cost(problem)

    def cost_with_prior(T_cw, points):
        c = cost1(T_cw, points)
        if pose_prior_weight > 0.0:
            rp = prior_residual(T_cw)
            c = c + 0.5 * pose_prior_weight * (rp * rp).sum(-1).mean()
        return c

    c0 = cost_with_prior(problem.T_cw, problem.points)
    lam0 = torch.full((), init_lambda, dtype=torch.float32, device=dev)
    state = _BAState(
        T_cw=problem.T_cw, points=problem.points, lam=lam0, cost=c0,
        k=torch.zeros((), dtype=torch.long, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )
    state = _lm_loop(state, max_iters, max_iters, cost_with_prior,
                     equations_of(problem), fix_first_pose, num_fixed_poses)

    if trim_px is not None:
        # Gross-outlier trim: Huber bounds an outlier's influence only
        # linearly; dropping it removes the influence.
        r, valid = reproject_residuals(
            problem._replace(T_cw=state.T_cw, points=state.points), cam
        )
        keep = valid & (torch.linalg.norm(r, dim=-1) < trim_px)
        trimmed = problem._replace(obs_valid=problem.obs_valid & keep)
        cost2 = reprojection_cost(trimmed)
        state = state._replace(
            lam=lam0, cost=cost2(state.T_cw, state.points),
            done=torch.zeros_like(state.done),
        )
        state = _lm_loop(state, lm_passes(max_iters) - max_iters, 2 * max_iters, cost2,
                         equations_of(trimmed), fix_first_pose, num_fixed_poses)

    return BAResult(T_cw=state.T_cw, points=state.points, cost=state.cost,
                    initial_cost=c0, iterations=state.k)
