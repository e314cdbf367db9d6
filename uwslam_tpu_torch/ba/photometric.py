"""Windowed photometric bundle adjustment: direct alignment over keyframes.

Counterpart of `uwslam_tpu.ba.photometric`. Each keyframe owns a fixed
capacity of semi-dense points (pixel, inverse depth, reference intensity);
every point is observed in every OTHER keyframe of the window, so the
observations are the dense (owner i, observer j, point n) grid with a
validity mask. One batched pass gives every residual r = I_j(pi(X_j)) -
I_i(x) with its Jacobians for both poses and the inverse depth;
Levenberg-Marquardt with Huber weights then solves for the poses and the
inverse depths jointly, the diagonal depth block eliminated by Schur, the
gauge fixed by a strong prior on keyframe 0 and a weak prior on the inverse
depths.

Pose convention as `ba.schur`: T_cw (camera from world), left update
exp(delta) T_cw, twist [v, w].

What differs from the JAX package, by construction:

- Sampling is kernel K3 (`ops.cuda_bilinear_sample`): each observer's
  intensity and gradients as one (H, W, 4) texel image, the K * N
  projections into it as one launch, and the reference intensity with
  C = 1. The JAX package samples with its dense one-hot form on every
  backend; the two agree in the interior to f32 rounding, and at u == W - 1
  or v == H - 1 exactly the dense form returns the last column or row and
  the gather the one before (ROADMAP section 3, "Edge-pixel disagreement").
- The normal equations are accumulated from the owner and observer blocks
  A and B of each observation: one batched product over the points per
  (owner, observer) pair, then sums over the window, all in a fixed order.
  The JAX package assembles a (K, K, N, 6K) Jacobian through one-hot slot
  selectors; a scatter-add (`index_add_`) would add with float atomics in
  an order that changes from run to run on a CUDA device.
- The `while_loop` is a loop of `max_iters` passes with a `done` mask, and
  `solve_ex` leaves its `info` on the device: a solve reads nothing on the
  host, repeats bit for bit and can be captured in a CUDA graph. A pass
  after `done` changes nothing.
- `active` (K,) marks the keyframes that take part: a window padded to a
  fixed capacity (one shape, one capture) has padding keyframes that
  neither own nor observe a point.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.model import PinholeCamera
from ..lie import se3
from ..ops.cuda_sample import cuda_bilinear_sample, pack_texels


class PhotoBAProblem(NamedTuple):
    """K keyframes x N points each, at one pyramid level."""

    images: torch.Tensor      # (K, H, W)
    grad_x: torch.Tensor      # (K, H, W)
    grad_y: torch.Tensor      # (K, H, W)
    T_cw: torch.Tensor        # (K, 4, 4)
    uv: torch.Tensor          # (K, N, 2) owner pixels
    inv_depth: torch.Tensor   # (K, N)
    intensity: torch.Tensor   # (K, N) reference intensities
    valid: torch.Tensor       # (K, N) bool


class PhotoBAResult(NamedTuple):
    T_cw: torch.Tensor
    inv_depth: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor   # LM passes that were live (int64 scalar)


def photo_texels(problem: PhotoBAProblem) -> torch.Tensor:
    """The observers' {I, gx, gy, 0} texels (K, H, W, 4): constant over a solve."""
    return pack_texels(problem.images, problem.grad_x, problem.grad_y)


def _project(problem: PhotoBAProblem, cam: PinholeCamera,
             observer_idx: torch.Tensor | None = None):
    """Every point in every keyframe -> (rho (K, N), owner-frame points X_i
    (K, N, 3), rotations R_ji (K, Kj, 3, 3), observer-frame points X_j
    (K, Kj, N, 3), and the projections grouped by observer (Kj, K N, 2):
    what kernel K3 samples), indexed (i owner, j observer, n point). The
    observers are the keyframes `observer_idx` (Kj,), or all K."""
    K, N = problem.inv_depth.shape
    rho = torch.clamp(problem.inv_depth, min=1e-6)
    # Owner-frame points X_i = unproject(uv) / rho.
    X_i = cam.unproject(problem.uv, torch.ones_like(rho)) / rho[..., None]
    # Relative transforms T_ji = T_cw[j] T_cw[i]^-1 for every pair, (i, j).
    T_ji = torch.matmul(problem.T_cw[None], se3.inverse(problem.T_cw)[:, None])
    if observer_idx is not None:
        T_ji = T_ji.index_select(1, observer_idx)
    R_ji, t_ji = T_ji[..., :3, :3], T_ji[..., :3, 3]
    X_j = torch.einsum("ijab,inb->ijna", R_ji, X_i) + t_ji[:, :, None, :]
    uv_by_j = cam.project(X_j).transpose(0, 1).reshape(T_ji.shape[1], K * N, 2)
    return rho, X_i, R_ji, X_j, uv_by_j


def _observations(problem: PhotoBAProblem, cam: PinholeCamera, texels: torch.Tensor | None = None,
                  active: torch.Tensor | None = None, jacobians: bool = True,
                  observer_idx: torch.Tensor | None = None):
    """Every owner x observer x point residual in one pass (kernel K3, one
    launch) -> r (K, Kj, N), A (K, Kj, N, 6) owner-pose Jacobian, B
    (K, Kj, N, 6) observer-pose Jacobian, Jd (K, Kj, N) inverse-depth
    Jacobian, valid (K, Kj, N), indexed (i owner, j observer, n point), zero
    where not valid; with `jacobians=False` only (r, valid).

    `observer_idx` (Kj,) names the keyframes that observe, and `texels`
    then holds theirs (Kj, H, W, 4) (the observer-sharded solve: a shard
    holds its observers' images, the owners' data is replicated); None:
    all K observe, Kj = K."""
    K, N = problem.inv_depth.shape
    dev = problem.inv_depth.device
    if texels is None:
        texels = photo_texels(problem)
    rho, X_i, R_ji, X_j, uv_by_j = _project(problem, cam, observer_idx)
    Kj = uv_by_j.shape[0]
    # Sample each observer's intensity and gradients at its K * N projections.
    vals, in_img = cuda_bilinear_sample(texels, uv_by_j, texels=True)        # (Kj, 3, K N)
    vals = vals.reshape(Kj, 3, K, N).permute(2, 0, 3, 1)                    # (i, j, n, 3)
    in_img = in_img.reshape(Kj, K, N).transpose(0, 1)
    if observer_idx is None:
        pair = ~torch.eye(K, dtype=torch.bool, device=dev)    # no self-observation
        if active is not None:
            pair = pair & active[:, None] & active[None, :]
    else:
        pair = torch.arange(K, device=dev)[:, None] != observer_idx[None, :]
        if active is not None:
            pair = pair & active[:, None] & active.index_select(0, observer_idx)[None, :]
    valid = problem.valid[:, None, :] & in_img & (X_j[..., 2] > 1e-3) & pair[:, :, None]
    r = torch.where(valid, vals[..., 0] - problem.intensity[:, None, :], 0.0)
    if not jacobians:
        return r, valid

    # g = image-gradient row times the projection Jacobian (1 x 3 per obs).
    Jpi = cam.project_jacobian(X_j)                                          # (K, K, N, 2, 3)
    g = vals[..., 1:2] * Jpi[..., 0, :] + vals[..., 2:3] * Jpi[..., 1, :]
    # Observer pose (left update of T_cw[j]): dX_j/dxi_j = [I, -hat(X_j)],
    # and g hat(X) = g x X.
    B = torch.cat([g, torch.linalg.cross(X_j, g, dim=-1)], dim=-1)
    # Owner pose: dX_j/dxi_i = -R_ji [I, -hat(X_i)].
    gR = torch.matmul(g, R_ji)
    A = torch.cat([-gR, torch.linalg.cross(gR, X_i[:, None].expand_as(gR), dim=-1)], dim=-1)
    # Inverse depth: dX_j/drho = -R_ji X_i / rho.
    Jd = -(gR * (X_i / rho[..., None])[:, None]).sum(-1)
    m = valid[..., None]
    return (r, torch.where(m, A, 0.0), torch.where(m, B, 0.0),
            torch.where(valid, Jd, 0.0), valid)


def _huber_w(r: torch.Tensor, valid: torch.Tensor, delta: float) -> torch.Tensor:
    w = torch.clamp(delta / torch.clamp(torch.abs(r), min=1e-12), max=1.0)
    return torch.where(valid, w, 0.0)


def _cost(r: torch.Tensor, valid: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber rho(r) averaged over the valid observations."""
    a = torch.abs(r)
    rho = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return torch.where(valid, rho, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def _normal_equations(r, A, B, Jd, w):
    """-> Hpp (6K, 6K), bp (6K,), Hpd (6K, K N), Hdd (K, N), bd (K, N).

    An observation (i, j, n) has Jacobian A in pose slot i and B in slot j.
    Per (owner, observer) pair one product over the points gives the 12 x 12
    block of [A B]^T w [A B] and the 12 sums of [A B]^T w r; pose k's
    diagonal block sums its owner blocks over observers and its observer
    blocks over owners, and block (i, j) is A^T w B of the pair (i, j) plus
    B^T w A of the pair (j, i)."""
    K, _, N = r.shape
    wr = w * r
    J = torch.cat([A, B], dim=-1)                                        # (K, K, N, 12)
    Q = torch.matmul((w[..., None] * J).transpose(-1, -2), J)             # (K, K, 12, 12)
    q = torch.matmul(J.transpose(-1, -2), wr[..., None])[..., 0]          # (K, K, 12)
    AB = Q[..., :6, 6:]
    diag = Q[..., :6, :6].sum(1) + Q[..., 6:, 6:].sum(0)                 # (K, 6, 6)
    off = AB + AB.transpose(0, 1).transpose(-1, -2)                      # (i, j, 6, 6)
    eye = torch.eye(K, dtype=r.dtype, device=r.device)
    Hpp = off.permute(0, 2, 1, 3) + eye[:, None, :, None] * diag[:, :, None, :]
    bp = -(q[..., :6].sum(1) + q[..., 6:].sum(0))                         # (K, 6)
    E = w * Jd
    # Pose j, depth (i, n): the observer's blocks; pose i, depth (i, n): the
    # owner's, summed over its observers.
    owner = (E[..., None] * A).sum(1)                                    # (K, N, 6)
    Hpd = ((E[..., None] * B).permute(1, 3, 0, 2)
           + eye[:, None, :, None] * owner.transpose(1, 2)[:, :, None, :])   # (K, 6, K, N)
    Hdd = (E * Jd).sum(1)
    bd = -(Jd * wr).sum(1)
    return (Hpp.reshape(6 * K, 6 * K), bp.reshape(-1), Hpd.reshape(6 * K, K * N), Hdd, bd)


class _State(NamedTuple):
    T_cw: torch.Tensor
    inv_depth: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor


def _damped_step(T_cw, inv_depth, lam, equations, pose0_weight: float, depth_prior: float,
                 optimize_depths: bool):
    """One LM step from the normal equations (Hpp, bp, Hpd, Hdd, bd) at
    (T_cw, inv_depth): the gauge prior on keyframe 0, damping `lam`, the
    depth block eliminated by Schur -> (T_cw, inv_depth, ok); a step that is
    not finite leaves the state as it was."""
    Hpp, bp, Hpd, Hdd, bd = equations
    K, N = inv_depth.shape
    dev, dt = inv_depth.device, inv_depth.dtype
    eye = torch.eye(6 * K, dtype=dt, device=dev)
    gauge = torch.where(torch.arange(6 * K, device=dev) < 6, pose0_weight, 0.0).to(dt)
    Hpp = Hpp + torch.diag(gauge)
    Hpp = Hpp + lam * torch.diag(torch.diagonal(Hpp)) + 1e-6 * eye
    if optimize_depths:
        Hdd_inv = 1.0 / torch.clamp(Hdd * (1.0 + lam) + depth_prior, min=1e-12)
        S = Hpp - torch.matmul(Hpd * Hdd_inv.reshape(1, -1), Hpd.T)
        rhs = bp - torch.matmul(Hpd, (Hdd_inv * bd).reshape(-1))
        dp = torch.linalg.solve_ex(S, rhs[:, None]).result[:, 0]
        dd = Hdd_inv * (bd - torch.matmul(dp, Hpd).reshape(K, N))
    else:
        dp = torch.linalg.solve_ex(Hpp, bp[:, None]).result[:, 0]
        dd = torch.zeros_like(inv_depth)
    T_new = se3.normalize(se3.compose(se3.exp(dp.reshape(K, 6)), T_cw))
    depth_new = torch.clamp(inv_depth + dd, min=1e-4)
    ok = torch.isfinite(dp).all() & torch.isfinite(dd).all()
    return torch.where(ok, T_new, T_cw), torch.where(ok, depth_new, inv_depth), ok


def _levenberg_marquardt(T_cw, inv_depth, cost_at, equations_at, max_iters: int,
                         init_lambda: float, pose0_weight: float, depth_prior: float,
                         optimize_depths: bool) -> PhotoBAResult:
    """The JAX package's LM loop over `cost_at(T, d)` and the normal
    equations `equations_at(T, d)`: a step is taken when its cost is lower,
    lambda halves or quadruples within [1e-8, 1e4], and the solve stops at
    lambda > 1e3 or a relative cost change below 1e-7. A loop of `max_iters`
    passes with a `done` mask: nothing is read on the host."""
    dev, dt = inv_depth.device, inv_depth.dtype
    c0 = cost_at(T_cw, inv_depth)
    s = _State(
        T_cw=T_cw, inv_depth=inv_depth, cost=c0,
        lam=torch.full((), init_lambda, dtype=dt, device=dev),
        k=torch.zeros((), dtype=torch.long, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )
    for _ in range(max_iters):
        live = ~s.done
        T_new, d_new, ok = _damped_step(s.T_cw, s.inv_depth, s.lam,
                                        equations_at(s.T_cw, s.inv_depth), pose0_weight,
                                        depth_prior, optimize_depths)
        c_new = cost_at(T_new, d_new)
        accept = ok & torch.isfinite(c_new) & (c_new < s.cost)
        take = live & accept
        done = (s.lam > 1e3) | (accept & (torch.abs(s.cost - c_new) < 1e-7 * (s.cost + 1e-9)))
        lam = torch.clamp(torch.where(accept, s.lam * 0.5, s.lam * 4.0), 1e-8, 1e4)
        s = _State(
            T_cw=torch.where(take, T_new, s.T_cw),
            inv_depth=torch.where(take, d_new, s.inv_depth),
            cost=torch.where(take, c_new, s.cost),
            lam=torch.where(live, lam, s.lam),
            k=s.k + live.long(),
            done=torch.where(live, done, s.done),
        )
    return PhotoBAResult(T_cw=s.T_cw, inv_depth=s.inv_depth, cost=s.cost, initial_cost=c0,
                         iterations=s.k)


def photometric_bundle_adjust(
    problem: PhotoBAProblem,
    cam: PinholeCamera,
    max_iters: int = 12,
    huber_delta: float = 12.0,
    pose0_weight: float = 1e8,
    depth_prior: float = 1e-2,
    init_lambda: float = 1e-3,
    optimize_depths: bool = True,
    active: torch.Tensor | None = None,
) -> PhotoBAResult:
    """Joint LM over {T_cw} and {inverse depths} with Schur elimination of
    the diagonal depth block; keyframe 0 is the gauge anchor. `active` (K,)
    bool marks the keyframes that take part (None: all)."""
    texels = photo_texels(problem)

    def cost_at(T_cw, inv_depth):
        p = problem._replace(T_cw=T_cw, inv_depth=inv_depth)
        r, valid = _observations(p, cam, texels, active, jacobians=False)
        return _cost(r, valid, huber_delta)

    def equations_at(T_cw, inv_depth):
        p = problem._replace(T_cw=T_cw, inv_depth=inv_depth)
        r, A, B, Jd, valid = _observations(p, cam, texels, active)
        return _normal_equations(r, A, B, Jd, _huber_w(r, valid, huber_delta))

    return _levenberg_marquardt(problem.T_cw, problem.inv_depth, cost_at, equations_at,
                                max_iters, init_lambda, pose0_weight, depth_prior,
                                optimize_depths)


def photo_ba_problem_from_keyframes(pyramids, T_cw, points, level: int = 1) -> PhotoBAProblem:
    """K keyframe pyramids, their T_cw and their level-0 TrackPoints (one
    frame each, with or without a leading batch axis of 1) -> the problem at
    pyramid level `level`; solve it with `cam.scaled(level)`. The reference
    intensity is sampled again at that level (kernel K3, C = 1)."""
    def plane(p, field):
        x = getattr(p, field)[level]
        return x.reshape(x.shape[-2:])

    images = torch.stack([plane(p, "images") for p in pyramids])
    uv = torch.stack([pt.uv.reshape(-1, 2) for pt in points]) * (1.0 / (1 << level))
    intensity = cuda_bilinear_sample(images[:, None].contiguous(), uv.contiguous())[0][:, 0]
    return PhotoBAProblem(
        images=images,
        grad_x=torch.stack([plane(p, "grad_x") for p in pyramids]),
        grad_y=torch.stack([plane(p, "grad_y") for p in pyramids]),
        T_cw=torch.stack(list(T_cw)),
        uv=uv,
        inv_depth=torch.stack([
            1.0 / torch.clamp(pt.p3d[..., 2].reshape(-1), min=1e-6) for pt in points]),
        intensity=intensity,
        valid=torch.stack([pt.valid.reshape(-1) for pt in points]),
    )
