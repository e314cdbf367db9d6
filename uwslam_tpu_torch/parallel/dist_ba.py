"""Distributed bundle adjustment: landmark-sharded Schur reduction, in PyTorch.

Counterpart of `uwslam_tpu.parallel.dist_ba`. Landmarks and their
observations are partitioned into shards balanced by observation load
(`shard_problem`); keyframe poses are replicated. Each shard builds its
local V, W and g_l blocks and its share of U and g_p; per LM iteration
the pose-side quantities and the reduced camera system are summed over
all shards, the (6M x 6M) system is solved on one process and the (M, 6)
step broadcast, and each shard back-substitutes its landmarks. With
`solver="pcg"` a block-Jacobi preconditioned conjugate gradient in matvec
form replaces the dense solve (one (M, 6) sum per CG step).

Where the JAX package runs one shard per device under `shard_map` and
sums with `psum`, a process here holds its shards as a leading axis of one
set of tensors (`runtime.ShardLayout`): the sum over shards is a pairwise
tree over that axis, then a `torch.distributed.all_reduce` over processes
when there is more than one. With a power-of-two shard count per process
two processes give the bits of one process holding all shards (the tree
is the same; a two-process all-reduce adds two values). The segment sums
take a fixed order, so a solve repeats bit for bit: per keyframe a product
with a one-hot table (observations x keyframes), per landmark a gather of
its valid observations into a padded (landmarks, views) table, summed over
the views (a one-hot product over all landmarks would cost O(L O M)). The
JAX package's `while_loop`s are loops of at most their length with a `done`
mask, as in `ba.schur` (a finished state takes no update, so stopping early
changes no result).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ba.schur import (
    BAProblem,
    BAResult,
    _huber_weights,
    _inv3x3,
    _mean_diag,
    _obs_jacobians,
    reproject_residuals,
)
from ..camera.model import PinholeCamera
from ..lie import se3
from ..utils.linalg import cholesky_solve_unrolled
from .runtime import ShardLayout

AXIS = "lm"   # the JAX package's mesh axis of the landmark shards

# The host reads `done` every CHECK_EVERY LM passes and CG steps and stops
# once it is set; every process reads the same replicated value.
CHECK_EVERY = 5


def shard_problem(problem: BAProblem, num_shards: int) -> BAProblem:
    """Re-pack a problem so that landmarks and their observations are grouped
    by shard, balanced by observation load: landmarks are assigned greedily,
    the most observed first, each to the lightest shard so far (ties to the
    lower shard), and every shard is padded to the largest load. L and O of
    the result divide by `num_shards`; shard s holds landmarks [s Lk, (s+1)
    Lk) and observations [s cap, (s+1) cap); padding observations point at
    their shard's first landmark and are invalid. Host numpy, as in the JAX
    package; the result lies on the problem's device."""
    dev = problem.points.device
    L = problem.points.shape[0]
    pts = problem.points.cpu().numpy()
    obs_kf = problem.obs_kf.cpu().numpy()
    obs_lm = problem.obs_lm.cpu().numpy()
    obs_uv = problem.obs_uv.cpu().numpy()
    obs_valid = problem.obs_valid.cpu().numpy()

    # Every row costs compute whatever its validity (the shapes are static).
    counts = np.bincount(obs_lm, minlength=L)
    order_lm = np.argsort(-counts, kind="stable")
    load = np.zeros(num_shards, np.float64)
    members: list[list[int]] = [[] for _ in range(num_shards)]
    for lm in order_lm:
        # The tiny member term spreads landmarks without observations too.
        s = int(np.argmin(load))
        load[s] += counts[lm] + 1e-3
        members[s].append(int(lm))

    Lk = max(max(len(m) for m in members), 1)
    pts_s = np.zeros((Lk * num_shards, 3), pts.dtype)
    new_of_old = np.zeros(L, np.int64)
    for s, mem in enumerate(members):
        for j, lm in enumerate(mem):
            pts_s[s * Lk + j] = pts[lm]
            new_of_old[lm] = s * Lk + j
    new_lm = new_of_old[obs_lm]
    shard_of_obs = new_lm // Lk

    per = [np.where(shard_of_obs == s)[0] for s in range(num_shards)]
    cap = max(max(len(p) for p in per), 1)
    O_pad = cap * num_shards
    kf2 = np.zeros(O_pad, obs_kf.dtype)
    lm2 = np.zeros(O_pad, obs_lm.dtype)
    uv2 = np.zeros((O_pad, 2), obs_uv.dtype)
    va2 = np.zeros(O_pad, bool)
    for s, idx in enumerate(per):
        dst = slice(s * cap, s * cap + len(idx))
        kf2[dst], lm2[dst], uv2[dst], va2[dst] = obs_kf[idx], new_lm[idx], obs_uv[idx], obs_valid[idx]
        lm2[s * cap + len(idx):(s + 1) * cap] = s * Lk
    return BAProblem(
        T_cw=problem.T_cw,
        **{k: torch.from_numpy(v).to(dev) for k, v in
           (("points", pts_s), ("obs_kf", kf2), ("obs_lm", lm2), ("obs_uv", uv2),
            ("obs_valid", va2))},
    )


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (shard) axis in a fixed pairwise order."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] + x[1::2]
    return x[0]


def _psum(x: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """The sum over every shard of every process (`jax.lax.psum`)."""
    out = _tree_sum(x)
    if layout.world > 1:
        dist.all_reduce(out)
    return out


class _Shards(NamedTuple):
    """This process's shards, each a leading axis of size S."""

    obs_kf: torch.Tensor      # (S, Oc) long: the shard's valid rows, then padding
    obs_lm: torch.Tensor      # (S, Oc) long, index into the shard's landmarks
    obs_uv: torch.Tensor      # (S, Oc, 2)
    obs_valid: torch.Tensor   # (S, Oc) bool
    inc_kf: torch.Tensor      # (S, Oc, M) one-hot
    lm_rows: torch.Tensor     # (S, Ls, Vmax) long: each landmark's valid observations,
    #                           in observation order, padded with Oc (a zero row)
    lm_kf: torch.Tensor       # (S, Ls, Vmax, M) one-hot keyframe of each entry (0: padding)


def _landmark_rows(obs_lm: np.ndarray, valid: np.ndarray, Ls: int):
    """Per shard and landmark, the rows of its valid observations -> (S, Ls,
    Vmax) padded with the row count (a zero row is appended there)."""
    S, Os = obs_lm.shape
    counts = np.zeros((S, Ls), np.int64)
    for s in range(S):
        counts[s] = np.bincount(obs_lm[s][valid[s]], minlength=Ls)
    vmax = max(int(counts.max()), 1)
    rows = np.full((S, Ls, vmax), Os, np.int64)
    for s in range(S):
        idx = np.flatnonzero(valid[s])
        idx = idx[np.argsort(obs_lm[s][idx], kind="stable")]
        lm = obs_lm[s][idx]
        start = np.searchsorted(lm, np.arange(Ls))
        slot = np.arange(idx.size) - start[lm]
        rows[s, lm, slot] = idx
    return rows


def _local_shards(problem: BAProblem, layout: ShardLayout):
    """This process's shards of a `shard_problem` result -> (_Shards, points
    (S, Ls, 3)). Each shard keeps only its valid observation rows, in their
    order, padded to the most any shard of the problem has: an invalid row
    adds nothing to any sum or count, and `shard_problem` pads every shard
    to the largest row load (the capacity padding of a problem built by
    `TrackGraph` lands on one landmark, so its shard's load is the whole
    capacity). Every process pads to the same length, so a shard's tensors
    do not depend on how many shards a process holds."""
    n, S = layout.total, layout.local
    M = problem.T_cw.shape[0]
    L, O = problem.points.shape[0], problem.obs_kf.shape[0]
    if L % n or O % n:
        raise ValueError(f"problem of {L} landmarks and {O} observations is not laid out "
                         f"for {n} shards (use shard_problem)")
    Ls, Os = L // n, O // n
    first = layout.rank * S
    dev = problem.obs_kf.device
    valid_all = problem.obs_valid.cpu().numpy().reshape(n, Os)
    Oc = max(int(valid_all.sum(1).max()), 1)
    take = np.full((S, Oc), -1, np.int64)            # -1: a padding row
    for k in range(S):
        idx = np.flatnonzero(valid_all[first + k])
        take[k, :idx.size] = (first + k) * Os + idx
    take_t = torch.from_numpy(take).to(dev)
    pad = take_t < 0
    safe = torch.where(pad, 0, take_t).reshape(-1)

    def pick(x, fill):
        v = x[safe].reshape(S, Oc, *x.shape[1:])
        return torch.where(pad.reshape(S, Oc, *([1] * (x.dim() - 1))), fill, v)

    obs_kf = pick(problem.obs_kf.long(), 0)
    base = (torch.arange(S, device=dev) + first)[:, None] * Ls
    obs_lm = torch.where(pad, 0, pick(problem.obs_lm.long(), 0) - base)
    obs_valid = pick(problem.obs_valid, False)
    arange_m = torch.arange(M, device=dev)
    lm_rows = torch.from_numpy(_landmark_rows(
        obs_lm.cpu().numpy(), obs_valid.cpu().numpy(), Ls)).to(dev)
    kf_pad = torch.cat([obs_kf, torch.full((S, 1), -1, dtype=obs_kf.dtype, device=dev)], dim=1)
    lm_kf = torch.gather(kf_pad, 1, lm_rows.reshape(S, -1)).reshape(lm_rows.shape)
    shards = _Shards(obs_kf=obs_kf, obs_lm=obs_lm, obs_uv=pick(problem.obs_uv, 0.0),
                     obs_valid=obs_valid, inc_kf=(obs_kf[..., None] == arange_m).float(),
                     lm_rows=lm_rows, lm_kf=(lm_kf[..., None] == arange_m).float())
    points = problem.points[first * Ls:(first + S) * Ls].reshape(S, Ls, 3)
    return shards, points


def _flat(sh: _Shards):
    """The shards' observations as one table whose landmark index runs over
    the stacked (S Ls) landmarks: one batched Jacobian pass for all."""
    S, Ls = sh.lm_rows.shape[:2]
    base = torch.arange(S, device=sh.obs_lm.device)[:, None] * Ls
    return (sh.obs_kf.reshape(-1), (sh.obs_lm + base).reshape(-1),
            sh.obs_uv.reshape(-1, 2), sh.obs_valid.reshape(-1))


def _huber_cost_parts(r, valid, delta: float):
    """Per-shard Huber cost sums and valid counts, r (S, Os, 2)."""
    nrm = torch.linalg.vector_norm(r, dim=-1)
    c = torch.where(nrm <= delta, 0.5 * nrm * nrm, delta * (nrm - 0.5 * delta))
    return torch.where(valid, c, 0.0).sum(-1), valid.sum(-1).to(r.dtype)


def _local_normal_eq(T_cw, points, sh: _Shards, cam: PinholeCamera, huber_delta: float):
    """Each shard's normal-equation blocks: U (S, M, 6, 6), V (S, Ls, 3, 3),
    W (S, Ls, M, 6, 3), g_p (S, M, 6), g_l (S, Ls, 3), and the cost pieces
    (sum, count) per shard."""
    S, Os, M = sh.inc_kf.shape
    Ls, vmax = sh.lm_rows.shape[1:]
    kf, lm, uv, valid = _flat(sh)
    prob = BAProblem(T_cw=T_cw, points=points.reshape(-1, 3), obs_kf=kf, obs_lm=lm,
                     obs_uv=uv, obs_valid=valid)
    A, B, r, valid = _obs_jacobians(prob, cam)
    w = _huber_weights(r, valid, huber_delta)
    wA, wB = w[:, None, None] * A, w[:, None, None] * B
    At, Bt = wA.transpose(-1, -2), wB.transpose(-1, -2)
    AtA = torch.matmul(At, A).reshape(S, Os, 36)
    BtB = torch.matmul(Bt, B).reshape(S, Os, 9)
    AtB = torch.matmul(At, B).reshape(S, Os, 18)
    Atr = torch.matmul(At, r[..., None]).reshape(S, Os, 6)
    Btr = torch.matmul(Bt, r[..., None]).reshape(S, Os, 3)

    per_kf = torch.bmm(sh.inc_kf.transpose(1, 2), torch.cat([AtA, Atr], dim=-1))   # (S, M, 42)
    U, g_p = per_kf[..., :36].reshape(S, M, 6, 6), -per_kf[..., 36:]
    # Each landmark's observations gathered into its (Vmax,) slots, the
    # padding slot a zero row, then summed over the slots; W[l, m] takes the
    # entries of keyframe m through the slots' one-hot keyframe table.
    per_obs = torch.cat([BtB, Btr, AtB], dim=-1)                                  # (S, Os, 30)
    per_obs = torch.cat([per_obs, torch.zeros_like(per_obs[:, :1])], dim=1)
    g = torch.gather(per_obs, 1, sh.lm_rows.reshape(S, -1, 1).expand(-1, -1, 30))
    g = g.reshape(S, Ls, vmax, 30)
    per_lm = g[..., :12].sum(2)
    V, g_l = per_lm[..., :9].reshape(S, Ls, 3, 3), -per_lm[..., 9:12]
    W = torch.matmul(sh.lm_kf.transpose(-1, -2), g[..., 12:]).reshape(S, Ls, M, 6, 3)
    cost_sum, cost_n = _huber_cost_parts(r.reshape(S, Os, 2), valid.reshape(S, Os), huber_delta)
    return U, V, W, g_p, g_l, cost_sum, cost_n


def _reproject(T_cw, points, sh: _Shards, cam: PinholeCamera):
    """Residuals (S, Os, 2) and validity (S, Os) at the state."""
    S, Os = sh.obs_kf.shape
    kf, lm, uv, valid = _flat(sh)
    r, valid = reproject_residuals(BAProblem(T_cw=T_cw, points=points.reshape(-1, 3), obs_kf=kf,
                                             obs_lm=lm, obs_uv=uv, obs_valid=valid), cam)
    return r.reshape(S, Os, 2), valid.reshape(S, Os)


def distributed_bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    layout: ShardLayout,
    max_iters: int = 20,
    huber_delta: float = 2.0,
    init_lambda: float = 1e-3,
    fix_first_pose: bool = True,
    num_fixed_poses: int = 1,
    pose_prior_weight: float = 0.0,
    full_budget: bool = False,
    solver: str = "auto",
    cg_iters: int = 64,
) -> BAResult:
    """LM bundle adjustment with landmarks sharded by `layout`.

    `problem` comes from `shard_problem(problem, layout.total)`: every process
    passes the whole problem and works on its own shards. `solver`: "direct"
    (sum the reduced system, solve it densely on the first process,
    broadcast the step), "pcg" (block-Jacobi preconditioned CG in matvec
    form, `cg_iters` steps at most) or "auto" (= direct, the JAX package's
    choice). `pose_prior_weight` > 0 anchors each pose to its initial value
    (residual log(T T_init^-1), J = I). With `full_budget` every one of the
    `max_iters` passes is live. The result's points are the whole problem's
    (gathered from every process)."""
    if solver not in ("auto", "direct", "pcg"):
        raise ValueError(f"solver must be auto, direct or pcg, got {solver!r}")
    use_pcg = solver == "pcg"
    dev, dt = problem.T_cw.device, problem.T_cw.dtype
    M = problem.T_cw.shape[0]
    sh, points0 = _local_shards(problem, layout)
    T_init = problem.T_cw
    T_prior_inv = se3.inverse(T_init)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    # Pose gauge: 0 for the anchored poses (monocular problems anchor 2, so
    # that the free global scale is pinned too).
    mask = torch.ones(M, dtype=dt, device=dev)
    if fix_first_pose:
        mask[: max(1, num_fixed_poses)] = 0.0
    primary = layout.rank == 0

    def prior_residual(T):
        return se3.log(se3.compose(T, T_prior_inv))

    def prior_cost(T):
        rp = prior_residual(T)
        return 0.5 * pose_prior_weight * (rp * rp).sum(-1).mean()

    def cost_at(T, pts):
        r, valid = _reproject(T, pts, sh, cam)
        s, n = _huber_cost_parts(r, valid, huber_delta)
        c = _psum(s, layout) / torch.clamp(_psum(n, layout), min=1.0)
        return c + prior_cost(T) if pose_prior_weight > 0.0 else c

    def solve_direct(U_d, W, WVinv, g_p, g_l):
        S_red = _psum(torch.einsum("slmac,slnbc->smanb", WVinv, W), layout)
        rhs_red = _psum(torch.einsum("slmac,slc->sma", WVinv, g_l), layout)
        dp = torch.zeros((M, 6), dtype=dt, device=dev)
        if primary:
            # The dense assembly and O(M^3) solve run on one process; the
            # others would idle at the broadcast anyway.
            block = torch.eye(M, dtype=dt, device=dev)[:, None, :, None]
            S = block * U_d[:, :, None, :] - S_red
            rhs = g_p - rhs_red
            if fix_first_pose:
                free = mask
                S = S * free[:, None, None, None] * free[None, None, :, None]
                S = S + block * (1.0 - free)[:, None, None, None] * eye6[None, :, None, :]
                rhs = rhs * free[:, None]
            Sd = S.reshape(M * 6, M * 6) + 1e-8 * torch.eye(M * 6, dtype=dt, device=dev)
            dp = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1)).result.reshape(M, 6)
        if layout.world > 1:
            dist.broadcast(dp, src=0)
        return dp

    def solve_pcg(U_d, W, WVinv, g_p, g_l):
        S_diag_red = _psum(torch.einsum("slmac,slmbc->smab", WVinv, W), layout)
        rhs_red = _psum(torch.einsum("slmac,slc->sma", WVinv, g_l), layout)
        m3 = mask[:, None, None]
        D = (U_d - S_diag_red) * m3 + eye6 * (1.0 - m3)
        rhs = (g_p - rhs_red) * mask[:, None]
        D_pre = D + 1e-8 * eye6

        def precond(r):
            return cholesky_solve_unrolled(D_pre, r) * mask[:, None]

        def matvec(x):
            xm = x * mask[:, None]
            y = torch.einsum("mab,mb->ma", U_d, xm)
            u = torch.einsum("slnbc,nb->slc", W, xm)
            s_l = torch.einsum("slmac,slc->sma", WVinv, u)
            return (y - _psum(s_l, layout)) * mask[:, None]

        bnorm = torch.sqrt(torch.sum(rhs * rhs))
        x = torch.zeros_like(rhs)
        r = rhs
        p = precond(rhs)
        rz = torch.sum(rhs * p)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for step in range(cg_iters):
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x2, r2 = x + alpha * p, r - alpha * Ap
            z2 = precond(r2)
            rz2 = torch.sum(r2 * z2)
            p2 = z2 + rz2 / torch.clamp(rz, min=1e-30) * p
            fin = torch.sqrt(torch.sum(r2 * r2)) < 1e-5 * torch.clamp(bnorm, min=1e-30)
            x, r, p, rz = (torch.where(done, a, b) for a, b in ((x, x2), (r, r2), (p, p2), (rz, rz2)))
            done = done | fin
            if (step + 1) % CHECK_EVERY == 0 and bool(done):
                break
        return x

    solve = solve_pcg if use_pcg else solve_direct
    c0 = cost_at(T_init, points0)
    T, pts = T_init, points0
    lam = torch.full((), init_lambda, dtype=dt, device=dev)
    cost = c0
    k = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for p in range(max_iters):
        active = ~done
        U_p, V, W, g_p_p, g_l, cost_s, cost_n = _local_normal_eq(T, pts, sh, cam, huber_delta)
        U = _psum(U_p, layout)
        g_p = _psum(g_p_p, layout)
        cost_now = _psum(cost_s, layout) / torch.clamp(_psum(cost_n, layout), min=1.0)
        if pose_prior_weight > 0.0:
            # Replicated pose-side information: it enters once, after the sum.
            U = U + pose_prior_weight * eye6
            g_p = g_p - pose_prior_weight * prior_residual(T)
            cost_now = cost_now + prior_cost(T)
        Vinv = _inv3x3(V + lam * eye3 * _mean_diag(V))
        WVinv = torch.matmul(W, Vinv[:, :, None])                        # (S, Ls, M, 6, 3)
        U_d = U + lam * eye6 * _mean_diag(U)
        dp = solve(U_d, W, WVinv, g_p, g_l)
        dl = torch.matmul(
            Vinv, (g_l - torch.einsum("slmab,ma->slb", W, dp))[..., None])[..., 0]
        T_new = se3.normalize(se3.compose(se3.exp(dp), T))
        pts_new = pts + dl
        new_cost = cost_at(T_new, pts_new)
        # A step to a non-finite state leaves no observation valid, so its
        # mean cost reads 0 and would be taken (the JAX package's accept test
        # takes it); it is refused here. The count is summed over every shard.
        bad = _psum((~torch.isfinite(pts_new)).sum((-1, -2)).to(dt), layout)
        finite = torch.isfinite(T_new).all() & (bad == 0)
        accept = (new_cost < cost_now) & torch.isfinite(new_cost) & finite
        step = torch.sqrt(_psum((dl * dl).sum((-1, -2)), layout) + (dp * dp).sum())
        take = active & accept
        lam_next = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-9, 1e6)
        finished = torch.zeros_like(done) if full_budget else (
            (accept & (step < 1e-6)) | (lam > 1e5))
        T = torch.where(take, T_new, T)
        pts = torch.where(take, pts_new, pts)
        lam = torch.where(active, lam_next, lam)
        cost = torch.where(active, torch.where(accept, new_cost, cost_now), cost)
        k = k + active.long()
        done = torch.where(active, finished, done)
        if (p + 1) % CHECK_EVERY == 0 and bool(done):
            break
    points = pts.reshape(-1, 3)
    if layout.world > 1:
        parts = [torch.empty_like(points) for _ in range(layout.world)]
        dist.all_gather(parts, points)
        points = torch.cat(parts)
    return BAResult(T_cw=T, points=points, cost=cost, initial_cost=c0, iterations=k)
