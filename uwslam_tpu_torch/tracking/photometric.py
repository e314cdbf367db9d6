"""Photometric pose tracking, batched over frame pairs.

Counterpart of `uwslam_tpu.tracking.photometric`: forward-compositional
(`residuals_and_jacobian`, `lm_level`) and inverse-compositional
(`lm_level_ic`) Levenberg-Marquardt, affine brightness (`_affine_residual`,
`_affine_columns`), and the coarse-to-fine `track` with its basin guard.
The JAX package vmaps one pair's program over the pairs; here every tensor
carries the pair dimension B first, and the live path is B = 1 of the same
code.

The JAX package's `_warp_sample` is kernel K2. Here an LM evaluation with
Huber weights or none, with or without affine brightness, is ONE launch of
K2's redesign `ops.cuda_track.lm_evaluate`: warp, sample, residual (with
affine=True r - a I_ref - b), Jacobian (with the columns (-I_ref, -1)),
robust weight and cost, and the pair's normal equations; the loop carries
48 floats per pair (80 with affine), and residuals and Jacobians never
reach device memory. On a card the update that follows each evaluation
(the accept test, the damped solve, the pose and brightness update) is
one launch of `ops.cuda_lm.lm_step` on state buffers the level owns; its
plain version, `lm_step`, is the CPU's and the Tukey loop's. Tukey
weights (their scale is a median of the residuals at every solve) and
the first evaluation of every level (whose residuals give the level's
scale sigma0) go through `ops.cuda_track.warp_and_sample` (C = 3 texels
in FC, C = 1 in IC and the basin guard) and plain operations. The reference-side `bilinear_sample_auto`
is kernel K3, `ops.cuda_sample.cuda_bilinear_sample`.

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
from ..ops import cuda_lm
from ..ops.cuda_lm import LMLoop
from ..ops.cuda_sample import cuda_bilinear_sample, pack_texels
from ..ops.cuda_track import LMEvaluator, WarpSampler, fc_jacobian, lm_layout, warp_and_sample
from ..utils.linalg import cholesky_solve_unrolled
from ..utils.precision import disable_tf32
from .points import TrackPoints
from .robust import WeightKind, mad_sigma, robust_cost, weights

disable_tf32()

MODES = ("fc", "ic")
FUSED_KINDS = (WeightKind.HUBER, WeightKind.NONE)   # what `lm_evaluate` computes
# LM levels built, by the path their updates take: `lm_step` launches (a
# fused level on a card) or the plain loop (the CPU, Tukey weights). A CUDA
# graph's replay runs no Python, so levels are counted when they are built;
# `system.SlamSystem` reads the counts around each capture.
LM_LEVELS = {"lm_kernel_levels": 0, "lm_plain_levels": 0}


class TrackResult(NamedTuple):
    T: torch.Tensor            # (B, 4, 4) refined pose (target <- reference)
    error: torch.Tensor        # (B,) final mean robust error
    iterations: torch.Tensor   # (B,) LM iterations over all levels
    inliers: torch.Tensor      # (B,) valid residual count at the finest level
    converged: torch.Tensor    # (B,) bool
    affine: torch.Tensor | None = None  # (B, 2) brightness (a, b); 0 unless affine


class LMState(NamedTuple):
    T: torch.Tensor           # (B, 4, 4) best accepted pose
    r_best: torch.Tensor | None      # (B, N) residuals at T
    J: torch.Tensor | None    # (B, N, 6|8) FC: Jacobian at T; IC: the constant one
    valid_best: torch.Tensor | None  # (B, N) validity at T
    error: torch.Tensor       # (B,) robust error at T
    lam: torch.Tensor         # (B,) LM damping
    k: torch.Tensor           # (B,) iterations run
    done: torch.Tensor        # (B,) bool
    n_inlier: torch.Tensor    # (B,) valid count at T
    ab: torch.Tensor | None = None  # (B, 2) affine brightness at T
    abs_r: torch.Tensor | None = None  # (B,) sum |r| at T (the basin guard's)


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


def _residuals_sampled(T, pts, ref_intensity, sampler, cam):
    """`residuals_and_jacobian` through a K2 sampler bound to the target's
    texels."""
    vals, ok = sampler(T)                                     # K2, C = 3
    valid = pts.valid & ok
    r = vals[:, 0] - ref_intensity
    J = fc_jacobian(vals[:, 1], vals[:, 2], pts.p3d, T, cam)
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
    intensity and gradients (kernel K2 on texels, C = 3) -> residual and
    analytic Jacobian. T (B, 4, 4); image and gradients (B, H, W). Returns
    r (B, N), J (B, N, 6) in [v, w] order, valid (B, N); r and J are 0 where
    invalid."""
    sampler = WarpSampler(pack_texels(image, grad_x, grad_y), pts.p3d, cam, texels=True)
    return _residuals_sampled(T, pts, ref_intensity, sampler, cam)


def _plain_steps(residuals, first, sigma0, weight_kind, J_const):
    """The LM loop's steps from per-point residuals: `residuals(T, ab) ->
    (r, J or None, valid)` (J None: the constant `J_const`, masked per
    solve); `first` is its result at the initial state. Huber and none keep
    sigma0; Tukey re-estimates the MAD scale per solve over the state's
    validity mask. The state carried is (r, valid) and, in FC, J."""

    def evaluation(r, J, valid):
        err = robust_cost(r, valid, weight_kind, sigma=sigma0)
        return err, valid.sum(-1), (r, valid) if J is None else (r, valid, J)

    def evaluate(T, ab):
        return evaluation(*residuals(T, ab))

    def solve(state, lam):
        r, valid = state[:2]
        J = state[2] if len(state) == 3 else torch.where(valid[..., None], J_const, 0.0)
        sig = mad_sigma(r, valid) if weight_kind == WeightKind.TUKEY else sigma0
        wJ = weights(r, valid, weight_kind, sigma=sig)[..., None] * J
        H = torch.einsum("bni,bnj->bij", J, wJ)
        b = -torch.einsum("bni,bn->bi", wJ, r)
        return _solve_damped(H, b, lam)

    return evaluation(*first), evaluate, solve


def _fused_steps(evaluator: LMEvaluator, T0, ab0):
    """The LM loop's steps from `lm_evaluate`: one launch per evaluation; the
    state carried is the pair's sums (48 floats, 80 with affine brightness:
    the 8 x 8 system of [xi, a, b])."""
    lay = evaluator.layout

    def evaluate(T, ab):
        sums = evaluator(T, ab) if evaluator.affine else evaluator(T)
        count = sums[:, lay.count]
        return sums[:, lay.cost] / torch.clamp(count, min=1.0), count.long(), (sums,)

    def solve(state, lam):
        sums = state[0]
        return _solve_damped(sums[:, lay.H].view(-1, lay.n, lay.n), sums[:, lay.b], lam)

    err0, n0, (sums0,) = evaluate(T0, ab0)
    # The evaluator writes one buffer: the initial state keeps a copy.
    return (err0, n0, (sums0.clone(),)), evaluate, solve


def _apply_delta(T, delta):
    # FC: T exp(delta). IC: with r = I_tgt - I_ref and b = -J^T W r the
    # reference-side increment is exp(-delta), and T exp(-delta)^-1 is the
    # same update. Affine brightness (delta[:, 6:]) is additive.
    return se3.normalize(se3.compose(T, se3.exp(delta[:, :6])))


def lm_start(T0, ab0, first: tuple, solve: Callable, init_lambda: float,
             affine: bool) -> LMLoop:
    """What precedes the LM loop, from `first` = (error, valid count, state)
    of the evaluation at (T0, ab0): the best state is the initial one, and
    the first candidate is its damped step at init_lambda. The plain version
    of `ops.cuda_lm.lm_step_init`."""
    error, n_inlier, s_best = first
    B = T0.shape[0]
    lam = torch.full((B,), init_lambda, dtype=T0.dtype, device=T0.device)
    delta0 = solve(s_best, lam)
    return LMLoop(
        T=_apply_delta(T0, delta0), ab=ab0 + delta0[:, 6:] if affine else ab0,
        T_best=T0, ab_best=ab0, s_best=s_best, error=error, lam=lam,
        k=torch.zeros(B, dtype=torch.int64, device=T0.device),
        done=torch.zeros(B, dtype=torch.bool, device=T0.device), n_inlier=n_inlier)


def lm_step(loop: LMLoop, evaluation: tuple, solve: Callable, max_iters: int, eps: float,
            affine: bool) -> LMLoop:
    """One iteration of the deferred-evaluation LM after the candidate's
    evaluation = (error (B,), valid count (B,), state) at (loop.T, loop.ab):
    accept or reject the previous step on the rho objective at the level's
    sigma0, solve the next step from the best state (`solve(state, lam) ->
    delta`) and stop a pair on a small accepted step, a damping above 500 or
    a step that is not finite. Every field changes only for pairs still
    iterating. The plain version of `ops.cuda_lm.lm_step`, which the card's
    fused path launches in its place."""
    err, n_valid, s = evaluation
    T, ab, T_best, ab_best, s_best, error, lam, k, done, n_inlier = loop
    active = ~done & (k < max_iters)
    accept = (err < error) & torch.isfinite(err)
    T_base = _where(accept, T, T_best)
    s_base = tuple(_where(accept, x, y) for x, y in zip(s, s_best))
    err_base = torch.where(accept, err, error)
    lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e3)
    delta = solve(s_base, lam_next)
    ok = torch.isfinite(delta).all(-1)
    T_next = _where(ok, _apply_delta(T_base, delta), T_base)
    small = torch.linalg.vector_norm(delta, dim=-1) < eps
    done_next = (accept & small) | (lam_next > 500.0) | ~ok
    # The inlier count of the best pose, not of a rejected candidate.
    n_next = torch.where(accept, n_valid, n_inlier)
    if affine:
        ab_base = _where(accept, ab, ab_best)
        ab_next = _where(ok, ab_base + delta[:, 6:], ab_base)
        ab = _where(active, ab_next, ab)
        ab_best = _where(active, ab_base, ab_best)
    return LMLoop(
        T=_where(active, T_next, T), ab=ab, T_best=_where(active, T_base, T_best),
        ab_best=ab_best, s_best=tuple(_where(active, x, y) for x, y in zip(s_base, s_best)),
        error=torch.where(active, err_base, error), lam=torch.where(active, lam_next, lam),
        k=k + active.long(), done=torch.where(active, done_next, done),
        n_inlier=torch.where(active, n_next, n_inlier))


def _lm_loop(
    T0: torch.Tensor,
    ab0: torch.Tensor,
    first: tuple,
    evaluate: Callable,
    solve: Callable,
    max_iters: int,
    eps: float,
    init_lambda: float,
    affine: bool,
) -> LMLoop:
    """Deferred-evaluation LM shared by FC and IC, fused and not: `lm_start`,
    then `max_iters` times the candidate's evaluation (`evaluate(T, ab) ->
    (error (B,), valid count (B,), state)`, `first` at (T0, ab0)) and
    `lm_step`. A fixed loop: finished pairs keep their state.

    `state` is a tuple of tensors with the pair dimension first, whatever
    the solve needs (`_plain_steps`, `_fused_steps`); the loop only selects
    between the candidate's and the best one's per pair. The brightness
    (a, b) is carried only when `affine`; otherwise it stays `ab0`."""
    loop = lm_start(T0, ab0, first, solve, init_lambda, affine)
    for _ in range(max_iters):
        loop = lm_step(loop, evaluate(loop.T, loop.ab), solve, max_iters, eps, affine)
    return loop


def _kernel_loop(evaluator: LMEvaluator, T0, ab0, max_iters: int, eps: float,
                 init_lambda: float) -> LMLoop:
    """`_lm_loop` of the fused steps on a card: the first evaluation and
    `lm_step_init`, then per iteration one `lm_evaluate` and one `lm_step`
    launch on the level's state buffers, updated in place."""
    affine = evaluator.affine

    def evaluate(T, ab):
        return evaluator(T, ab) if affine else evaluator(T)

    loop = cuda_lm.lm_step_init(evaluate(T0, ab0), T0, ab0, init_lambda, affine)
    for _ in range(max_iters):
        cuda_lm.lm_step(loop, evaluate(loop.T, loop.ab), max_iters, eps)
    return loop


def _intensity_residual(sampler, pts, ref_intensity, T, ab=None):
    """r = I_tgt - I_ref (0 where invalid), or with the brightness ab (B, 2)
    the affine residual r - a I_ref - b, and validity at the points warped
    by T, through a K2 sampler bound to the target's intensity plane."""
    vals, ok = sampler(T)                                     # K2, C = 1
    valid = pts.valid & ok
    r = torch.where(valid, vals[:, 0] - ref_intensity, 0.0)
    if ab is not None:
        r = _affine_residual(r, ref_intensity, ab, valid)
    return r, valid


def _run_level(T0, ab0, residuals, intensity_residual, make_evaluator, J_const,
               max_iters, eps, weight_kind, init_lambda, affine,
               keep_residuals) -> LMState:
    """One level's LM. The first evaluation gives the level's scale sigma0
    (a median, so it needs every residual). Where the weight kind allows,
    that is `intensity_residual(T, ab) -> (r, valid)` (the affine residual
    at (T0, ab0) when affine, ab None otherwise) and the iterations run
    fused (`make_evaluator(sigma0) -> LMEvaluator`; on a card each update
    is one `lm_step` launch); else everything runs on `residuals(T, ab) ->
    (r, J or None, valid)`. The level is counted in `LM_LEVELS` by the
    path its updates take."""
    fused = weight_kind in FUSED_KINDS
    on_kernel = fused and T0.device.type == "cuda"
    LM_LEVELS["lm_kernel_levels" if on_kernel else "lm_plain_levels"] += 1
    if fused:
        ab = ab0 if affine else None
        sigma0 = mad_sigma(*intensity_residual(T0, ab))
        evaluator = make_evaluator(sigma0)
        if on_kernel:
            loop = _kernel_loop(evaluator, T0, ab0, max_iters, eps, init_lambda)
        else:
            loop = _lm_loop(T0, ab0, *_fused_steps(evaluator, T0, ab), max_iters, eps,
                            init_lambda, affine)
    else:
        first = residuals(T0, ab0)
        sigma0 = mad_sigma(first[0], first[2])
        loop = _lm_loop(T0, ab0, *_plain_steps(residuals, first, sigma0, weight_kind, J_const),
                        max_iters, eps, init_lambda, affine)
    common = dict(T=loop.T_best, error=loop.error, lam=loop.lam, k=loop.k, done=loop.done,
                  n_inlier=loop.n_inlier, ab=loop.ab_best)
    if not fused:
        r, valid = loop.s_best[:2]
        J = loop.s_best[2] if len(loop.s_best) == 3 else J_const
        return LMState(r_best=r, J=J, valid_best=valid, abs_r=torch.abs(r).sum(-1),
                       **common)
    abs_r = loop.s_best[0][:, lm_layout(affine).abs_r]
    if not keep_residuals:
        return LMState(r_best=None, J=J_const, valid_best=None, abs_r=abs_r, **common)
    r, J, valid = residuals(loop.T_best, loop.ab_best)
    return LMState(r_best=r, J=J_const if J is None else J, valid_best=valid,
                   abs_r=abs_r, **common)


def _ab0(T0: torch.Tensor, ab0: torch.Tensor | None) -> torch.Tensor:
    if ab0 is not None:
        return ab0.contiguous()
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
    keep_residuals: bool = True,
) -> LMState:
    """Forward-compositional LM at one pyramid level for B pairs.

    T0 (B, 4, 4); pts at this level's pixel scale; ref_intensity (B, N);
    the target level's image and gradients (B, H, W), packed once per level
    as texels. Each iteration samples all three target channels at the
    warped points and rebuilds the Jacobian there: in one `lm_evaluate`
    launch with Huber weights or none, through K2 (C = 3) and plain
    operations with Tukey weights. affine=True estimates (a, b) jointly:
    the state becomes [xi, a, b] with the two constant columns (-I_ref, -1),
    in the same one launch. Returns the best accepted state (`T`, `ab`);
    `r_best`, `J` and `valid_best` at that state cost one more evaluation on
    the fused path and are None with keep_residuals=False."""
    texels = pack_texels(image, grad_x, grad_y)
    sampler = WarpSampler(texels, pts.p3d, cam, texels=True)
    plane = WarpSampler(image[:, None], pts.p3d, cam)

    def residuals(T, ab):
        r, J, valid = _residuals_sampled(T, pts, ref_intensity, sampler, cam)
        if affine:
            r = _affine_residual(r, ref_intensity, ab, valid)
            J = torch.cat([J, _affine_columns(ref_intensity, valid)], dim=-1)
        return r, J, valid

    def intensity_residual(T, ab):
        return _intensity_residual(plane, pts, ref_intensity, T, ab)

    def make_evaluator(sigma0):
        return LMEvaluator(texels, pts.p3d, ref_intensity, pts.valid, sigma0, cam,
                           weight_kind, affine=affine)

    return _run_level(T0, _ab0(T0, ab0), residuals, intensity_residual, make_evaluator,
                      None, max_iters, eps, weight_kind, init_lambda, affine,
                      keep_residuals)


def ic_jacobian(pts: TrackPoints, ref_grad_x, ref_grad_y, cam) -> torch.Tensor:
    """The constant inverse-compositional Jacobian (B, N, 6), [v, w] order,
    from the reference gradients (B, N) at the identity warp; 0 where the
    point is invalid."""
    Jp = cam.project_jacobian(pts.p3d)                        # (B, N, 2, 3)
    g = ref_grad_x[..., None] * Jp[..., 0, :] + ref_grad_y[..., None] * Jp[..., 1, :]
    Jw = torch.einsum("bnj,bnjk->bnk", g, -so3.hat(pts.p3d))
    return torch.where(pts.valid[..., None], torch.cat([g, Jw], dim=-1), 0.0)


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
    keep_residuals: bool = True,
) -> LMState:
    """Inverse-compositional LM at one pyramid level for B pairs.

    T0 (B, 4, 4); pts at this level's pixel scale; ref_intensity and the
    reference gradients sampled per point, (B, N); image the target level
    (B, H, W). The Jacobian is built once from the reference gradients at
    the identity warp (with the constant affine columns when affine=True,
    which `lm_evaluate` appends itself); each iteration samples only the
    target intensity: in one `lm_evaluate` launch with Huber weights or
    none, through K2 (C = 1) and plain operations with Tukey weights. The
    returned `J` is that constant Jacobian; `r_best` and `valid_best` cost
    one more K2 call on the fused path and are None with
    keep_residuals=False."""
    valid_pts = pts.valid
    J = J6 = ic_jacobian(pts, ref_grad_x, ref_grad_y, cam)
    if affine:
        J = torch.cat([J, _affine_columns(ref_intensity, valid_pts)], dim=-1)
    plane = WarpSampler(image[:, None], pts.p3d, cam)

    def intensity_residual(T, ab):
        return _intensity_residual(plane, pts, ref_intensity, T, ab)

    def residuals(T, ab):
        r, valid = intensity_residual(T, ab if affine else None)
        return r, None, valid

    def make_evaluator(sigma0):
        return LMEvaluator(image, pts.p3d, ref_intensity, valid_pts, sigma0, cam,
                           weight_kind, J_ref=J6, affine=affine)

    return _run_level(T0, _ab0(T0, ab0), residuals, intensity_residual, make_evaluator,
                      J, max_iters, eps, weight_kind, init_lambda, affine,
                      keep_residuals)


def track(
    ref: FramePyramid,
    tgt: FramePyramid,
    pts: TrackPoints,
    cam: PinholeCamera,
    T_init: torch.Tensor | None = None,
    levels: tuple[int, ...] = (3, 2, 1, 0),
    max_iters: int | tuple[int, ...] = 10,
    weight_kind: WeightKind = WeightKind.HUBER,
    mode: str = "fc",
    affine: bool = False,
) -> TrackResult:
    """Coarse-to-fine tracking of B pairs -> TrackResult with T (B, 4, 4)
    mapping reference to target coordinates.

    `pts` are level-0 selections in the reference frames. mode "fc"
    (forward-compositional: target gradients at the warped points) samples
    the reference intensity at uv * 2^-l with kernel K3 (C = 1); mode "ic"
    (constant reference Jacobian) samples intensity and both gradients in
    one K3 call on the level's texels (C = 3). Level 0 uses the values carried from selection when
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
            texels = pack_texels(ref.images[lvl], ref.grad_x[lvl], ref.grad_y[lvl])
            vals, ref_ok = cuda_bilinear_sample(texels, uv_l, texels=True)
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
                keep_residuals=False,
            )
        else:
            out = lm_level(
                T, pts_l, ref_int, tgt.images[lvl], tgt.grad_x[lvl],
                tgt.grad_y[lvl], cam_l, max_iters=lvl_iters,
                weight_kind=weight_kind, affine=affine, ab0=ab,
                keep_residuals=False,
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
    e_final = out.abs_r / torch.clamp(out.n_inlier, min=1)
    jumped = e_final > e_init * 1.05
    return TrackResult(
        T=_where(jumped, T_start, T),
        error=torch.where(jumped, e_init, out.error),
        iterations=total_iters,
        inliers=torch.where(jumped, valid_g.sum(-1), out.n_inlier),
        converged=(out.done | (out.error < 1e3)) & ~jumped,
        affine=ab,
    )
