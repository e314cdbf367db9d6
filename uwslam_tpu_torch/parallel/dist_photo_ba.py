"""Distributed photometric window BA: the observer keyframes sharded.

Counterpart of `uwslam_tpu.parallel.dist_photo_ba`. The observation
lattice (owner i, observer j, point n) is data-parallel in the observer
axis: a shard holds K / D observers' images (the large arrays: a
10-keyframe window at 240 x 320 is 12.3 MB of texels) and computes their
residuals and Jacobians; the owners' points, pixels, inverse depths and
intensities are small and replicated. Per LM evaluation the normal
equations (Hpp, bp, Hpd, Hdd, bd) and the cost's numerator and
denominator are summed over shards; the Schur solve and the accept test
run replicated, so every shard holds the same iterate without further
communication.

Shards are a leading axis of this process (`runtime.ShardLayout`), summed
in a fixed pairwise tree and then, with more than one process, by one
`torch.distributed.all_reduce` (`dist_ba._psum`): two processes of two
shards give the bits of one process of four. A shard's observations are
`ba.photometric._observations` with `observer_idx` (kernel K3, one launch
per shard and evaluation, on the shard's texels); they enter the normal
equations of `ba.photometric` at their observers' columns, zero elsewhere.

The solve is the JAX package's, not `photometric_bundle_adjust`'s
keyframe mask: no `active`, lambda within [1e-8, 1e4], a stop at lambda >
1e3 or a relative cost change below 1e-7, `max_iters` 12 by default. The
`while_loop` is a loop of `max_iters` passes with a `done` mask and nothing
is read on the host, so a world of one process can capture a solve in a
CUDA graph (`ops.graph.CapturedStep`).
"""
from __future__ import annotations

import torch

from ..ba.photometric import (
    PhotoBAProblem,
    PhotoBAResult,
    _huber_w,
    _levenberg_marquardt,
    _normal_equations,
    _observations,
)
from ..camera.model import PinholeCamera
from ..ops.cuda_sample import pack_texels
from .dist_ba import _psum
from .runtime import ShardLayout

PHOTO_AXIS = "obs"


def _huber_sums(r, valid, delta: float):
    """(sum of Huber rho over the valid observations, their count)."""
    a = torch.abs(r)
    rho = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return torch.where(valid, rho, 0.0).sum(), valid.sum().to(r.dtype)


def _at_columns(x: torch.Tensor, observer_idx: torch.Tensor, K: int) -> torch.Tensor:
    """(K, Kj, ...) observations -> (K, K, ...) with zeros at the observers
    this shard does not hold."""
    out = x.new_zeros((x.shape[0], K) + tuple(x.shape[2:]))
    return out.index_copy(1, observer_idx, x)


def distributed_photometric_ba(
    problem: PhotoBAProblem,
    cam: PinholeCamera,
    layout: ShardLayout,
    max_iters: int = 12,
    huber_delta: float = 12.0,
    pose0_weight: float = 1e8,
    depth_prior: float = 1e-2,
    init_lambda: float = 1e-3,
    optimize_depths: bool = True,
) -> PhotoBAResult:
    """`photometric_bundle_adjust` with the K observers split over the
    `layout.total` shards (shard s holds observers [s K/D, (s+1) K/D)).
    Every process passes the whole problem and receives the whole result.
    K must divide by the shard count (pad with keyframes whose points are
    invalid)."""
    K, N = problem.inv_depth.shape
    D = layout.total
    if K % D:
        raise ValueError(f"window size {K} must divide over the {D} shards of '{PHOTO_AXIS}'")
    Kj = K // D
    dev = problem.inv_depth.device
    observers = [torch.arange(s * Kj, (s + 1) * Kj, device=dev) for s in layout.shards]
    texels = [pack_texels(*(x.index_select(0, idx)
                            for x in (problem.images, problem.grad_x, problem.grad_y)))
              for idx in observers]

    def observations(T_cw, inv_depth, jacobians: bool):
        p = problem._replace(T_cw=T_cw, inv_depth=inv_depth)
        return [_observations(p, cam, tex, jacobians=jacobians, observer_idx=idx)
                for tex, idx in zip(texels, observers)]

    def cost_at(T_cw, inv_depth):
        sums = [_huber_sums(r, valid, huber_delta)
                for r, valid in observations(T_cw, inv_depth, jacobians=False)]
        num = _psum(torch.stack([s[0] for s in sums]), layout)
        den = _psum(torch.stack([s[1] for s in sums]), layout)
        return num / torch.clamp(den, min=1.0)

    def equations_at(T_cw, inv_depth):
        per_shard = []
        for (r, A, B, Jd, valid), idx in zip(observations(T_cw, inv_depth, True), observers):
            w = _huber_w(r, valid, huber_delta)
            per_shard.append(_normal_equations(
                *(_at_columns(x, idx, K) for x in (r, A, B, Jd, w))))
        return tuple(_psum(torch.stack(parts), layout) for parts in zip(*per_shard))

    return _levenberg_marquardt(problem.T_cw, problem.inv_depth, cost_at, equations_at,
                                max_iters, init_lambda, pose0_weight, depth_prior,
                                optimize_depths)
