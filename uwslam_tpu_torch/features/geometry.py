"""Two-view geometry: essential decomposition, pose recovery, triangulation.

Counterpart of `uwslam_tpu.features.geometry` (uw-slam's essential-matrix
prototype, src/feature_detector.cpp:262-281: findEssentialMat ->
recoverPose -> triangulatePoints), batched over correspondences.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import se3
from ..utils.linalg import cholesky_solve_unrolled, svd3_jacobi


def _proper(M: torch.Tensor) -> torch.Tensor:
    """M with its sign flipped where det(M) < 0."""
    return M * torch.sign(torch.linalg.det(M))[..., None, None]


def _w_matrix(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def decompose_essential(E: torch.Tensor):
    """E -> the four candidate (R, t) pairs; t has unit norm (monocular
    scale)."""
    U, _, Vt = svd3_jacobi(E)
    U, Vt = _proper(U), _proper(Vt)
    W = _w_matrix(E)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def triangulate_linear(T_a: torch.Tensor, T_b: torch.Tensor, xy_a: torch.Tensor,
                       xy_b: torch.Tensor) -> torch.Tensor:
    """DLT triangulation in normalized camera coordinates: T_a, T_b (4, 4)
    world -> camera, xy (K, 2) -> (K, 3) world points
    (cv::triangulatePoints, uw-slam src/feature_detector.cpp:276-281).

    The inhomogeneous form (the JAX package's accelerator branch), on every
    device: X = [x, y, z, 1] and the 3x3 normal equations solved by the
    unrolled Cholesky with a ridge. No library call, so a captured graph
    holds it. A point at infinity makes the system singular; the ridge
    turns it into a huge depth that the callers' depth gates reject."""
    Pa, Pb = T_a[:3, :], T_b[:3, :]
    rows = torch.stack(
        [
            xy_a[:, 0:1] * Pa[2] - Pa[0],
            xy_a[:, 1:2] * Pa[2] - Pa[1],
            xy_b[:, 0:1] * Pb[2] - Pb[0],
            xy_b[:, 1:2] * Pb[2] - Pb[1],
        ],
        dim=1,
    )                                                          # (K, 4, 4)
    A3, b3 = rows[..., :3], rows[..., 3]
    AtA = torch.matmul(A3.transpose(-1, -2), A3)
    Atb = torch.matmul(A3.transpose(-1, -2), b3[..., None])[..., 0]
    ridge = 1e-9 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) + 1e-12
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return cholesky_solve_unrolled(AtA + ridge[:, None, None] * eye, -Atb)


class RecoveredPose(NamedTuple):
    T: torch.Tensor           # (4, 4) b <- a with unit translation
    points: torch.Tensor      # (K, 3) triangulated points in frame a
    cheirality: torch.Tensor  # (K,) bool: in front of both cameras
    num_good: torch.Tensor


def recover_pose(E: torch.Tensor, xy_a: torch.Tensor, xy_b: torch.Tensor,
                 valid: torch.Tensor) -> RecoveredPose:
    """The (R, t) candidate with the best cheirality vote (cv::recoverPose,
    uw-slam src/feature_detector.cpp:266-269); ties go to the first."""
    T_a = torch.eye(4, dtype=E.dtype, device=E.device)
    Ts, Ps, Gs = [], [], []
    for R, t in decompose_essential(E):
        T_b = se3.from_rotation_translation(R, t)
        pts = triangulate_linear(T_a, T_b, xy_a, xy_b)
        z_b = se3.apply(T_b, pts)[:, 2]
        Ts.append(T_b)
        Ps.append(pts)
        Gs.append(valid & (pts[:, 2] > 1e-4) & (z_b > 1e-4))
    Gs = torch.stack(Gs)
    scores = Gs.sum(-1)
    # argmax with ties to the lowest index, as jnp.argmax.
    best = torch.sort(-scores, stable=True).indices[:1]

    def pick(x):
        return x.index_select(0, best)[0]     # no host read of the index

    return RecoveredPose(T=pick(torch.stack(Ts)), points=pick(torch.stack(Ps)),
                         cheirality=pick(Gs), num_good=pick(scores))
