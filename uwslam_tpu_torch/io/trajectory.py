"""Trajectory evaluation: Umeyama alignment and ATE RMSE, in float64 numpy.

Counterpart of `umeyama_alignment` and `ate_rmse` in
`uwslam_tpu.io.trajectory`.
"""
from __future__ import annotations

import sys

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ~ s R src + t for (N, 3)
    point sets -> (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
    with_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE after (optional) Sim(3) alignment.
    Non-finite positions are dropped with a warning on stderr."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shape mismatch: {est.shape} vs {gt.shape}")
    finite = np.isfinite(est).all(axis=1) & np.isfinite(gt).all(axis=1)
    if not finite.all():
        print(
            f"WARNING: ate_rmse dropping {int((~finite).sum())}/{len(est)} "
            "non-finite pose pairs",
            file=sys.stderr,
        )
        est, gt = est[finite], gt[finite]
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
