"""Trajectory I/O and evaluation.

Counterpart of `uwslam_tpu.io.trajectory`: ground-truth readers after
uw-slam's Visualizer (TUM: 3 header lines, space-separated
`ts tx ty tz qx qy qz qw`; EUROC: 1 header line, comma-separated
`ts px py pz qw qx qy qz` with ns timestamps, src/Visualizer.cpp:449-505),
TUM-format trajectory files, nearest-timestamp association, and the
Umeyama alignment and ATE RMSE in float64 numpy.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..lie import se3


def read_groundtruth_tum(path: str, skip_lines: int = 3) -> np.ndarray:
    """TUM groundtruth.txt -> (N, 8) [ts, tx, ty, tz, qx, qy, qz, qw]."""
    rows = []
    with open(path) as f:
        for _ in range(skip_lines):
            f.readline()
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 8 and not line.startswith("#"):
                rows.append([float(x) for x in parts[:8]])
    return np.asarray(rows, dtype=np.float64)


def read_groundtruth_euroc(path: str) -> np.ndarray:
    """EUROC state_groundtruth_estimate0/data.csv -> (N, 8)
    [ts_sec, px, py, pz, qw, qx, qy, qz]."""
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 8:
                rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows, dtype=np.float64)
    if len(arr):
        arr[:, 0] *= 1e-9
    return arr


def poses_from_tum_rows(rows: np.ndarray) -> np.ndarray:
    """(N, 8) TUM rows -> (N, 4, 4) float32 world <- camera."""
    q_wxyz = np.concatenate([rows[:, 7:8], rows[:, 4:7]], axis=1).astype(np.float32)
    T = se3.from_quaternion_translation(
        torch.from_numpy(q_wxyz), torch.from_numpy(rows[:, 1:4].astype(np.float32))
    )
    return T.numpy()


def poses_from_euroc_rows(rows: np.ndarray) -> np.ndarray:
    """(N, 8) EUROC rows (t, tx ty tz, qw qx qy qz) -> (N, 4, 4) float32."""
    T = se3.from_quaternion_translation(
        torch.from_numpy(rows[:, 4:8].astype(np.float32)),
        torch.from_numpy(rows[:, 1:4].astype(np.float32)),
    )
    return T.numpy()


def write_trajectory_tum(path: str, timestamps, poses) -> None:
    """Write (N, 4, 4) world <- camera poses as `ts tx ty tz qx qy qz qw`."""
    T = torch.from_numpy(np.asarray(poses, dtype=np.float32))
    q, t = (x.numpy() for x in se3.to_quaternion_translation(T))
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(T)):
            ts = timestamps[i] if timestamps is not None else float(i)
            f.write(
                f"{ts:.6f} {t[i,0]:.6f} {t[i,1]:.6f} {t[i,2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )


def read_trajectory_tum(path: str):
    """A TUM-format trajectory ('#' comments and short rows skipped) ->
    (timestamps (N,), poses (N, 4, 4))."""
    rows = []
    with open(path) as f:
        for ln in f:
            parts = ln.strip().split()
            if not parts or parts[0].startswith("#") or len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    data = np.asarray(rows, np.float64)
    if data.size == 0:
        return np.zeros((0,)), np.zeros((0, 4, 4), np.float32)
    return data[:, 0], poses_from_tum_rows(data)


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association of sorted ts_b to ts_a -> (idx_a, idx_b)
    pairs within max_dt."""
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best = None
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(ts_b):
                dt = abs(ts_b[k] - t)
                if best is None or dt < best[1]:
                    best = (k, dt)
        if best is not None and best[1] <= max_dt:
            ia.append(i)
            ib.append(best[0])
    return np.asarray(ia, int), np.asarray(ib, int)


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


# The count of non-finite pose pairs the last `ate_rmse` call dropped, and
# of all its pairs: a machine-readable record beside the stderr warning.
ate_last_dropped = {"dropped": 0, "total": 0}


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
    with_scale: bool = True,
) -> float:
    """Absolute trajectory error RMSE after (optional) Sim(3) alignment.
    Non-finite positions are dropped with a warning on stderr, and counted in
    `ate_last_dropped`."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shape mismatch: {est.shape} vs {gt.shape}")
    finite = np.isfinite(est).all(axis=1) & np.isfinite(gt).all(axis=1)
    ate_last_dropped["dropped"] = int((~finite).sum())
    ate_last_dropped["total"] = int(len(est))
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


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over every pair `delta` frames apart ->
    (translation RMSE, rotation RMSE in radians)."""
    est, gt = np.asarray(est_poses), np.asarray(gt_poses)
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
