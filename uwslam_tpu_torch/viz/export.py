"""Files a viewer opens without subscribing to anything, in place of
uw-slam's Rviz markers (src/Visualizer.cpp): a PLY point cloud of the map,
an SVG or HTML overlay of the estimated and true trajectories seen from
above, and an append-only JSONL stream of poses for live viewers.

Counterpart of `uwslam_tpu.viz.export`: host numpy, and from the same
input every function writes the same bytes as the JAX package's.
"""
from __future__ import annotations

import json

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write an ASCII PLY point cloud: points (N, 3), colors (N, 3) uint8."""
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def trajectory_svg(
    est_positions: np.ndarray,
    gt_positions: np.ndarray | None = None,
    width: int = 800,
    height: int = 600,
) -> str:
    """Top-down (x, z) SVG of the estimated (red) and, when given, true
    (green) camera positions (N, 3)."""
    est = np.asarray(est_positions)
    allp = est if gt_positions is None else np.concatenate([est, gt_positions])
    lo = allp.min(0) - 1e-6
    hi = allp.max(0) + 1e-6
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        x = (p[:, 0] - lo[0]) / span[0] * (width - 40) + 20
        y = height - ((p[:, 2] - lo[2]) / span[2] * (height - 40) + 20)
        return x, y

    def polyline(p, color):
        x, y = to_px(p)
        pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(x, y))
        return (f'<polyline points="{pts}" fill="none" stroke="{color}" '
                'stroke-width="2"/>')

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" style="background:#fff">',
        polyline(est, "#d62728"),
    ]
    if gt_positions is not None:
        parts.append(polyline(np.asarray(gt_positions), "#2ca02c"))
        parts.append('<text x="20" y="20" fill="#2ca02c">ground truth</text>')
    parts.append('<text x="20" y="40" fill="#d62728">estimate</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def write_trajectory_html(path: str, est_positions: np.ndarray,
                          gt_positions: np.ndarray | None = None):
    """A self-contained HTML page holding `trajectory_svg`."""
    svg = trajectory_svg(est_positions, gt_positions)
    with open(path, "w") as f:
        f.write(f"<!doctype html><title>uwslam-tpu trajectory</title>{svg}")


class EventStream:
    """Append-only JSONL stream of poses and diagnostics for external live
    viewers: one JSON object per line, written through at each line."""

    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)

    def emit(self, kind: str, **payload):
        rec = {"kind": kind}
        for k, v in payload.items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def emit_pose(self, frame_id: int, timestamp: float, T_wc: np.ndarray):
        self.emit("pose", frame_id=frame_id, timestamp=timestamp, T_wc=np.asarray(T_wc))

    def close(self):
        self._f.close()
