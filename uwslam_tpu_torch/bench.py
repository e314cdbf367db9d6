"""Headline benchmark of the port: tracked frames/s of the offline IC chunk.

`python -m uwslam_tpu_torch.bench` prints one JSON line with
`tracked_frames_per_sec`, the chunk's `ate` (m, Sim(3)-aligned) and the
card's name and power limit. It runs on one CUDA card and exits non-zero
without one.

The workload is the repo's `bench.py` design point (TUM camera): 96
synthetic 640 x 480 frames of the seed-0 textured plane at z = 2, seen from
poses on a smooth sinusoidal twist of period 24; 2048 points per frame, a
5-level pyramid, track levels (3, 2, 1, 0) with (12, 8, 5, 3) LM iterations,
monocular depth 2. Frames are rendered on the card; rendering, the kernel
build and one warm-up chunk are excluded from the timing. Each of 10
back-to-back chunks (pyramid, selection and tracking of every pair) is
timed with CUDA events; the headline is the median chunk.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess

import torch

from .camera.model import PinholeCamera
from .io.trajectory import ate_rmse
from .lie import se3
from .tracking.sequence import SequenceTracker, compose_trajectory
from .utils.synthetic import render_plane_view

CAM = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
PLANE_Z = 2.0
NUM_FRAMES = 96
TWIST_AMP = (0.06, 0.024, 0.008, 0.004, -0.006, 0.008)
TWIST_PERIOD = 24
LEVELS = 5
TRACK_LEVELS = (3, 2, 1, 0)
ITERS = (12, 8, 5, 3)
NUM_POINTS = 2048
MONO_Z = 2.0
RUNS = 10   # timed chunks


def bench_poses(num_frames: int = NUM_FRAMES, device="cuda") -> torch.Tensor:
    """Camera-from-world poses (num_frames, 4, 4): twist amp * sin(2 pi i / 24)."""
    amp = torch.tensor(TWIST_AMP, dtype=torch.float32, device=device)
    twists = torch.stack([
        amp * math.sin(2.0 * math.pi * i / TWIST_PERIOD) for i in range(num_frames)
    ])
    return se3.exp(twists)


def bench_frames(poses: torch.Tensor, cam: PinholeCamera = CAM) -> torch.Tensor:
    return render_plane_view(cam, poses, PLANE_Z)


def make_tracker(cam: PinholeCamera = CAM) -> SequenceTracker:
    return SequenceTracker(
        cam, levels=LEVELS, track_levels=TRACK_LEVELS, num_points=NUM_POINTS,
        max_iters=ITERS, mode="ic",
    )


def trajectory_ate(T_rel: torch.Tensor, poses: torch.Tensor) -> float:
    """ATE (m) of the composed relative poses against the rendered poses."""
    est = compose_trajectory(T_rel.cpu())
    gt = se3.inverse(poses.cpu())
    return ate_rmse(est[:, :3, 3].numpy(), gt[:, :3, 3].numpy())


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_chunks(tracker: SequenceTracker, frames: torch.Tensor, runs: int) -> list[float]:
    """Seconds of each of `runs` back-to-back chunks (CUDA events around each)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for ev in events[1:]:
        tracker(frames, mono_z=MONO_Z)
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("uwslam_tpu_torch.bench needs a CUDA card; none is visible")
    dev = torch.device("cuda", 0)
    poses = bench_poses(device=dev)
    frames = bench_frames(poses)
    tracker = make_tracker()
    T_rel, _, _ = tracker(frames, mono_z=MONO_Z)  # builds the kernels, warms up
    ate = trajectory_ate(T_rel, poses)
    chunk_s = sorted(time_chunks(tracker, frames, RUNS))
    median = statistics.median(chunk_s)
    print(json.dumps({
        "metric": "tracked_frames_per_sec",
        "value": (NUM_FRAMES - 1) / median,
        "unit": "frames/s",
        "ate": ate,
        "chunk_ms_median": median * 1e3,
        "chunk_ms_min": chunk_s[0] * 1e3,
        "chunk_ms_max": chunk_s[-1] * 1e3,
        "runs": RUNS,
        "device": torch.cuda.get_device_name(dev),
        "gpu": gpu_identity(),
    }))


if __name__ == "__main__":
    main()
