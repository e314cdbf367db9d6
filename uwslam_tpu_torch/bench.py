"""Headline benchmark of the port: tracked frames/s of the offline IC chunk,
and window-BA LM iterations/s beside it.

`python -m uwslam_tpu_torch.bench` prints one JSON line with
`tracked_frames_per_sec`, the chunk's `ate` (m, Sim(3)-aligned),
`ba_iters_per_sec` and the card's name and power limit. It runs on one CUDA
card and exits non-zero without one.

The workload is the repo's `bench.py` design point (TUM camera): 96
synthetic 640 x 480 frames of the seed-0 textured plane at z = 2, seen from
poses on a smooth sinusoidal twist of period 24; 2048 points per frame, a
5-level pyramid, track levels (3, 2, 1, 0) with (12, 8, 5, 3) LM iterations,
monocular depth 2. Frames are rendered on the card; rendering, the kernel
build and one warm-up chunk are excluded from the timing. Each of 10
back-to-back chunks (pyramid, selection and tracking of every pair) is
timed with CUDA events; the headline is the median chunk.

The second figure is the repo's `bench.py` window design point: 10 keyframes
x 1024 landmarks, fully connected (10,240 observations, 0.3 px noise, poses
perturbed by 0.01), `bundle_adjust(max_iters=25)`. The problem is made from
a numpy seed (`BA_SEED`), not from the JAX package's PRNG, so its numbers
are another draw of the same distribution. The figure divides the LM
iterations the solve counted by the time of one solve (CUDA events), for the
solve as a replayed CUDA graph and for the eager call; the solve executes
`lm_passes(25)` passes of work whatever it counts (a fixed loop with a
`done` mask, see `ba.schur`), and the JSON line carries both counts.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess

import numpy as np
import torch

from .ba.schur import BAProblem, bundle_adjust, lm_passes
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
BA_KEYFRAMES = 10
BA_LANDMARKS = 1024
BA_MAX_ITERS = 25
BA_SEED = 7


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


def ba_bench_problem(device, seed: int = BA_SEED):
    """The window design point -> (BAProblem on `device`, true T_cw
    (M, 4, 4)): landmarks uniform in a box 2 to 5 m ahead, keyframes on a
    slow drift, every landmark observed in every keyframe with 0.3 px noise,
    initial poses (but the first) perturbed by 0.01 in the twist."""
    rng = np.random.default_rng(seed)
    M, L = BA_KEYFRAMES, BA_LANDMARKS
    pts = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.0, 1.0, L),
                    rng.uniform(2.0, 5.0, L)], axis=-1).astype(np.float32)
    noise = (0.3 * rng.standard_normal((M * L, 2))).astype(np.float32)
    dT = (0.01 * rng.standard_normal((M, 6))).astype(np.float32)
    dT[0] = 0.0
    i = torch.arange(M, dtype=torch.float32)[:, None]
    T_gt = se3.exp(i * torch.tensor([0.04, 0.015, 0.008, 0.0, 0.01, 0.0]))
    kf = torch.arange(M).repeat_interleave(L)
    lm = torch.arange(L).repeat(M)
    p_c = se3.apply(T_gt[kf], torch.from_numpy(pts)[lm])
    uv = CAM.project(p_c) + torch.from_numpy(noise)
    valid = (
        (uv[:, 0] >= 0) & (uv[:, 0] <= CAM.width - 1)
        & (uv[:, 1] >= 0) & (uv[:, 1] <= CAM.height - 1) & (p_c[:, 2] > 0.1)
    )
    T_init = se3.compose(se3.exp(torch.from_numpy(dT)), T_gt)
    problem = BAProblem(T_cw=T_init, points=torch.from_numpy(pts), obs_kf=kf, obs_lm=lm,
                        obs_uv=uv, obs_valid=valid)
    return BAProblem(*(t.to(device) for t in problem)), T_gt.to(device)


def _timed_ms(fn, device) -> float:
    """Device-side ms of one call of fn between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def bench_ba_iters(device) -> dict:
    """Window-BA LM iterations per second at the design point. Two forms of
    the same solve, each timed on its second call between CUDA events: the
    solve captured into a CUDA graph and replayed, which is how the live
    loop dispatches it (`ba_iters_per_sec`), and the eager call, whose ~11,000
    small launches the host issues one by one (`ba_iters_per_sec_eager`)."""
    from .ops.graph import CapturedStep

    problem, _ = ba_bench_problem(device)

    def solve(*fields):
        out = bundle_adjust(BAProblem(*fields), CAM, max_iters=BA_MAX_ITERS)
        return out.iterations, out.initial_cost, out.cost

    solve(*problem)                                               # warm up
    eager_ms = _timed_ms(lambda: solve(*problem), device)
    step = CapturedStep(solve, tuple(problem))
    step(*problem)
    replay_ms = _timed_ms(lambda: step(*problem), device)
    iterations, c0, c = step(*problem)
    iters = int(iterations)
    return {
        "ba_iters_per_sec": iters / max(replay_ms / 1e3, 1e-9),
        "ba_iters_per_sec_eager": iters / max(eager_ms / 1e3, 1e-9),
        "ba_iterations": iters,
        "ba_passes_executed": lm_passes(BA_MAX_ITERS),
        "ba_solve_ms": replay_ms,
        "ba_solve_ms_eager": eager_ms,
        "ba_cost": [float(c0), float(c)],
    }


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
        **bench_ba_iters(dev),
        "device": torch.cuda.get_device_name(dev),
        "gpu": gpu_identity(),
    }))


if __name__ == "__main__":
    main()
