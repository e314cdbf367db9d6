"""Smoke test of the PyTorch/CUDA port (uwslam_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python chip_smoke.py`. It needs no network and no arguments, and
exits non-zero, printing no result, when no card is visible or any phase
fails. Phases, one line each:

1. The card's name and power limit (nvidia-smi).
2. Build the kernels from uwslam_tpu_torch/csrc with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path: K1 Scharr on all 5 levels of 96 x 480 x 640; K2
   warp+sample with 95 pairs, 1 channel, 2048 points at every track level,
   including points behind the camera and on the exact right and bottom
   edges; K3 sample with 95 pairs, 3 channels, 2048 points at levels 3, 2, 1.
4. The main path: the repo's bench.py sequence (96 frames of 640 x 480)
   rendered on the card and tracked by SequenceTracker in IC mode. Every
   kernel must have launched; the trajectory's ATE must be within 1 mm; the
   same frames tracked on the CPU must give the same relative poses.
5. Timing after warm-up: frames/s of the median of 10 chunks (CUDA
   events), the device's busy time and launches in one profiled chunk, and
   each kernel against its plain version, in device time (profiler) and in
   wall time per call (CUDA events).

Then a JSON line of per-kernel results, the card's name and power limit,
and, last, `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

K1_ATOL = 1e-4       # f32 gradients of [0, 255] images
SAMPLE_ATOL = 1e-3   # K2/K3 samples of [0, 255] intensities; masks equal
T_REL_ATOL = 1e-3    # se3.log of the card's vs the CPU's relative poses
ATE_MAX = 1e-3       # m; the JAX package's f32 CPU run gives 0.000278 m
TIMING_REPS = 20
CHUNK_RUNS = 10


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def kernels_table():
    from uwslam_tpu_torch import ops

    return [
        {"name": "scharr", "wrapper": ops.scharr_gradients_batched,
         "source": "uwslam_tpu_torch/csrc/scharr.cu",
         "replaces": "uwslam_tpu/ops/pallas_pyramid.py:26"},
        {"name": "warp_sample", "wrapper": ops.warp_and_sample,
         "source": "uwslam_tpu_torch/csrc/warp_sample.cu",
         "replaces": "uwslam_tpu/ops/pallas_track.py:40"},
        {"name": "bilinear_sample", "wrapper": ops.cuda_bilinear_sample,
         "source": "uwslam_tpu_torch/csrc/warp_sample.cu",
         "replaces": "uwslam_tpu/ops/pallas_sample.py:29"},
    ]


def exact_coordinate(f: float, c: float, target: int) -> tuple[float, float]:
    """An f32 (x, z) for which the plain projection f * x / z + c is exactly
    `target` (the last pixel of a row or column)."""
    for z in (1.0, 2.0, 3.0, 0.5, 1.5, 5.0, 7.0, 0.75):
        x = torch.tensor([(target - c) / f * z], dtype=torch.float32)
        zt = torch.tensor([z], dtype=torch.float32)
        for _ in range(64):
            u = float((f * x / zt + c)[0])
            if u == target:
                return float(x[0]), z
            x = torch.nextafter(
                x, torch.tensor([torch.inf if u < target else -torch.inf])
            )
    raise RuntimeError(f"no f32 point projects exactly onto {target}")


def edge_points(cam, n: int) -> torch.Tensor:
    """n reference points (n, 3) for an identity pose: 36 on the exact right
    and bottom edges and corner, then 4 behind or at the camera, repeated."""
    W, H = cam.width, cam.height
    xr, zr = exact_coordinate(cam.fx, cam.cx, W - 1)
    yb, zb = exact_coordinate(cam.fy, cam.cy, H - 1)
    span = torch.linspace(-0.3, 0.3, 17)
    pts = [(xr, float(s) * H / cam.fy * zr, zr) for s in span]
    pts += [(float(s) * W / cam.fx * zb, yb, zb) for s in span]
    if zr == zb:
        pts.append((xr, yb, zr))
    else:
        pts.append((xr, float(span[0]) * H / cam.fy * zr, zr))
    pts += [(xr, 0.0, zr)]
    pts += [(0.0, 0.0, -1.0), (0.0, 0.0, 5e-4), (0.0, 0.0, 0.0), (0.1, 0.1, 1e-3)]
    pts = torch.tensor(pts, dtype=torch.float32)
    return pts.repeat((n + len(pts) - 1) // len(pts), 1)[:n]


def compare(kernel_out, plain_out, atol: float, what: str) -> float:
    """Max |kernel - plain| over the value tensors; masks must be equal."""
    (kv, kmask), (pv, pmask) = kernel_out, plain_out
    if not torch.equal(kmask, pmask):
        raise AssertionError(f"{what}: validity masks differ "
                             f"({int((kmask != pmask).sum())} points)")
    err = float((kv - pv).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs error {err} > {atol}")
    return err


def phase_parity(pyr, pts, cam, track_levels, seed: int = 0):
    """Kernel vs plain version on the card at the main path's shapes.
    Returns {kernel name: max abs error}."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.lie import se3

    dev = pyr.images[0].device
    err = {"scharr": 0.0, "warp_sample": 0.0, "bilinear_sample": 0.0}
    for lvl, img in enumerate(pyr.images):
        k = ops.scharr_gradients_batched(img)
        p = ops.scharr_plain(img)
        for kk, pp, nm in zip(k, p, ("gx", "gy", "gm")):
            e = float((kk - pp).abs().max())
            if not e <= K1_ATOL:
                raise AssertionError(f"scharr level {lvl} {nm}: {e} > {K1_ATOL}")
            err["scharr"] = max(err["scharr"], e)

    gen = torch.Generator().manual_seed(seed)
    B = pts.p3d.shape[0] - 1
    twists = 0.02 * torch.randn(B, 6, generator=gen)
    n_edge = 64
    T = se3.exp(twists).to(dev)
    T[: B // 4] = torch.eye(4, device=dev)   # identity pairs carry edge points
    for lvl in track_levels:
        cam_l = cam.scaled(lvl)
        p3d = pts.p3d[:-1].clone()
        p3d[: B // 4, :n_edge] = edge_points(cam_l, n_edge).to(dev)
        tgt = pyr.images[lvl][1:, None]
        k = ops.warp_and_sample(tgt, p3d, T, cam_l)
        p = ops.warp_and_sample_plain(tgt, p3d, T, cam_l)
        if not bool(p[1][: B // 4, :36].all()):
            raise AssertionError("edge points must be valid in the plain version")
        err["warp_sample"] = max(
            err["warp_sample"], compare(k, p, SAMPLE_ATOL, f"warp_sample level {lvl}")
        )
        if lvl == 0:
            continue
        uv = pts.uv[:-1] * (1.0 / (1 << lvl))
        W, H = cam_l.width, cam_l.height
        edges = torch.tensor(
            [[W - 1, 1.5], [W - 1, H - 1], [2.25, H - 1], [0.0, 0.0],
             [W - 1 + 1e-3, 3.0], [-1e-3, 3.0], [5.0, H - 1 + 1e-3],
             [float("nan"), 2.0]], device=dev,
        )
        uv[: B // 4, : len(edges)] = edges
        stack = torch.stack(
            [pyr.images[lvl][:-1], pyr.grad_x[lvl][:-1], pyr.grad_y[lvl][:-1]], dim=1
        )
        k = ops.cuda_bilinear_sample(stack, uv)
        p = ops.bilinear_sample_plain(stack, uv)
        err["bilinear_sample"] = max(
            err["bilinear_sample"],
            compare(k, p, SAMPLE_ATOL, f"bilinear_sample level {lvl}"),
        )
    return err


def phase_main_path(tracker, frames, poses, mono_z, table):
    """Track the chunk on the card with fresh launch counts; check the
    trajectory, and the CPU's run of the same frames."""
    from uwslam_tpu_torch.bench import trajectory_ate
    from uwslam_tpu_torch.lie import se3

    for k in table:
        k["wrapper"].launches = 0
    T_rel, inliers, _ = tracker(frames, mono_z=mono_z)
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    n = frames.shape[0] - 1
    if tuple(T_rel.shape) != (n, 4, 4) or not bool(torch.isfinite(T_rel).all()):
        raise AssertionError(f"bad T_rel: shape {tuple(T_rel.shape)}")
    ate = trajectory_ate(T_rel, poses)
    if not ate <= ATE_MAX:
        raise AssertionError(f"ATE {ate} m > {ATE_MAX} m")
    T_cpu, _, _ = tracker(frames.cpu(), mono_z=mono_z)
    ate_cpu = trajectory_ate(T_cpu, poses)
    dev_cpu = float((se3.log(T_rel.cpu()) - se3.log(T_cpu)).abs().max())
    if not dev_cpu <= T_REL_ATOL:
        raise AssertionError(f"card vs CPU se3.log differs by {dev_cpu} > {T_REL_ATOL}")
    return {
        "launches": launches, "ate": ate, "ate_cpu": ate_cpu,
        "card_vs_cpu": dev_cpu, "min_inliers": int(inliers.min()),
    }


def wall_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean ms per call of fn over `reps` back-to-back calls, CUDA events,
    after one warm-up call. A short kernel's host-side dispatch (checks,
    allocation, launch) can exceed its device time; then this is host time."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int = TIMING_REPS) -> tuple[float, float]:
    """(device ms, kernel launches) per call of fn: the sum of the self
    device time of every kernel the profiler saw over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not total_us > 0:
        raise RuntimeError("the profiler saw no device time")
    return total_us / 1e3 / reps, sum(e.count for e in kernels) / reps


def phase_timing(pyr, pts, cam, T_rel):
    """Kernel vs plain version at the largest shape each has on the main
    path: device ms per call (profiler) and wall ms per call (CUDA events),
    in turns kernel, plain, plain, kernel."""
    from uwslam_tpu_torch import ops

    img0 = pyr.images[0]
    tgt0 = pyr.images[0][1:, None]
    p3d = pts.p3d[:-1]
    stack1 = torch.stack(
        [pyr.images[1][:-1], pyr.grad_x[1][:-1], pyr.grad_y[1][:-1]], dim=1
    )
    uv1 = pts.uv[:-1] * 0.5
    pairs = {
        "scharr": (lambda: ops.scharr_gradients_batched(img0),
                   lambda: ops.scharr_plain(img0)),
        "warp_sample": (lambda: ops.warp_and_sample(tgt0, p3d, T_rel, cam),
                        lambda: ops.warp_and_sample_plain(tgt0, p3d, T_rel, cam)),
        "bilinear_sample": (lambda: ops.cuda_bilinear_sample(stack1, uv1),
                            lambda: ops.bilinear_sample_plain(stack1, uv1)),
    }
    out = {}
    for name, (kernel, plain) in pairs.items():
        k1, p1, p2, k2 = (device_profile(f)[0] for f in (kernel, plain, plain, kernel))
        wk1, wp1, wp2, wk2 = (wall_ms(f) for f in (kernel, plain, plain, kernel))
        out[name] = {
            "device_ms": (k1 + k2) / 2, "plain_device_ms": (p1 + p2) / 2,
            "wall_ms": (wk1 + wk2) / 2, "plain_wall_ms": (wp1 + wp2) / 2,
        }
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is visible; nothing was run")
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.image.pyramid import build_pyramid_batched
    from uwslam_tpu_torch.ops import _lib
    from uwslam_tpu_torch.tracking.points import topk_gradient_points

    dev = torch.device("cuda", 0)
    gpu = bench.gpu_identity()
    say("1 device", f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, build_s, log = _lib.build()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("2 build", f"{path.name} in {build_s:.2f} s; ptxas: {' | '.join(ptxas)}")

    table = kernels_table()
    cam = bench.CAM
    poses = bench.bench_poses(device=dev)
    frames = bench.bench_frames(poses)
    pyr = build_pyramid_batched(frames, levels=bench.LEVELS)
    pts = topk_gradient_points(
        pyr.images[0], pyr.grad_mag[0], cam, num_points=bench.NUM_POINTS,
        mono_z=bench.MONO_Z, grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0],
    )
    errs = phase_parity(pyr, pts, cam, bench.TRACK_LEVELS)
    torch.cuda.synchronize()
    say("3 parity", "max abs error vs plain: " + json.dumps(errs))

    tracker = bench.make_tracker(cam)
    t0 = time.perf_counter()
    main_path = phase_main_path(tracker, frames, poses, bench.MONO_Z, table)
    say("4 main path", json.dumps(main_path)
        + f"; first chunk and CPU run {time.perf_counter() - t0:.1f} s")

    chunk_s = statistics.median(bench.time_chunks(tracker, frames, CHUNK_RUNS))
    busy_ms, launches = device_profile(lambda: tracker(frames, mono_z=bench.MONO_Z), 1)
    T_rel, _, _ = tracker(frames, mono_z=bench.MONO_Z)
    times = phase_timing(pyr, pts, cam, T_rel.contiguous())
    fps = (frames.shape[0] - 1) / chunk_s
    say("5 timing", f"{fps:.1f} tracked frames/s (median of {CHUNK_RUNS} chunks: "
        f"{chunk_s * 1e3:.2f} ms per {frames.shape[0]}-frame chunk; profiled "
        f"chunk: {busy_ms:.2f} ms device busy, {launches:.0f} kernel launches, "
        f"idle share {1 - busy_ms / (chunk_s * 1e3):.3f}); per call: "
        + json.dumps(times) + f"; {gpu}")

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"],
         "launches": main_path["launches"][k["name"]],
         "max_abs_err": errs[k["name"]],
         "ms": times[k["name"]]["device_ms"],
         "plain_ms": times[k["name"]]["plain_device_ms"]}
        for k in table
    ]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
