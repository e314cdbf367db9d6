"""Smoke test of the PyTorch/CUDA port (uwslam_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python chip_smoke.py`. It needs no network and no arguments, and
exits non-zero, printing no result, when no card is visible or any phase
fails. Phases, one line each:

1. The card's name and power limit (nvidia-smi).
2. Build the kernels from uwslam_tpu_torch/csrc with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path: K1 Scharr on all 5 levels of 96 x 480 x 640; K2
   warp+sample with 95 pairs, 2048 points at every track level (1 channel
   planar, and 3 channels as texels), including points behind the camera
   and on the exact right and bottom edges; K3 sample with 95 pairs, 3
   channels (planar and texels), 2048 points at levels 3, 2, 1, its interior
   also against `grid_sample`; the fused LM evaluation `lm_evaluate` (IC,
   Huber and none) at every track level on the same points: valid counts
   equal, every sum within LM_SUM_RTOL of the pair's scale, two launches
   bit-equal. K1-K3 must equal their plain versions bit for bit.
4. The main path: the repo's bench.py sequence (96 frames of 640 x 480)
   rendered on the card and tracked by SequenceTracker in IC mode. Every
   kernel must have launched; the trajectory's ATE must be within 1 mm; the
   same frames tracked on the CPU must give the same relative poses.
5. Timing after warm-up: frames/s of the median of 10 chunks (CUDA
   events), the device's busy time and launches in one profiled chunk, and
   each kernel against its plain version, in device time (profiler; CUDA
   events where a profile, taken up to three times, records no kernel) and
   in wall time per call (CUDA events).
3b. The live path's kernel shapes at B = 1: K1 on each level of one frame
   (480 x 640, 240 x 320, 120 x 160), K2 with C = 1 and with C = 3 texels
   (intensity and both gradients) and `lm_evaluate` (FC, on the texels) at
   levels 1 and 0, and K3 with C = 1 at the descriptor shape (768 keypoints
   x 64 taps per level), each against its plain version as in phase 3.
6. The live path (configuration 1): the same 96 frames through
   `SlamSystem.process_frame` (FC, 3 levels, track levels (1, 0), 10 LM
   iterations, 2048 points, keyframes, relocalization on). Every frame must
   be ok, ATE <= 2 mm, every kernel launched; the port's CPU run of the
   first 50 frames must give the same poses (1e-3 on se3.log) and the same
   keyframes.
7. Relocalization: the same run with frame 50 replaced by uniform noise
   (numpy seed 0): frame 50 lost, frame 51 relocalized, ATE <= 4 mm over
   the other 95 frames. The port's CPU run of these 96 frames (whose first
   50 serve phase 6) must give the same statuses, keyframes and poses,
   the relocalized one included (1e-3 on se3.log): CPU and card draw the
   same RANSAC samples.
8. The CLI: the first 32 frames as 8-bit PGM files with TUM timestamps,
   ground truth and a calibration XML in a temporary directory, through
   `uwslam_tpu_torch.cli.main.main` live and with `--offline`; both must
   exit 0 and print an ATE <= 2 cm (8-bit quantization alone moves the JAX
   package's CPU run of these 32 frames from 0.28 mm to 11.2 mm).
9. Live timing: frames/s and per-frame latency (median, p90; CUDA events
   in phase 6's run) after 15 warm-up frames, and device busy ms, idle
   share, kernel launches and the costliest operators per frame from the
   profiler over 5 frames.

Then a JSON line of per-kernel results (launches on the offline and the
live path; time, plain version's time, the card's bound for the same bytes
and operations, and a library call's time where one computes the same
function), the card's name and power limit, and, last,
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

K1_ATOL = 1e-4       # f32 gradients of [0, 255] images
SAMPLE_ATOL = 0.0    # K2/K3, planar and texels: bit-equal, masks equal
# lm_evaluate against its plain version: both sum ~2048 f32 terms per pair,
# the kernel in a tree, the plain version as bmm does, and the kernel's
# Jacobian arithmetic is contracted to FMAs. Each sum is held to this
# fraction of the pair's scale for it (H: its largest entry; b: its
# Cauchy-Schwarz bound sqrt(2 max|H| cost); cost and sum |r|: themselves).
LM_SUM_RTOL = 2e-5
# K3's interior against grid_sample(align_corners=True), which goes through
# normalized coordinates: u is recovered to ~W eps = 4e-5 px, times a
# gradient of up to ~100 gray levels per pixel.
GRID_SAMPLE_ATOL = 2e-2
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
F32_FLOP_PER_S = 67e12       # H100 SXM, published, outside the tensor cores
MAX_LAUNCHES_PER_CHUNK = 12295   # the unfused LM loop's count; must fall
MAX_LAUNCHES_PER_FRAME = 9403
T_REL_ATOL = 1e-3    # se3.log of the card's vs the CPU's relative poses
ATE_MAX = 1e-3       # m; the JAX package's f32 CPU run gives 0.000278 m
TIMING_REPS = 20
CHUNK_RUNS = 10
LIVE_ATE_MAX = 2e-3      # m; the JAX package's CPU run of the live path: 0.000853 m
# m. The relocalized pose rests on ~28 descriptor matches and moves by
# millimetres with the input's last bits: the JAX package's CPU run gives
# 0.00172 m on frames rendered by JAX and 0.005815 m on the port's (at most
# 1.1e-4 gray levels apart); the port gives 0.0038849 m on frames rendered
# on the card, on the card and on its host's CPU alike, and 0.005346 m on
# frames rendered on a CPU.
RELOC_ATE_MAX = 4e-3
LIVE_T_ATOL = 1e-3       # se3.log of the card's vs the CPU's per-frame T_wc
LIVE_WARMUP = 15         # the JAX CLI's own warm-up count
LIVE_PROFILED_FRAMES = 5  # op-level tracing adds seconds to each profiled frame
NOISE_FRAME = 50         # frames before it are the same in phases 6 and 7
CLI_FRAMES = 32
CLI_ATE_MAX = 2e-2       # m; JAX CPU on the same 32 8-bit frames: 0.011238 m


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
        {"name": "lm_evaluate", "wrapper": ops.lm_evaluate,
         "source": "uwslam_tpu_torch/csrc/lm_evaluate.cu",
         "replaces": "uwslam_tpu/ops/pallas_track.py:40"},
    ]


# Operations per output element, counted from the kernels' sources: K1 per
# pixel; K2, K3 per valid point (warp 18, projection 6, taps 10, blend 13 per
# channel); lm_evaluate per valid point (K2's, the residual, weight and cost
# 11, w J 6, 21 + 6 multiply-adds of the sums 54, 3 more sums; FC: the
# Jacobian 40).
K1_FLOPS = 25
WARP_FLOPS, TAPS_FLOPS, BLEND_FLOPS = 24, 10, 13
LM_FLOPS_IC = WARP_FLOPS + TAPS_FLOPS + BLEND_FLOPS + 11 + 6 + 54 + 3
LM_FLOPS_FC = LM_FLOPS_IC + 2 * BLEND_FLOPS + 40


def bound(n_bytes: float, flops: float) -> dict:
    """The least ms the card could take: the larger of bytes over its memory
    rate and operations over its f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes}


def bound_scharr(images) -> dict:
    """One plane read, three written."""
    return bound(images.numel() * 4 * 4, images.numel() * K1_FLOPS)


def bound_sampler(ok, C: int, point_bytes: int) -> dict:
    """K2 (12 B of point, 64 B of pose per pair) or K3 (8 B of uv): each
    point and its validity byte once, and for this run's valid points the
    four taps and the sample of every channel."""
    B, N = ok.shape
    n_ok = int(ok.sum())
    n_bytes = B * N * (point_bytes + 1) + n_ok * (16 * C + 4 * C)
    if point_bytes == 12:
        n_bytes += B * 64
    flops = n_ok * ((WARP_FLOPS if point_bytes == 12 else 0) + TAPS_FLOPS + BLEND_FLOPS * C)
    return bound(n_bytes, flops)


def bound_lm_evaluate(pts_valid, ok, fc: bool) -> dict:
    """Per point 12 B and the validity byte; per reference-valid point the
    projection decides; per valid point the reference intensity (4 B), the
    taps (IC 16 B, FC 48 B of the texels' three channels) and in IC the
    Jacobian row (24 B); per pair the pose (64 B), sigma (4 B) and the 45
    sums written. IC with every point valid: 57 B per point."""
    B, N = ok.shape
    n_ok = int((pts_valid & ok).sum())
    n_bytes = B * N * 13 + n_ok * (4 + (48 if fc else 16 + 24)) + B * (64 + 4 + 45 * 4)
    return bound(n_bytes, n_ok * (LM_FLOPS_FC if fc else LM_FLOPS_IC))


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


def lm_sums_error(got, want) -> float:
    """Largest error of a kernel's (B, 48) sums against the plain version's,
    as a fraction of each pair's scale for that sum (see LM_SUM_RTOL). Valid
    counts must be equal, the kernel's H symmetric and its padding zero."""
    from uwslam_tpu_torch.ops.cuda_track import LM_B, LM_COST, LM_COUNT, LM_H

    if not torch.equal(got[:, LM_COUNT], want[:, LM_COUNT]):
        raise AssertionError("lm_evaluate: valid counts differ")
    H = got[:, LM_H].view(-1, 6, 6)
    if not torch.equal(H, H.transpose(1, 2)) or bool(got[:, 45:].any()):
        raise AssertionError("lm_evaluate: H is not symmetric or the padding not zero")
    got, want = got.double(), want.double()
    h_scale = want[:, LM_H].abs().amax(-1, keepdim=True)
    b_scale = torch.sqrt(2.0 * h_scale * want[:, LM_COST, None])
    worst = 0.0
    for sl, scale in ((LM_H, h_scale), (LM_B, b_scale), (slice(42, 44), want[:, 42:44].abs())):
        rel = (got[:, sl] - want[:, sl]).abs() / scale.clamp(min=1e-30)
        worst = max(worst, float(rel.max()))
    return worst


def check_lm_evaluate(target, pts_l, T, cam_l, what: str, J_ref=None) -> float:
    """`lm_evaluate` (Huber and none) against its plain version at poses T:
    counts equal, sums within LM_SUM_RTOL, a second launch bit-equal. The
    scale is the MAD of the residuals at T, as on the main path."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.ops.cuda_track import LM_COUNT
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    fc = J_ref is None
    vals, ok = ops.warp_and_sample_plain(target if fc else target[:, None], pts_l.p3d, T,
                                         cam_l, texels=fc)
    valid = pts_l.valid & ok
    sigma = mad_sigma(torch.where(valid, vals[:, 0] - pts_l.intensity, 0.0), valid)
    worst = 0.0
    for kind in (WeightKind.HUBER, WeightKind.NONE):
        args = (pts_l.intensity, pts_l.valid, sigma, cam_l, kind, J_ref)
        evaluator = ops.LMEvaluator(target, pts_l.p3d, *args)
        first = evaluator(T).clone()
        if not torch.equal(first, evaluator(T)):
            raise AssertionError(f"{what} {kind.value}: two launches differ")
        plain = ops.lm_evaluate_plain(target, pts_l.p3d, T, *args)
        if not int(plain[:, LM_COUNT].max()) > 0:
            raise AssertionError(f"{what}: no valid point")
        err = lm_sums_error(first, plain)
        if not err <= LM_SUM_RTOL:
            raise AssertionError(f"{what} {kind.value}: sums differ by {err} of their "
                                 f"scale > {LM_SUM_RTOL}")
        worst = max(worst, err)
    return worst


def grid_sample_call(stack, uv):
    """`F.grid_sample` set up for K3's function on (B, C, H, W) at uv
    (B, N, 2): the normalized grid is built here, outside any timing."""
    H, W = stack.shape[-2:]
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=uv.device)
    grid = (uv * scale - 1.0)[:, None]                       # (B, 1, N, 2)
    return lambda: torch.nn.functional.grid_sample(
        stack, grid, mode="bilinear", padding_mode="zeros", align_corners=True)[:, :, 0]


def check_grid_sample(kernel_out, stack, uv, what: str) -> float:
    """K3 against grid_sample where the two compute the same function: at
    valid points off the last row and column."""
    vals, ok = kernel_out
    H, W = stack.shape[-2:]
    inner = (ok & (uv[..., 0] < W - 1) & (uv[..., 1] < H - 1))[:, None]
    diff = torch.where(inner, vals - grid_sample_call(stack, uv)(), 0.0)
    err = float(diff.abs().max())
    if not err <= GRID_SAMPLE_ATOL:
        raise AssertionError(f"{what}: differs from grid_sample by {err} > {GRID_SAMPLE_ATOL}")
    return err


def phase_parity(pyr, pts, cam, track_levels, seed: int = 0):
    """Kernel vs plain version on the card at the main path's shapes.
    Returns {kernel name: max abs error}."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.photometric import ic_jacobian
    from uwslam_tpu_torch.tracking.points import TrackPoints

    dev = pyr.images[0].device
    err = {"scharr": 0.0, "warp_sample": 0.0, "bilinear_sample": 0.0,
           "lm_evaluate": 0.0, "bilinear_sample_vs_grid_sample": 0.0}
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
        tgt_planes = (pyr.images[lvl][1:], pyr.grad_x[lvl][1:], pyr.grad_y[lvl][1:])
        k = ops.warp_and_sample(ops.pack_texels(*tgt_planes), p3d, T, cam_l, texels=True)
        p = ops.warp_and_sample_plain(torch.stack(tgt_planes, dim=1), p3d, T, cam_l)
        err["warp_sample"] = max(err["warp_sample"], compare(
            k, p, SAMPLE_ATOL, f"warp_sample texels level {lvl}"))

        # The reference pass (K3; level 0 carries its values from selection).
        uv = pts.uv[:-1] * (1.0 / (1 << lvl))
        ref_planes = (pyr.images[lvl][:-1], pyr.grad_x[lvl][:-1], pyr.grad_y[lvl][:-1])
        stack = torch.stack(ref_planes, dim=1)
        if lvl == 0:
            ref, ref_ok = (pts.intensity[:-1], pts.gx0[:-1], pts.gy0[:-1]), pts.valid[:-1]
        else:
            W, H = cam_l.width, cam_l.height
            edges = torch.tensor(
                [[W - 1, 1.5], [W - 1, H - 1], [2.25, H - 1], [0.0, 0.0],
                 [W - 1 + 1e-3, 3.0], [-1e-3, 3.0], [5.0, H - 1 + 1e-3],
                 [float("nan"), 2.0]], device=dev,
            )
            uv_edge = uv.clone()
            uv_edge[: B // 4, : len(edges)] = edges
            p = ops.bilinear_sample_plain(stack, uv_edge)
            for name, k in (
                ("planar", ops.cuda_bilinear_sample(stack, uv_edge)),
                ("texels", ops.cuda_bilinear_sample(ops.pack_texels(*ref_planes), uv_edge,
                                                    texels=True)),
            ):
                err["bilinear_sample"] = max(err["bilinear_sample"], compare(
                    k, p, SAMPLE_ATOL, f"bilinear_sample {name} level {lvl}"))
            err["bilinear_sample_vs_grid_sample"] = max(
                err["bilinear_sample_vs_grid_sample"],
                check_grid_sample(k, stack, uv_edge, f"bilinear_sample level {lvl}"))
            vals, ref_ok = ops.cuda_bilinear_sample(stack, uv)
            ref, ref_ok = (vals[:, 0], vals[:, 1], vals[:, 2]), pts.valid[:-1] & ref_ok
        pts_l = TrackPoints(uv=uv, p3d=p3d, intensity=ref[0], valid=ref_ok)
        err["lm_evaluate"] = max(err["lm_evaluate"], check_lm_evaluate(
            pyr.images[lvl][1:], pts_l, T, cam_l, f"lm_evaluate IC level {lvl}",
            J_ref=ic_jacobian(pts_l, ref[1], ref[2], cam_l)))
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


class NoDeviceTime(RuntimeError):
    """The profiler recorded no kernel in any of its attempts."""


def profiled_kernels(fn, reps: int, ops: bool = False, attempts: int = 3):
    """The profiler's per-kernel averages over `reps` calls of fn, after one
    unprofiled call; with ops=True also the host-side operators (aten::mul,
    ...) that launched device work, as a second list. A profile that
    recorded no device time (the CUDA activity trace occasionally comes back
    empty for a short window) is taken again, up to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
        if sum(e.self_device_time_total for e in kernels) > 0:
            break
    else:
        raise NoDeviceTime(f"the profiler saw no device time in {attempts} attempts")
    if ops:
        return kernels, [e for e in averages if e.device_type == DeviceType.CPU
                         and e.self_device_time_total > 0]
    return kernels


def device_profile(fn, reps: int = TIMING_REPS) -> tuple[float, float]:
    """(device ms, kernel launches) per call of fn: the sum of the self
    device time of every kernel the profiler saw over `reps` calls."""
    kernels = profiled_kernels(fn, reps)
    total_us = sum(e.self_device_time_total for e in kernels)
    return total_us / 1e3 / reps, sum(e.count for e in kernels) / reps


def call_ms(fn) -> tuple[float, str]:
    """(ms per call, timer) of one kernel or plain call: device time from the
    profiler, or, where the profiler records none, CUDA events around
    back-to-back calls (which then include the host's dispatch)."""
    try:
        return device_profile(fn)[0], "profiler"
    except NoDeviceTime:
        return wall_ms(fn), "cuda_events"


def turns(kernel, plain) -> dict:
    """Kernel vs plain ms per call in turns kernel, plain, plain, kernel."""
    (k1, t1), (p1, t2), (p2, t3), (k2, t4) = (
        call_ms(f) for f in (kernel, plain, plain, kernel))
    timers = sorted({t1, t2, t3, t4})
    return {"device_ms": (k1 + k2) / 2, "plain_device_ms": (p1 + p2) / 2,
            **({} if timers == ["profiler"] else {"timers": timers})}


def time_pairs(pairs: dict, bounds: dict, library: dict) -> dict:
    """For each kernel: device ms of kernel and plain version (`turns`), wall
    ms per call of both (CUDA events around back-to-back calls: the host's
    dispatch where that is longer), its bound, and the library call's device
    ms where there is one."""
    out = {}
    for name, (kernel, plain) in pairs.items():
        wk1, wp1, wp2, wk2 = (wall_ms(f) for f in (kernel, plain, plain, kernel))
        out[name] = {**turns(kernel, plain), "wall_ms": (wk1 + wk2) / 2,
                     "plain_wall_ms": (wp1 + wp2) / 2, **bounds[name],
                     "library_ms": call_ms(library[name])[0] if name in library else None}
    return out


def phase_timing(pyr, pts, cam, T_rel):
    """Kernel vs plain version at the largest shape each has on the offline
    path (level 0; K3 level 1), with each kernel's bound from these inputs.
    `bilinear_sample` is the texel path the chunk runs, `bilinear_sample_planar`
    the same sample from three planes; both beside `grid_sample`."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.photometric import ic_jacobian
    from uwslam_tpu_torch.tracking.points import TrackPoints
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    img0 = pyr.images[0]
    tgt0 = pyr.images[0][1:, None]
    ref = pts.select(slice(None, -1))
    p3d = ref.p3d
    planes1 = (pyr.images[1][:-1], pyr.grad_x[1][:-1], pyr.grad_y[1][:-1])
    stack1, texels1 = torch.stack(planes1, dim=1), ops.pack_texels(*planes1)
    uv1 = ref.uv * 0.5
    vals, ok = ops.warp_and_sample(tgt0, p3d, T_rel, cam)
    valid = ref.valid & ok
    sigma = mad_sigma(torch.where(valid, vals[:, 0] - ref.intensity, 0.0), valid)
    pts0 = TrackPoints(uv=ref.uv, p3d=p3d, intensity=ref.intensity, valid=ref.valid)
    lm_args = (ref.intensity, ref.valid, sigma, cam, WeightKind.HUBER,
               ic_jacobian(pts0, ref.gx0, ref.gy0, cam))
    evaluator = ops.LMEvaluator(tgt0[:, 0], p3d, *lm_args)
    sampler = ops.WarpSampler(tgt0, p3d, cam)
    pairs = {
        "scharr": (lambda: ops.scharr_gradients_batched(img0),
                   lambda: ops.scharr_plain(img0)),
        "warp_sample": (lambda: sampler(T_rel),
                        lambda: ops.warp_and_sample_plain(tgt0, p3d, T_rel, cam)),
        "bilinear_sample": (lambda: ops.cuda_bilinear_sample(texels1, uv1, texels=True),
                            lambda: ops.bilinear_sample_texels_plain(texels1, uv1)),
        "bilinear_sample_planar": (lambda: ops.cuda_bilinear_sample(stack1, uv1),
                                   lambda: ops.bilinear_sample_plain(stack1, uv1)),
        "lm_evaluate": (lambda: evaluator(T_rel),
                        lambda: ops.lm_evaluate_plain(tgt0[:, 0], p3d, T_rel, *lm_args)),
    }
    ok1 = ops.cuda_bilinear_sample(stack1, uv1)[1]
    bounds = {
        "scharr": bound_scharr(img0),
        "warp_sample": bound_sampler(ok, 1, 12),
        "bilinear_sample": bound_sampler(ok1, 3, 8),
        "bilinear_sample_planar": bound_sampler(ok1, 3, 8),
        "lm_evaluate": bound_lm_evaluate(ref.valid, ok, fc=False),
    }
    grid = grid_sample_call(stack1, uv1)
    return time_pairs(pairs, bounds, {"bilinear_sample": grid,
                                      "bilinear_sample_planar": grid})


def live_config():
    """Configuration 1 at the bench design point: FC, 3 levels, track levels
    (1, 0), 10 LM iterations, 2048 points, Huber, keyframes, relocalization."""
    from uwslam_tpu_torch.config import SlamConfig, TrackerConfig

    return SlamConfig(
        tracker=TrackerConfig(
            pyramid_levels=3, track_levels=(1, 0), max_iterations=10,
            num_points=2048, mono_depth=2.0, track_mode="fc",
        ),
        use_reloc=True,
    )


def make_system(device):
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.system import SlamSystem

    calib = Calibration(raw=bench.CAM, out_width=bench.CAM.width,
                        out_height=bench.CAM.height)
    return SlamSystem(calib, live_config(), device=device)


def run_live(frames, device, n=None, events=False):
    """Frames (N, H, W) through a fresh SlamSystem on `device` -> (system,
    states, per-frame ms from CUDA events or None)."""
    system = make_system(device)
    n = frames.shape[0] if n is None else n
    states, ms = [], []
    for i in range(n):
        if events:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        states.append(system.process_frame(frames[i], timestamp=float(i)))
        if events:
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    return system, states, (ms if events else None)


def live_ate(system, poses, keep=None) -> float:
    from uwslam_tpu_torch.io.trajectory import ate_rmse
    from uwslam_tpu_torch.lie import se3

    _, est = system.export_trajectory()
    gt = se3.inverse(poses.cpu()).numpy()
    keep = slice(None) if keep is None else keep
    return ate_rmse(est[keep, :3, 3], gt[keep, :3, 3])


def phase_parity_live(frames, cam, seed: int = 1):
    """Kernels at the live path's B = 1 shapes against their plain versions.
    Returns ({kernel: max abs error}, what `time_pairs` takes: {kernel:
    (kernel, plain) callables at the largest live shape}, their bounds and
    the library calls)."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.features import detect_multiscale
    from uwslam_tpu_torch.image.pyramid import build_pyramid
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.points import TrackPoints, topk_gradient_points
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    cfg = live_config().tracker
    dev = frames.device
    ref = build_pyramid(frames[0], levels=cfg.pyramid_levels)
    tgt = build_pyramid(frames[1], levels=cfg.pyramid_levels)
    pts = topk_gradient_points(ref.images[0], ref.grad_mag[0], cam,
                               num_points=cfg.num_points, mono_z=cfg.mono_depth)
    gen = torch.Generator().manual_seed(seed)
    T_move = se3.exp(0.02 * torch.randn(1, 6, generator=gen)).to(dev)
    err = {"scharr": 0.0, "warp_sample": 0.0, "bilinear_sample": 0.0, "lm_evaluate": 0.0}
    calls, bounds = {}, {}
    for lvl, img in enumerate(ref.images):                  # (1, H_l, W_l)
        k = ops.scharr_gradients_batched(img)
        p = ops.scharr_plain(img)
        for kk, pp, nm in zip(k, p, ("gx", "gy", "gm")):
            e = float((kk - pp).abs().max())
            if not e <= K1_ATOL:
                raise AssertionError(f"scharr B=1 level {lvl} {nm}: {e} > {K1_ATOL}")
            err["scharr"] = max(err["scharr"], e)
    for lvl in cfg.track_levels:
        cam_l = cam.scaled(lvl)
        planes = (tgt.images[lvl], tgt.grad_x[lvl], tgt.grad_y[lvl])
        stacked, texels = torch.stack(planes, dim=1), ops.pack_texels(*planes)
        plane = tgt.images[lvl][:, None]
        p3d_edge = pts.p3d.clone()
        p3d_edge[0, :64] = edge_points(cam_l, 64).to(dev)
        ref_int, ref_ok = ops.cuda_bilinear_sample(ref.images[lvl][:, None],
                                                   pts.uv * (1.0 / (1 << lvl)))
        for T, p3d in ((torch.eye(4, device=dev)[None], p3d_edge), (T_move, pts.p3d)):
            p = ops.warp_and_sample_plain(stacked, p3d, T, cam_l)
            k = ops.warp_and_sample(texels, p3d, T, cam_l, texels=True)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, p, SAMPLE_ATOL, f"warp_sample B=1 texels level {lvl}"))
            k = ops.warp_and_sample(plane, p3d, T, cam_l)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, (p[0][:, :1], p[1]), SAMPLE_ATOL, f"warp_sample B=1 C=1 level {lvl}"))
            pts_l = TrackPoints(uv=pts.uv, p3d=p3d, intensity=ref_int[:, 0],
                                valid=pts.valid & ref_ok)
            err["lm_evaluate"] = max(err["lm_evaluate"], check_lm_evaluate(
                texels, pts_l, T, cam_l, f"lm_evaluate FC B=1 level {lvl}"))
        if lvl == 0:
            q = pts.p3d
            sampler = ops.WarpSampler(plane, q, cam_l)
            ok = p[1]
            sigma = mad_sigma(torch.where(pts_l.valid & ok, p[0][:, 0] - pts_l.intensity, 0.0),
                              pts_l.valid & ok)
            lm_args = (pts_l.intensity, pts_l.valid, sigma, cam_l, WeightKind.HUBER)
            evaluator = ops.LMEvaluator(texels, q, *lm_args)
            calls["warp_sample"] = (
                lambda: sampler(T_move),
                lambda c=cam_l: ops.warp_and_sample_plain(plane, q, T_move, c))
            calls["warp_sample_texels"] = (
                lambda c=cam_l: ops.warp_and_sample(texels, q, T_move, c, texels=True),
                lambda c=cam_l: ops.warp_and_sample_plain(texels, q, T_move, c, texels=True))
            calls["lm_evaluate"] = (
                lambda: evaluator(T_move),
                lambda: ops.lm_evaluate_plain(texels, q, T_move, *lm_args))
            bounds["warp_sample"] = bound_sampler(ok, 1, 12)
            bounds["warp_sample_texels"] = bound_sampler(ok, 3, 12)
            bounds["lm_evaluate"] = bound_lm_evaluate(pts_l.valid, ok, fc=True)
    fcfg = live_config().features
    kps = detect_multiscale([g[0] for g in ref.grad_x], [g[0] for g in ref.grad_y],
                            per_level=fcfg.per_level, levels=fcfg.detect_levels)
    half = 3.5
    offs = (torch.arange(8, dtype=torch.float32, device=dev) - half) * 2.0
    du, dv = torch.meshgrid(offs, offs, indexing="xy")
    taps = torch.stack([du.reshape(-1), dv.reshape(-1)], dim=-1)
    for lvl, img in enumerate(ref.images):
        uv = ((kps.uv / (1 << lvl))[:, None, :] + taps[None]).reshape(1, -1, 2)
        image = img[None]                                   # (1, 1, H_l, W_l)
        k = ops.cuda_bilinear_sample(image, uv)
        p = ops.bilinear_sample_plain(image, uv)
        err["bilinear_sample"] = max(err["bilinear_sample"], compare(
            k, p, SAMPLE_ATOL, f"bilinear_sample B=1 C=1 describe level {lvl}"))
        if lvl == 0:
            calls["bilinear_sample"] = (
                lambda i=image, q=uv: ops.cuda_bilinear_sample(i, q),
                lambda i=image, q=uv: ops.bilinear_sample_plain(i, q),
            )
            bounds["bilinear_sample"] = bound_sampler(k[1], 1, 8)
            library = {"bilinear_sample": grid_sample_call(image, uv)}
    calls["scharr"] = (lambda f=frames[:1]: ops.scharr_gradients_batched(f),
                       lambda f=frames[:1]: ops.scharr_plain(f))
    bounds["scharr"] = bound_scharr(frames[:1])
    return err, (calls, bounds, library)


def card_vs_cpu(card_states, cpu_states, what: str) -> float:
    """Statuses and keyframe flags must be equal and every T_wc within
    LIVE_T_ATOL on se3.log; returns the largest se3.log difference."""
    from uwslam_tpu_torch.lie import se3

    n = len(cpu_states)
    for key in ("status", "is_keyframe"):
        card = [getattr(s, key) for s in card_states[:n]]
        cpu = [getattr(s, key) for s in cpu_states]
        if card != cpu:
            raise AssertionError(f"{what}: {key} differs: card {card} vs CPU {cpu}")
    card = torch.from_numpy(np.stack([s.T_wc for s in card_states[:n]]))
    cpu = torch.from_numpy(np.stack([s.T_wc for s in cpu_states]))
    dev = float((se3.log(card) - se3.log(cpu)).abs().max())
    if not dev <= LIVE_T_ATOL:
        raise AssertionError(f"{what}: card vs CPU se3.log differs by {dev} > {LIVE_T_ATOL}")
    return dev


def phase_live(frames, poses, table, cpu_states):
    """Configuration 1 live on the card with fresh launch counts; the CPU's
    run of the first frames (`cpu_states`) must agree."""
    for k in table:
        k["wrapper"].launches = 0
    system, states, frame_ms = run_live(frames, frames.device, events=True)
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the live path: {missing}")
    bad = [(s.frame_id, s.status) for s in states if s.status != "ok"]
    if bad:
        raise AssertionError(f"live frames not ok: {bad[:10]}")
    if not all(np.isfinite(s.T_wc).all() for s in states):
        raise AssertionError("non-finite live pose")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX:
        raise AssertionError(f"live ATE {ate} m > {LIVE_ATE_MAX} m")
    dev_cpu = card_vs_cpu(states, cpu_states, "live path")
    return {
        "launches": launches, "ate": ate, "card_vs_cpu": dev_cpu,
        "cpu_frames": len(cpu_states),
        "keyframes": int(sum(s.is_keyframe for s in states)),
        "min_inliers": int(min(s.tracked_inliers for s in states)),
    }, frame_ms


def with_noise_frame(frames):
    """The frames with frame NOISE_FRAME replaced by uniform noise (numpy
    seed 0)."""
    noisy = frames.clone()
    noise = np.random.default_rng(0).uniform(0, 255, tuple(frames.shape[1:]))
    noisy[NOISE_FRAME] = torch.from_numpy(noise.astype(np.float32)).to(frames.device)
    return noisy


def phase_reloc(noisy, poses, cpu_states):
    """The relocalization run on the card; the CPU's run of the same frames
    (`cpu_states`) must agree frame by frame, the relocalized pose included."""
    system, states, _ = run_live(noisy, noisy.device)
    got = (states[NOISE_FRAME].status, states[NOISE_FRAME + 1].status)
    if got != ("lost", "relocalized"):
        raise AssertionError(f"frames {NOISE_FRAME}, {NOISE_FRAME + 1}: {got}, "
                             "want ('lost', 'relocalized')")
    others = [s.status for i, s in enumerate(states)
              if i not in (NOISE_FRAME, NOISE_FRAME + 1)]
    keep = np.array([i != NOISE_FRAME for i in range(len(states))])
    ate = live_ate(system, poses, keep)
    if not ate <= RELOC_ATE_MAX:
        raise AssertionError(f"relocalization run ATE {ate} m > {RELOC_ATE_MAX} m")
    dev_cpu = card_vs_cpu(states, cpu_states, "relocalization run")
    return {"statuses": list(got), "other_not_ok": sum(s != "ok" for s in others),
            "ate": ate, "keyframes": int(sum(s.is_keyframe for s in states)),
            "card_vs_cpu": dev_cpu}


def write_dataset(frames, poses, root: Path):
    """8-bit PGM frames named by TUM timestamps, TUM ground truth (T_wc) and
    an undistorted calibration XML of the bench camera."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3

    rgb = root / "rgb"
    rgb.mkdir()
    imgs = frames.clamp(0, 255).to(torch.uint8).cpu().numpy()
    T_wc = se3.inverse(poses.cpu())
    q, t = (x.numpy() for x in se3.to_quaternion_translation(T_wc))
    lines = ["# ground truth\n# synthetic\n# timestamp tx ty tz qx qy qz qw\n"]
    for i, img in enumerate(imgs):
        ts = f"{1.0 + 0.033 * i:.6f}"
        h, w = img.shape
        (rgb / f"{ts}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        lines.append(f"{ts} {t[i, 0]} {t[i, 1]} {t[i, 2]} "
                     f"{q[i, 1]} {q[i, 2]} {q[i, 3]} {q[i, 0]}\n")
    (root / "groundtruth.txt").write_text("".join(lines))
    cam = bench.CAM
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>{cam.width}</in_width><in_height>{cam.height}</in_height>
<out_width>{cam.width}</out_width><out_height>{cam.height}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{cam.fx} {cam.fy} {cam.cx} {cam.cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>0 0 0 0</data></rectification>
</opencv_storage>
""")
    return rgb, root / "calib.xml", root / "groundtruth.txt"


def phase_cli(frames, poses):
    """The CLI live and offline on 8-bit PGM files; each must exit 0 and
    print an ATE within CLI_ATE_MAX."""
    from uwslam_tpu_torch.cli.main import main as cli_main

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rgb, calib, gt = write_dataset(frames[:CLI_FRAMES], poses[:CLI_FRAMES], Path(tmp))
        base = ["-d", str(rgb), "-c", str(calib), "--tum-gt", str(gt), "--levels", "3",
                "--track-levels", "1,0", "--mono-depth", "2.0", "--platform", "cuda"]
        for name, extra in (("live", []), ("offline", ["--offline", "--track-mode", "fc"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(base + extra + ["--trajectory-out", str(Path(tmp) / f"{name}.txt")])
            text = buf.getvalue()
            m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+-]+) m", text)
            if rc != 0 or m is None:
                raise AssertionError(f"CLI {name}: exit {rc}, output {text!r}")
            ate = float(m.group(1))
            if not ate <= CLI_ATE_MAX:
                raise AssertionError(f"CLI {name}: ATE {ate} m > {CLI_ATE_MAX} m")
            out[name] = {"ate": ate, "s": round(time.perf_counter() - t0, 2)}
    return out


def phase_live_timing(frames, calls, frame_ms):
    """Per-frame latency and frames/s of phase 6's card run after the
    warm-up frames (CUDA events around each process_frame, which ends in its
    diagnostics transfer); the profiler's device busy time, launches and
    costliest operators per frame over 5 frames of a fresh run; and each
    kernel against its plain version at the live path's largest shape
    (`time_pairs`)."""
    steady = frame_ms[LIVE_WARMUP:]
    system = make_system(frames.device)
    for i in range(LIVE_WARMUP):
        system.process_frame(frames[i], timestamp=float(i))
    reps = LIVE_PROFILED_FRAMES
    window = iter(range(LIVE_WARMUP, LIVE_WARMUP + reps + 1))
    kernels, ops = profiled_kernels(
        lambda: system.process_frame(frames[next(window)], timestamp=0.0), reps, ops=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    per_kernel = time_pairs(*calls)
    return {
        "frames_per_s": len(steady) / (sum(steady) / 1e3),
        "latency_ms_median": statistics.median(steady),
        "latency_ms_p90": float(np.percentile(steady, 90)),
        "device_busy_ms_per_frame": busy_ms,
        "idle_share": 1.0 - busy_ms / statistics.mean(steady),
        "launches_per_frame": sum(e.count for e in kernels) / reps,
        "top_ops_device_ms_and_calls_per_frame": {
            e.key: [round(e.self_device_time_total / 1e3 / reps, 4), round(e.count / reps, 1)]
            for e in top
        },
        "kernels_at_live_shapes": per_kernel,
    }


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

    t0 = time.perf_counter()
    chunk_s = statistics.median(bench.time_chunks(tracker, frames, CHUNK_RUNS))
    busy_ms, launches = device_profile(lambda: tracker(frames, mono_z=bench.MONO_Z), 1)
    T_rel, _, _ = tracker(frames, mono_z=bench.MONO_Z)
    times = phase_timing(pyr, pts, cam, T_rel.contiguous())
    fps = (frames.shape[0] - 1) / chunk_s
    if not launches < MAX_LAUNCHES_PER_CHUNK:
        raise AssertionError(f"{launches:.0f} kernel launches per chunk, not below "
                             f"{MAX_LAUNCHES_PER_CHUNK}")
    say("5 timing", f"{fps:.1f} tracked frames/s (median of {CHUNK_RUNS} chunks: "
        f"{chunk_s * 1e3:.2f} ms per {frames.shape[0]}-frame chunk; profiled "
        f"chunk: {busy_ms:.2f} ms device busy, {launches:.0f} kernel launches, "
        f"idle share {1 - busy_ms / (chunk_s * 1e3):.3f}); per call: "
        + json.dumps(times) + f"; {gpu}; {time.perf_counter() - t0:.1f} s")

    errs_live, live_calls = phase_parity_live(frames, cam)
    torch.cuda.synchronize()
    say("3b parity (live shapes)", "max abs error vs plain: " + json.dumps(errs_live))

    t0 = time.perf_counter()
    noisy = with_noise_frame(frames)
    _, cpu_states, _ = run_live(noisy.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    live, frame_ms = phase_live(frames, poses, table, cpu_states[:NOISE_FRAME])
    say("6 live path", json.dumps(live) + f"; card run {time.perf_counter() - t0:.1f} s, "
        f"CPU run of the {noisy.shape[0]} frames of phase 7 {cpu_s:.1f} s")
    t0 = time.perf_counter()
    reloc = phase_reloc(noisy, poses, cpu_states)
    say("7 relocalization", json.dumps(reloc) + f"; {time.perf_counter() - t0:.1f} s")
    say("8 cli", json.dumps(phase_cli(frames, poses)))
    t0 = time.perf_counter()
    live_times = phase_live_timing(frames, live_calls, frame_ms)
    say("9 live timing", json.dumps(live_times) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not live_times["launches_per_frame"] < MAX_LAUNCHES_PER_FRAME:
        raise AssertionError(f"{live_times['launches_per_frame']:.0f} kernel launches per "
                             f"live frame, not below {MAX_LAUNCHES_PER_FRAME}")

    live_k = live_times["kernels_at_live_shapes"]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"],
         "launches": main_path["launches"][k["name"]],
         "launches_live": live["launches"][k["name"]],
         "max_abs_err": max(errs[k["name"]], errs_live[k["name"]]),
         "ms": times[k["name"]]["device_ms"],
         "plain_ms": times[k["name"]]["plain_device_ms"],
         "bound_ms": times[k["name"]]["bound_ms"],
         "bound_by": times[k["name"]]["bound_by"],
         "library_ms": times[k["name"]]["library_ms"],
         "ms_live": live_k[k["name"]]["device_ms"],
         "plain_ms_live": live_k[k["name"]]["plain_device_ms"],
         "bound_ms_live": live_k[k["name"]]["bound_ms"],
         "library_ms_live": live_k[k["name"]]["library_ms"]}
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
