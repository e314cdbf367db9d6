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

10. Depth images: K3 with C = 1 on a TUM-encoded depth image (uint16, 5000
   per metre, with holes, a depth step and last-column points) against its
   plain version, bit for bit, at the live shape (1 x 480 x 640, 8,192
   corner reads) and the offline shape (96 frames), timed beside its bound
   and `grid_sample`; `_depth_at` on the card against the CPU; every kernel
   against its plain version at `track_sequence`'s shapes (B = 1, 5 levels,
   FC, track levels 3-0: K1 down to 30 x 40, K3, K2 and `lm_evaluate` for
   one pair at every track level), as in phase 3b; the offline IC chunk and `track_sequence` (FC, sequential, 96 frames) with the
   plane's depth frames (ATE <= 1 mm; the CPU's run of the first frames
   within 1e-3 on se3.log); the live path with depth images
   (`process_frame(depth=)`, all ok, ATE <= 2 mm). The monocular depth is
   set wrong (1 where the plane is at 2), so only the depth images can give
   these trajectories.
11. The pipelined live loop: (a) the CUDA graph's replay against the eager
   megastep on the same inputs, every output bit-equal; (b) the 96 frames
   through `process_frame_async` + `flush`: frame ids in order, statuses
   and keyframes equal to the CPU's pipelined run, poses within 1e-3, ATE
   <= 2 mm and within 5 mm of the synchronous run's, at least 90 frames
   through the graph, every kernel launched; (c) the relocalization
   sequence pipelined: the failure is found at retirement, the frames in
   flight are drained as lost, the loop re-enters the graph; statuses,
   keyframes and poses equal to the CPU's pipelined run of the same frames
   (1e-3), ATE <= 2 mm on each side of the drained frames; (d) frames/s,
   per-frame time (median, p90; CUDA events), and from one profiled window
   with event marks around it the device busy time, graph and kernel
   launches per frame and idle share, beside phase 9's synchronous loop;
   each kernel's launches in that window counted by its name in the
   profile must equal what the wrappers counted (a replay runs no Python,
   so the wrappers' counts on this path are added per replay).
12. Rectification: 32 frames rendered with radtan distortion; every kernel
   against its plain version at the cropped region of interest's shapes
   (1 x 464 x 624 and its two halvings, no multiples of a 32 x 8 block), as
   in phase 3b; the frames through the pipelined loop (region of interest and camera equal to the CPU run's,
   ATE <= 2 cm, card vs CPU 1e-3) and, as 8-bit files in the EUROC layout,
   through the CLI with `--euroc`.

Then a JSON line of per-kernel results (launches on the offline, the live,
the depth, the pipelined and the rectified path; time, plain version's
time, the card's bound for the same bytes and operations, and a library
call's time where one computes the same function), the card's name and
power limit, and, last, `{"ok": true, "device": {...}}`.
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

K1_ATOL = 0.0        # K1: bit-equal (rounded intrinsics in the plain version's order)
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
DEPTH_PER_METRE = 5000.0     # TUM depth images
DEPTH_CPU_FRAMES = 32        # the CPU tracks this prefix of the depth runs
PIPE_MIN_GRAPH_FRAMES = 90   # of 96: all but the first go through the graph
PIPE_VS_SYNC_ATE = 5e-3      # m, as tests/test_pipeline.py
PIPE_PROFILED_FRAMES = 8
# m, over the frames that are ok. At retirement the lost frame takes the last
# retired pose and the frames in flight coast on it, so the trajectory keeps
# the camera's motion over those frames as an offset (the JAX package's
# rule); the synchronous run relocalizes one frame later (RELOC_ATE_MAX).
# Frames 51-54 are drained while the camera moves 0.044 m, and a step of that
# size after 55 of 96 frames is an aligned RMSE just above 0.02 m: phase 11c
# prints it for the card and for the port's CPU run of the same frames. The
# checks that decide are the frame-by-frame agreement with that CPU run and
# LIVE_ATE_MAX on each side of the step; this bar only bounds the step.
PIPE_RELOC_ATE_MAX = 3e-2
# The kernels' names as the profiler reports them (substrings).
KERNEL_SYMBOLS = {"scharr": "scharr_kernel", "warp_sample": "warp_sample_kernel",
                  "bilinear_sample": "bilinear_sample_kernel",
                  "lm_evaluate": "lm_evaluate_kernel"}
RECT_FRAMES = 32
RECT_DISTORTION = dict(k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5)   # EUROC-like
RECT_ATE_MAX = 2e-2


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


def make_system(device, raw=None, mono_depth=None):
    """Configuration 1 on `device`; `raw` another raw camera than the bench's
    (a distorted one), `mono_depth` another monocular depth."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.system import SlamSystem

    raw = bench.CAM if raw is None else raw
    config = live_config()
    if mono_depth is not None:
        config = replace(config, tracker=replace(config.tracker, mono_depth=mono_depth))
    calib = Calibration(raw=raw, out_width=raw.width, out_height=raw.height)
    return SlamSystem(calib, config, device=device)


def run_live(frames, device, n=None, events=False, depths=None, mono_depth=None):
    """Frames (N, H, W) through a fresh SlamSystem on `device` -> (system,
    states, per-frame ms from CUDA events or None)."""
    system = make_system(device, mono_depth=mono_depth)
    n = frames.shape[0] if n is None else n
    states, ms = [], []
    for i in range(n):
        if events:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        depth = None if depths is None else depths[i]
        states.append(system.process_frame(frames[i], depth=depth, timestamp=float(i)))
        if events:
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    return system, states, (ms if events else None)


def run_pipelined(frames, device, raw=None, events=False):
    """Frames through `process_frame_async` + `flush` of a fresh SlamSystem ->
    (system, ms between the ends of consecutive frames on the device or None)."""
    system = make_system(device, raw=raw)
    marks = []
    for i in range(frames.shape[0]):
        system.process_frame_async(frames[i], timestamp=float(i))
        if events:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    system.flush()
    if not events:
        return system, None
    torch.cuda.synchronize()
    return system, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def counted(table, what: str, fn):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after -> (fn's result, {kernel: launches}); every kernel must
    have launched."""
    for k in table:
        k["wrapper"].launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")
    return out, launches


def live_ate(system, poses, keep=None) -> float:
    from uwslam_tpu_torch.io.trajectory import ate_rmse
    from uwslam_tpu_torch.lie import se3

    _, est = system.export_trajectory()
    gt = se3.inverse(poses.cpu()).numpy()
    keep = slice(None) if keep is None else keep
    return ate_rmse(est[keep, :3, 3], gt[keep, :3, 3])


def phase_parity_live(ref, tgt, pts, cam, track_levels, what: str, describe: bool = True,
                       seed: int = 1):
    """Kernels at a path's B = 1 shapes against their plain versions: K1 on
    every level of the pyramid `ref`; at each track level K3 (C = 1, the FC
    reference pass), K2 (C = 1 and C = 3 texels) and `lm_evaluate` (FC) for
    the pair (ref, tgt) with `ref`'s points `pts`; with describe=True K3 at
    the descriptor taps of every level. `what` names the path in a failure.
    Returns ({kernel: max abs error}, what `time_pairs` takes: {kernel:
    (kernel, plain) callables at the largest shape}, their bounds and the
    library calls)."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.features import detect_multiscale
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.points import TrackPoints
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    dev = pts.uv.device
    frame = ref.images[0]                                   # (1, H, W)
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
                raise AssertionError(f"scharr {what} level {lvl} {nm}: {e} > {K1_ATOL}")
            err["scharr"] = max(err["scharr"], e)
    for lvl in track_levels:
        cam_l = cam.scaled(lvl)
        planes = (tgt.images[lvl], tgt.grad_x[lvl], tgt.grad_y[lvl])
        stacked, texels = torch.stack(planes, dim=1), ops.pack_texels(*planes)
        plane = tgt.images[lvl][:, None]
        p3d_edge = pts.p3d.clone()
        p3d_edge[0, :64] = edge_points(cam_l, 64).to(dev)
        uv_l = pts.uv * (1.0 / (1 << lvl))
        ref_int, ref_ok = k = ops.cuda_bilinear_sample(ref.images[lvl][:, None], uv_l)
        err["bilinear_sample"] = max(err["bilinear_sample"], compare(
            k, ops.bilinear_sample_plain(ref.images[lvl][:, None], uv_l), SAMPLE_ATOL,
            f"bilinear_sample {what} C=1 reference level {lvl}"))
        for T, p3d in ((torch.eye(4, device=dev)[None], p3d_edge), (T_move, pts.p3d)):
            p = ops.warp_and_sample_plain(stacked, p3d, T, cam_l)
            k = ops.warp_and_sample(texels, p3d, T, cam_l, texels=True)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, p, SAMPLE_ATOL, f"warp_sample {what} texels level {lvl}"))
            k = ops.warp_and_sample(plane, p3d, T, cam_l)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, (p[0][:, :1], p[1]), SAMPLE_ATOL, f"warp_sample {what} C=1 level {lvl}"))
            pts_l = TrackPoints(uv=pts.uv, p3d=p3d, intensity=ref_int[:, 0],
                                valid=pts.valid & ref_ok)
            err["lm_evaluate"] = max(err["lm_evaluate"], check_lm_evaluate(
                texels, pts_l, T, cam_l, f"lm_evaluate FC {what} level {lvl}"))
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
    calls["scharr"] = (lambda: ops.scharr_gradients_batched(frame),
                       lambda: ops.scharr_plain(frame))
    bounds["scharr"] = bound_scharr(frame)
    if not describe:
        return err, (calls, bounds, {})
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
            k, p, SAMPLE_ATOL, f"bilinear_sample {what} C=1 describe level {lvl}"))
        if lvl == 0:
            calls["bilinear_sample"] = (
                lambda i=image, q=uv: ops.cuda_bilinear_sample(i, q),
                lambda i=image, q=uv: ops.bilinear_sample_plain(i, q),
            )
            bounds["bilinear_sample"] = bound_sampler(k[1], 1, 8)
            library = {"bilinear_sample": grid_sample_call(image, uv)}
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


def tum_depth(cam, poses, plane_z: float = 2.0):
    """The plane's exact depth at each pose as TUM depth images: the uint16
    values (5000 per metre) as f32, which holds them exactly."""
    from uwslam_tpu_torch.utils.synthetic import plane_depth

    return torch.round(plane_depth(cam, poses, plane_z) * DEPTH_PER_METRE).clamp(0, 65535)


def corner_coordinates(depth, uv):
    """The (B, 4 N, 2) corner reads `_depth_at` hands kernel K3 for points uv
    (B, N, 2) on depth images (B, H, W)."""
    B, H, W = depth.shape
    u0 = torch.clamp(torch.floor(uv[..., 0]), 0, W - 2)
    v0 = torch.clamp(torch.floor(uv[..., 1]), 0, H - 2)
    corners = [torch.stack([u0 + du, v0 + dv], dim=-1)
               for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1))]
    return torch.stack(corners, dim=1).reshape(B, -1, 2)


def phase_depth_kernel(depths, pts):
    """K3 (C = 1) on depth images with holes, a step and last-column and
    last-row points against its plain version, bit for bit, at the live
    (B = 1) and offline (B = 96) shapes; `_depth_at` on the card against the
    CPU; times, bounds and `grid_sample` per shape."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.points import _depth_at

    awkward = depths.clone()
    H, W = awkward.shape[1:]
    awkward[:, :, W // 2:] = torch.round(awkward[:, :, W // 2:] * 1.6)   # a depth step
    awkward[:, 100:140, 80:160] = 0.0                                     # holes
    awkward[:, 300, 400] = 0.0
    uv = pts.uv.clone()
    edge = torch.tensor([[W - 1, 10.0], [W - 1, 57.25], [W - 1, H - 1], [33.5, H - 1],
                         [0.0, 0.0], [W // 2 - 0.5, 50.0], [W // 2, 50.0], [79.5, 120.0],
                         [399.5, 299.5], [W - 1 + 1e-3, 5.0], [-1e-3, 5.0]], device=uv.device)
    uv[:, : len(edge)] = edge
    errs, pairs, bounds, library = {}, {}, {}, {}
    for name, sl in (("live", slice(0, 1)), ("offline", slice(None))):
        image = awkward[sl][:, None].contiguous()
        corners = corner_coordinates(awkward[sl], uv[sl])
        k = ops.cuda_bilinear_sample(image, corners)
        errs[name] = compare(k, ops.bilinear_sample_plain(image, corners), SAMPLE_ATOL,
                             f"bilinear_sample on depth, {name} shape")
        if not bool(k[1].all()) or not bool((k[0] == 0).any()):
            raise AssertionError("corner reads must all be in bounds and meet holes")
        pairs[name] = (lambda i=image, q=corners: ops.cuda_bilinear_sample(i, q),
                       lambda i=image, q=corners: ops.bilinear_sample_plain(i, q))
        bounds[name] = bound_sampler(k[1], 1, 8)
        library[name] = grid_sample_call(image, corners)
    d, ok = _depth_at(awkward, uv, 1.0)
    d_cpu, ok_cpu = _depth_at(awkward.cpu(), uv.cpu(), 1.0)
    if not torch.equal(ok.cpu(), ok_cpu):
        raise AssertionError("_depth_at: the card's validity differs from the CPU's")
    want = [True] * 5 + [False, True, False, False, False, False]
    if ok[0, : len(edge)].tolist() != want:
        raise AssertionError(f"_depth_at at the edge points: {ok[0, :len(edge)].tolist()}")
    errs["depth_at_vs_cpu"] = float((d.cpu() - d_cpu).abs().max())
    if not errs["depth_at_vs_cpu"] <= 1e-6:
        raise AssertionError(f"_depth_at differs from the CPU by {errs['depth_at_vs_cpu']} m")
    errs["valid_share"] = float(ok.float().mean())
    return errs, time_pairs(pairs, bounds, library)


def phase_depth_paths(frames, poses, depths, table):
    """The offline IC chunk, `track_sequence` (FC) and the live path with the
    plane's depth frames and a wrong monocular depth (1, the plane is at 2)."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.sequence import SequenceTracker

    out = {}
    n_cpu = DEPTH_CPU_FRAMES
    trackers = {
        "chunk_ic": (bench.make_tracker(bench.CAM), False),
        "track_sequence_fc": (SequenceTracker(
            bench.CAM, levels=bench.LEVELS, track_levels=bench.TRACK_LEVELS,
            num_points=bench.NUM_POINTS, max_iters=bench.ITERS, mode="fc"), True),
    }
    for name, (tracker, sequential) in trackers.items():
        t0 = time.perf_counter()
        (T_rel, inliers, _), launches = counted(table, name, lambda: tracker(
            frames, mono_z=1.0, depth_frames=depths, sequential=sequential))
        card_s = time.perf_counter() - t0
        ate = bench.trajectory_ate(T_rel, poses)
        if not ate <= ATE_MAX:
            raise AssertionError(f"{name} with depth frames: ATE {ate} m > {ATE_MAX} m")
        T_cpu, _, _ = tracker(frames[:n_cpu].cpu(), mono_z=1.0,
                              depth_frames=depths[:n_cpu].cpu(), sequential=sequential)
        dev_cpu = float((se3.log(T_rel[: n_cpu - 1].cpu()) - se3.log(T_cpu)).abs().max())
        if not dev_cpu <= T_REL_ATOL:
            raise AssertionError(f"{name}: card vs CPU se3.log differs by {dev_cpu}")
        out[name] = {"ate": ate, "card_vs_cpu": dev_cpu, "cpu_frames": n_cpu,
                     "min_inliers": int(inliers.min()), "launches": launches,
                     "card_s": round(card_s, 2)}
    t0 = time.perf_counter()
    (system, states, _), launches = counted(table, "the live RGB-D path", lambda: run_live(
        frames, frames.device, depths=depths, mono_depth=1.0))
    bad = [(s.frame_id, s.status) for s in states if s.status != "ok"]
    if bad:
        raise AssertionError(f"live RGB-D frames not ok: {bad[:10]}")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX:
        raise AssertionError(f"live RGB-D ATE {ate} m > {LIVE_ATE_MAX} m")
    if system.graph_replays:
        raise AssertionError("frames with depth images must take the synchronous path")
    out["live_rgbd"] = {"ate": ate, "keyframes": int(sum(s.is_keyframe for s in states)),
                        "launches": launches, "card_s": round(time.perf_counter() - t0, 2)}
    return out


def phase_graph_vs_eager(frames, n: int = 4):
    """Each of the first n pipelined frames: the graph's replay against the
    eager megastep on the same inputs, every output bit-equal."""
    from uwslam_tpu_torch.ops.graph import tree_leaves

    system = make_system(frames.device)
    system.process_frame(frames[0], timestamp=0.0)
    eager = system._build_step_plain()
    compared = 0
    for i in range(1, n + 1):
        prev_pyr, prev_pts, _ = system._prev
        want = eager(frames[i], prev_pyr, prev_pts, system._velocity, system._T_wc,
                     system.keyframes.latest.T_wc, system._eye)
        system.process_frame_async(frames[i], timestamp=float(i))
        rec = system._pipe_queue[-1]
        got = (rec["pyr"], rec["pts"], system._velocity, system._T_wc, rec["diag"])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"frame {i}: graph replay differs from the eager megastep by "
                    f"{float((a.float() - b.float()).abs().max())}")
            compared += 1
    system.flush()
    if system.graph_replays != n:
        raise AssertionError(f"{system.graph_replays} graph replays, expected {n}")
    return {"frames": n, "tensors_bit_equal": compared}


def states_vs_cpu(card, cpu, what: str) -> float:
    ids = [s.frame_id for s in card.trajectory]
    if ids != list(range(len(ids))):
        raise AssertionError(f"{what}: frame ids out of order: {ids}")
    return card_vs_cpu(card.trajectory, cpu.trajectory, what)


def phase_pipelined(frames, poses, table, sync_ate: float):
    """96 frames through the pipelined loop on the card with fresh launch
    counts, against the CPU's pipelined run and the synchronous run's ATE."""
    t0 = time.perf_counter()
    (system, frame_ms), launches = counted(table, "the pipelined path", lambda: run_pipelined(
        frames, frames.device, events=True))
    card_s = time.perf_counter() - t0
    n = frames.shape[0]
    if len(system.trajectory) != n:
        raise AssertionError(f"{len(system.trajectory)} states for {n} frames")
    if system.graph_replays < PIPE_MIN_GRAPH_FRAMES:
        raise AssertionError(f"only {system.graph_replays} of {n} frames went through the "
                             f"graph, expected at least {PIPE_MIN_GRAPH_FRAMES}")
    bad = [(s.frame_id, s.status) for s in system.trajectory if s.status != "ok"]
    if bad:
        raise AssertionError(f"pipelined frames not ok: {bad[:10]}")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX or not abs(ate - sync_ate) <= PIPE_VS_SYNC_ATE:
        raise AssertionError(f"pipelined ATE {ate} m (synchronous {sync_ate} m)")
    t0 = time.perf_counter()
    cpu, _ = run_pipelined(frames.cpu(), "cpu")
    dev_cpu = states_vs_cpu(system, cpu, "pipelined loop")
    return {
        "launches": launches, "graph_replays": system.graph_replays, "ate": ate,
        "sync_ate": sync_ate, "card_vs_cpu": dev_cpu,
        "keyframes": [s.frame_id for s in system.trajectory if s.is_keyframe],
        "card_s": round(card_s, 2), "cpu_s": round(time.perf_counter() - t0, 2),
    }, frame_ms


def phase_pipelined_reloc(noisy, poses):
    """The relocalization sequence through the pipelined loop, on the card
    and on the CPU: statuses, keyframes and poses must agree frame by frame
    (`states_vs_cpu`), which holds the late failure, the drain and the
    re-entry to the port's CPU run; the ATE bars come second."""
    system, _ = run_pipelined(noisy, noisy.device)
    t0 = time.perf_counter()
    cpu, _ = run_pipelined(noisy.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0
    dev_cpu = states_vs_cpu(system, cpu, "pipelined relocalization run")
    status = [s.status for s in system.trajectory]
    first_bad = next(i for i, st in enumerate(status) if st != "ok")
    last_bad = max(i for i, st in enumerate(status) if st != "ok")
    if first_bad not in (NOISE_FRAME, NOISE_FRAME + 1):
        raise AssertionError(f"first frame not ok is {first_bad}: {status[first_bad]}")
    drained = status[first_bad + 1: last_bad + 1]
    if not drained or set(drained) != {"lost"} or len(drained) > 2 * system._pipe_batch + 1:
        raise AssertionError(f"frames drained after the failure: {drained}")
    if system._pipe_broken or set(status[last_bad + 1:]) != {"ok"}:
        raise AssertionError("the loop did not re-enter after the drain")
    if system.graph_replays < len(status) - len(drained) - 4:
        raise AssertionError(f"only {system.graph_replays} frames went through the graph")
    keep = np.array([st == "ok" for st in status])
    ate = live_ate(system, poses, keep)
    if not ate <= PIPE_RELOC_ATE_MAX:
        raise AssertionError(f"pipelined relocalization run ATE {ate} m > {PIPE_RELOC_ATE_MAX}")
    # Each side of the step alone is an ordinary tracked trajectory.
    index = np.arange(len(status))
    sides = {"before": live_ate(system, poses, index < first_bad),
             "after": live_ate(system, poses, index > last_bad)}
    for side, side_ate in sides.items():
        if not side_ate <= LIVE_ATE_MAX:
            raise AssertionError(f"ATE {side} the drained frames {side_ate} m > {LIVE_ATE_MAX}")
    est = np.stack([s.T_wc for s in system.trajectory])[last_bad + 2:]
    gt = torch.linalg.inv(poses.cpu()).numpy()[last_bad + 2:]
    step_err = float(np.abs(np.diff(est[:, :3, 3], axis=0) - np.diff(gt[:, :3, 3], axis=0)).max())
    if not step_err <= 5e-3:
        raise AssertionError(f"per-frame motion after the re-entry is off by {step_err} m")
    return {"first_not_ok": [first_bad, status[first_bad]], "drained_as_lost": len(drained),
            "re_entered_at": last_bad + 1, "graph_replays": system.graph_replays,
            "ate_over_ok_frames": ate, "ate_over_ok_frames_cpu": live_ate(cpu, poses, keep),
            "ate_before": sides["before"], "ate_after": sides["after"],
            "card_vs_cpu": dev_cpu, "step_err_after": step_err, "cpu_s": round(cpu_s, 2)}


def phase_pipelined_timing(frames, frame_ms, sync: dict, table):
    """The pipelined loop's frames/s and per-frame time after the warm-up
    frames (CUDA events at the end of each call of phase 11b's run; the host
    never waits for the frame it has just dispatched). Then one fresh system:
    a steady window of frames under the profiler with event marks around it,
    which gives, from that one window, the device busy time, the graph
    launches, every device launch and the idle share; and each kernel's
    launches counted by its name in the profile, which must equal what the
    wrappers counted over the window (`CapturedStep` adds a remembered count
    per replay: this is the measurement that holds it). Beside phase 9's
    synchronous loop. Tracing each of a graph's kernels slows the window
    down, so its idle share is an upper bound; `idle_share_vs_unprofiled`
    divides the same busy time by phase 11b's mean frame time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steady = frame_ms[LIVE_WARMUP:]
    system = make_system(frames.device)
    for i in range(LIVE_WARMUP):
        system.process_frame_async(frames[i], timestamp=float(i))
    torch.cuda.synchronize()
    reps = PIPE_PROFILED_FRAMES
    replays_before = system.graph_replays
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for k in table:
        k["wrapper"].launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(LIVE_WARMUP, LIVE_WARMUP + reps):
            system.process_frame_async(frames[i], timestamp=float(i))
        end.record()
        torch.cuda.synchronize()
    counted_by_wrappers = {k["name"]: k["wrapper"].launches for k in table}
    window_ms = start.elapsed_time(end) / reps
    replays = system.graph_replays - replays_before
    if replays != reps:
        raise AssertionError(f"{replays} of the {reps} profiled frames went through the graph")
    (step,) = system._steps.values()
    system.flush()
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device time in the pipelined window")
    seen = {name: sum(e.count for e in kernels if symbol in e.key)
            for name, symbol in KERNEL_SYMBOLS.items()}
    if seen != counted_by_wrappers or not all(seen.values()):
        raise AssertionError(f"launches in the profiled window: the profiler saw {seen} by "
                             f"kernel name, the wrappers counted {counted_by_wrappers}")
    graph_launches = sum(e.count for e in averages if e.key == "cudaGraphLaunch") / reps
    return {
        "frames_per_s": len(steady) / (sum(steady) / 1e3),
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": float(np.percentile(steady, 90)),
        "profiled_window": {
            "frames": reps, "ms_per_frame": window_ms,
            "device_busy_ms_per_frame": busy_ms,
            "idle_share": 1.0 - busy_ms / window_ms,
            "device_launches_per_frame": sum(e.count for e in kernels) / reps,
            "graph_launches_per_frame": graph_launches,
            "kernel_launches_seen_by_name": seen,
            "kernel_launches_counted": counted_by_wrappers,
            "kernel_launches_per_replay_at_capture": dict(zip(
                (k["name"] for k in table), step.kernel_launches)),
        },
        "idle_share_vs_unprofiled": 1.0 - busy_ms / statistics.mean(steady),
        "synchronous_same_run": {k: sync[k] for k in (
            "frames_per_s", "latency_ms_median", "latency_ms_p90",
            "device_busy_ms_per_frame", "idle_share", "launches_per_frame")},
    }


def write_euroc_dataset(frames, poses, raw, root: Path):
    """8-bit PGM frames in the EUROC layout (mav0/cam0/data/<ns>.pgm), its
    ground-truth CSV and a calibration XML with the radtan coefficients."""
    from uwslam_tpu_torch.lie import se3

    data = root / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    imgs = frames.clamp(0, 255).to(torch.uint8).cpu().numpy()
    q, t = (x.numpy() for x in se3.to_quaternion_translation(se3.inverse(poses.cpu())))
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz\n"]
    for i, img in enumerate(imgs):
        ns = int(1e9 * (1.0 + 0.05 * i))
        h, w = img.shape
        (data / f"{ns}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        rows.append(f"{ns},{t[i, 0]},{t[i, 1]},{t[i, 2]},"
                    f"{q[i, 0]},{q[i, 1]},{q[i, 2]},{q[i, 3]}\n")
    (root / "gt.csv").write_text("".join(rows))
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>{raw.width}</in_width><in_height>{raw.height}</in_height>
<out_width>{raw.width}</out_width><out_height>{raw.height}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.fx} {raw.fy} {raw.cx} {raw.cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.k1} {raw.k2} {raw.p1} {raw.p2}</data></rectification>
</opencv_storage>
""")
    return root / "mav0", root / "calib.xml", root / "gt.csv"


def run_cli(argv, what: str) -> dict:
    """The port's CLI in this process; it must exit 0 and print its ATE."""
    from uwslam_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+-]+) m", buf.getvalue())
    if rc != 0 or m is None:
        raise AssertionError(f"CLI {what}: exit {rc}, output {buf.getvalue()!r}")
    return {"ate": float(m.group(1)), "s": round(time.perf_counter() - t0, 2)}


def phase_rectification(poses, table):
    """Distorted frames through the pipelined loop on the card and the CPU,
    and through the CLI with --euroc."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.utils.synthetic import render_plane_view_distorted

    raw = replace(bench.CAM, **RECT_DISTORTION)
    poses = poses[:RECT_FRAMES]
    frames = render_plane_view_distorted(raw, poses, bench.PLANE_Z)
    # The kernels at this path's shapes first: the cropped region of interest
    # is no multiple of the kernels' blocks and its rows have another stride.
    probe = make_system(frames.device, raw=raw)
    pyrs = [probe._ingest_pyramid(frames[i]) for i in (0, 1)]
    shapes = [list(im.shape[1:]) for im in pyrs[0].images]
    if all(w % 32 == 0 and h % 8 == 0 for h, w in shapes):
        raise AssertionError(f"the rectified levels {shapes} do not test a ragged block")
    parity, _ = phase_parity_live(*pyrs, probe._select_points(pyrs[0]), probe.cam,
                                  probe.config.tracker.track_levels, "rectified B=1")
    del probe, pyrs
    (system, _), launches = counted(table, "the rectified path", lambda: run_pipelined(
        frames, frames.device, raw=raw))
    cpu, _ = run_pipelined(frames.cpu(), "cpu", raw=raw)
    if system._roi != cpu._roi or system.cam != cpu.cam:
        raise AssertionError(f"ROI or camera differ: card {system._roi} {system.cam}, "
                             f"CPU {cpu._roi} {cpu.cam}")
    if system._rect_map is None or system._roi[2:] == (raw.width, raw.height):
        raise AssertionError("the distorted calibration did not rectify and crop")
    if system.graph_replays != RECT_FRAMES - 1:
        raise AssertionError(f"{system.graph_replays} rectified frames went through the graph")
    dev_cpu = states_vs_cpu(system, cpu, "rectified pipelined loop")
    ate = live_ate(system, poses)
    if not ate <= RECT_ATE_MAX:
        raise AssertionError(f"rectified ATE {ate} m > {RECT_ATE_MAX} m")
    with tempfile.TemporaryDirectory() as tmp:
        mav, calib, gt = write_euroc_dataset(frames, poses, raw, Path(tmp))
        cli = run_cli(["-d", str(mav), "--euroc", "-c", str(calib), "--euroc-gt", str(gt),
                       "--levels", "3", "--track-levels", "1,0", "--mono-depth", "2.0",
                       "--platform", "cuda", "--trajectory-out", str(Path(tmp) / "est.txt")],
                      "--euroc")
    if not cli["ate"] <= RECT_ATE_MAX:
        raise AssertionError(f"CLI --euroc: ATE {cli['ate']} m > {RECT_ATE_MAX} m")
    return {"parity_max_abs_err": parity, "parity_level_shapes": shapes,
            "roi": list(system._roi), "ate": ate, "card_vs_cpu": dev_cpu,
            "graph_replays": system.graph_replays, "launches": launches, "cli_euroc": cli}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is visible; nothing was run")
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.image.pyramid import build_pyramid, build_pyramid_batched
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

    lcfg = live_config().tracker
    live_pyrs = [build_pyramid(frames[i], levels=lcfg.pyramid_levels) for i in (0, 1)]
    live_pts = topk_gradient_points(live_pyrs[0].images[0], live_pyrs[0].grad_mag[0], cam,
                                    num_points=lcfg.num_points, mono_z=lcfg.mono_depth)
    errs_live, live_calls = phase_parity_live(*live_pyrs, live_pts, cam, lcfg.track_levels,
                                              "B=1")
    del live_pyrs
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

    t0 = time.perf_counter()
    depths = tum_depth(cam, poses)
    depth_errs, depth_times = phase_depth_kernel(depths, pts)
    say("10 depth (kernel)", json.dumps(depth_errs) + "; per call: " + json.dumps(depth_times)
        + f"; {gpu}")
    seq_pyrs = [build_pyramid(frames[i], levels=bench.LEVELS) for i in (0, 1)]
    seq_pts = topk_gradient_points(seq_pyrs[0].images[0], seq_pyrs[0].grad_mag[0], cam,
                                   depth_image=depths[:1], num_points=bench.NUM_POINTS,
                                   mono_z=1.0)
    errs_seq, _ = phase_parity_live(*seq_pyrs, seq_pts, cam, bench.TRACK_LEVELS,
                                    "track_sequence B=1", describe=False)
    del seq_pyrs
    say("10 depth (parity at track_sequence's shapes: B = 1, 5 levels, FC)",
        "max abs error vs plain: " + json.dumps(errs_seq))
    depth_paths = phase_depth_paths(frames, poses, depths, table)
    say("10 depth (paths)", json.dumps(depth_paths) + f"; {time.perf_counter() - t0:.1f} s")
    del depths

    t0 = time.perf_counter()
    say("11a graph vs eager", json.dumps(phase_graph_vs_eager(frames)))
    pipelined, pipe_ms = phase_pipelined(frames, poses, table, live["ate"])
    say("11b pipelined loop", json.dumps(pipelined))
    say("11c pipelined relocalization", json.dumps(phase_pipelined_reloc(noisy, poses)))
    pipe_times = phase_pipelined_timing(frames, pipe_ms, live_times, table)
    say("11d pipelined timing", json.dumps(pipe_times) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rectified = phase_rectification(poses, table)
    say("12 rectification", json.dumps(rectified) + f"; {time.perf_counter() - t0:.1f} s")

    live_k = live_times["kernels_at_live_shapes"]
    depth_launches = {k["name"]: sum(depth_paths[path]["launches"][k["name"]]
                                     for path in depth_paths) for k in table}
    kernels = [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"],
         "launches": main_path["launches"][k["name"]],
         "launches_live": live["launches"][k["name"]],
         "launches_depth": depth_launches[k["name"]],
         "launches_pipelined": pipelined["launches"][k["name"]],
         "launches_rectified": rectified["launches"][k["name"]],
         "max_abs_err": max(e[k["name"]] for e in (
             errs, errs_live, errs_seq, rectified["parity_max_abs_err"])),
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
    ]
    sampler = next(k for k in kernels if k["name"] == "bilinear_sample")
    sampler["max_abs_err"] = max(sampler["max_abs_err"], depth_errs["live"],
                                 depth_errs["offline"])
    for shape, t in depth_times.items():       # K3 with C = 1 on depth images
        sampler.update({f"ms_depth_{shape}": t["device_ms"],
                        f"plain_ms_depth_{shape}": t["plain_device_ms"],
                        f"bound_ms_depth_{shape}": t["bound_ms"],
                        f"library_ms_depth_{shape}": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
