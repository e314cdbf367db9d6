"""Per-operation micro benchmark of the port on one card: device time beside
the card's bound.

    python -m uwslam_tpu_torch.micro [--out MICRO_TORCH_r12.json] [--platform cuda|cpu]

Counterpart of `benchmarks/micro.py` (the JAX package's, whose op list and
shapes it keeps: a batch of 96 frames of 480 x 640, 2048 points per frame,
65,536 twists), with the pyramid kernel at the offline, live, rectified-ROI
and EUROC shapes beside `F.conv2d` of level 0's gradients, K1 alone on the
offline pyramid's coarser levels, the kernels at the rectified EUROC
shapes (`k1_level_cases`, `euroc_cases`) and the LM update `lm_step` at
the live frame's 1 pair and the offline chunk's pairs (`lm_step_cases`). Each op is timed by device time:
one warm-up call traced and dropped (`warm_profile`), then
`REPS` calls under `torch.profiler`, the sum of the kernels' device time
over them divided by `REPS` (CUDA events around back-to-back calls where a
profile records no kernel, marked so). Its bound is the larger of the bytes
it must move (each input read once, each output written once) over 3.35 TB/s
and its floating-point operations over 67 TFLOP/s (the H100 SXM's HBM3 rate
and f32 rate outside the tensor cores), both reckoned from the shapes and,
for the samplers, from the points this run's data leaves valid. A kernel of
the port is timed beside its plain PyTorch version; where one PyTorch call
computes the same function (`grid_sample`, `torch.linalg.solve`), it is timed
too, and used nowhere in the port. The output is one JSON object with the
card's name and power limit (nvidia-smi), printed and written to `--out`.
With `--platform cpu` (and `--batch` for a smaller batch) every op runs once
on the CPU and nothing is timed: a check that the cases build and run.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
B, H, W = 96, 480, 640
N_PTS = 2048
N_TWISTS = 65536
EUROC_W, EUROC_H = 736, 480              # eval.py's EUROC calibration, rectified size
EUROC_F = (458.654, 457.296)             # its pinhole focal lengths
REPS = 20
LM_STEP_ITERS = 10       # an lm_step row's max_iters: its pairs stay active
LM_STEP_STOCK = 128      # copies of its state: more than the calls of its timings
WARM_LAUNCHES = 1024     # small kernels traced and dropped before a profile's window
# Operations per output element, counted from the kernels' sources: K1 per
# pixel; K2, K3 per valid point (warp 18, projection 6, taps 10, blend 13 per
# channel); lm_evaluate per valid point (K2's, the residual, weight and cost
# 11, w J 6, 21 + 6 multiply-adds of the sums 54, 3 more sums; FC: the
# Jacobian 40; affine brightness: the residual's 3 more, w J 2 more, 36 + 8
# multiply-adds of the sums in place of 21 + 6).
K1_FLOPS = 25
PYRAMID_MEAN_FLOPS = 4
WARP_FLOPS, TAPS_FLOPS, BLEND_FLOPS = 24, 10, 13
LM_FLOPS_IC = WARP_FLOPS + TAPS_FLOPS + BLEND_FLOPS + 11 + 6 + 54 + 3
LM_FLOPS_FC = LM_FLOPS_IC + 2 * BLEND_FLOPS + 40
LM_FLOPS_AFFINE = 3 + 2 + 2 * (36 + 8 - 21 - 6)
# lm_step per pair, counted from csrc/lm_step.cu: err, the accept test and
# the damping 4; the damped diagonal 3 n and off-diagonal 2 per entry; the
# Cholesky sum over i of (i + 1)^2; the two substitutions 2 n^2; |delta|
# 2 n + 1; se3 exp 165 (theta^2 6, its coefficients 9 with sin and cos, W^2
# 54, R and the left Jacobian 72, t 18, sqrt 1, the three divisions 5); the
# 4 x 4 compose 128; normalize 281 (Frobenius 20, rescale 9, two Newton steps
# of 126); the brightness 2.
LM_STEP_POSE_FLOPS = 165 + 128 + 281


def lm_step_flops(n: int) -> int:
    return (4 + 3 * n + n * (n - 1) + sum((i + 1) ** 2 for i in range(n)) + 2 * n * n
            + 2 * n + 1 + LM_STEP_POSE_FLOPS + (2 if n == 8 else 0))


def bound(n_bytes: float, flops: float) -> dict:
    """The least ms the card could take: the larger of bytes over its memory
    rate and operations over its f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def warm_profile(run, warm, cuda: bool = True, with_stack: bool = False):
    """A `torch.profiler.profile` that holds `run()` alone: the profiler
    starts tracing before a warm-up step (on a card WARM_LAUNCHES one-element
    adds, then `warm()`) and records from its end. On an H100 a profile whose
    tracing starts on the work it is to record comes back short of its first
    kernel records, more of them the more profiles the process has taken: an
    offline chunk's 11,090 kernels lost 0, 1, 3 and 4 records in four
    windows, and its first, the one pyramid launch, from the second window
    on; with a chunk in the warm-up step four windows of four held all
    11,090."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, with_stack=with_stack)
    prof.prepare_trace()
    try:
        if cuda:
            one = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
            for _ in range(WARM_LAUNCHES):
                one.add_(1.0)
        warm()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.start_trace()
    try:
        run()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop_trace()
    return prof


def kernel_profile(fn, reps: int = REPS, attempts: int = 3) -> tuple[float, float] | None:
    """(device ms, kernel launches) per call of fn: the profiler's kernel time
    and kernel count over `reps` calls after a warm-up call (`warm_profile`);
    None where no one of `attempts` profiles records a kernel."""
    from torch.autograd import DeviceType

    def run():
        for _ in range(reps):
            fn()

    for _ in range(attempts):
        prof = warm_profile(run, fn)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kernels)
        if us > 0:
            return us / 1e3 / reps, sum(e.count for e in kernels) / reps
    return None


def device_ms(fn, reps: int = REPS, attempts: int = 3) -> tuple[float, str]:
    """(device ms per call, timer): the profiler's kernel time over `reps`
    calls after a warm-up call; CUDA events if no profile records a kernel."""
    profiled = kernel_profile(fn, reps, attempts)
    if profiled is not None:
        return profiled[0], "profiler"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "cuda_events"


def grid_sample_call(stack, uv):
    """`F.grid_sample` set up for K3's function on (B, C, H, W) at uv
    (B, N, 2): the normalized grid is built here, outside any timing."""
    scale = torch.tensor([2.0 / (stack.shape[-1] - 1), 2.0 / (stack.shape[-2] - 1)],
                         device=uv.device)
    grid = (uv * scale - 1.0)[:, None]
    return lambda: torch.nn.functional.grid_sample(
        stack, grid, mode="bilinear", padding_mode="zeros", align_corners=True)[:, :, 0]


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


def bound_lm_evaluate(pts_valid, ok, fc: bool, affine: bool = False) -> dict:
    """Per point 12 B and the validity byte; per reference-valid point the
    projection decides; per valid point the reference intensity (4 B), the
    taps (IC 16 B, FC 48 B of the texels' three channels) and in IC the
    Jacobian row (24 B); per pair the pose (64 B), sigma (4 B) and the 45
    sums written (with affine brightness the pair's (a, b), 8 B, and 75
    sums). IC with every point valid: 57 B per point."""
    B, N = ok.shape
    n_ok = int((pts_valid & ok).sum())
    per_pair = 64 + 4 + (8 + 75 * 4 if affine else 45 * 4)
    n_bytes = B * N * 13 + n_ok * (4 + (48 if fc else 16 + 24)) + B * per_pair
    flops = (LM_FLOPS_FC if fc else LM_FLOPS_IC) + (LM_FLOPS_AFFINE if affine else 0)
    return bound(n_bytes, n_ok * flops)


def brightness(B: int, dev, seed: int = 7) -> torch.Tensor:
    """A non-zero affine brightness (a, b) per pair, (B, 2), from a seed:
    a ~ 0.05 N(0, 1), b ~ 5 N(0, 1) gray levels."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 2, generator=gen) * torch.tensor([0.05, 5.0])).to(dev)


def bound_scharr(images) -> dict:
    """K1: one plane read, three written."""
    return bound(images.numel() * 4 * 4, images.numel() * K1_FLOPS)


def bound_pyramid(images, levels: int) -> dict:
    """The pyramid kernel on (B, H, W): level 0 read once; gx, gy, |g| of
    every level and the images of levels 1 .. levels-1 written once; K1's
    operations per pixel of every level and 4 (three adds, a multiply) per
    pixel of a 2x2 mean."""
    pix = [images.numel() >> (2 * level) for level in range(levels)]
    return bound(4 * (pix[0] + 3 * sum(pix) + sum(pix[1:])),
                 K1_FLOPS * sum(pix) + PYRAMID_MEAN_FLOPS * sum(pix[1:]))


def scharr_conv_call(images):
    """The nearest library yardstick of the pyramid kernel: `F.conv2d` of
    level 0's Scharr gx and gy (one 2-channel 3x3 convolution, / 32) on
    edge-replicated frames, cuDNN's TF32 off. It computes level 0's two
    gradients only, not the means, |g| or the coarser levels; the padded
    frames are made here, outside any timing."""
    k = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                     device=images.device) / 32.0
    weight = torch.stack([k, k.t()])[:, None].contiguous()          # (2, 1, 3, 3)
    padded = torch.nn.functional.pad(images[:, None], (1, 1, 1, 1), mode="replicate")
    return lambda: torch.nn.functional.conv2d(padded, weight)


def pyramid_case(op: str, images, levels: int) -> dict:
    """The pyramid kernel on `images` at `levels` beside its plain version
    and the convolution yardstick."""
    from . import ops

    return {"op": op, "kernel": "pyramid",
            "fn": lambda: ops.cuda_build_pyramid(images, levels),
            "plain": lambda: ops.pyramid_plain(images, levels),
            "library": ("conv2d_scharr_level0", scharr_conv_call(images)),
            "note": f"all {levels} levels in one launch", **bound_pyramid(images, levels)}


def k1_level_cases(frames) -> list[dict]:
    """K1 on the offline pyramid's levels 1-4 (96 x 240 x 320 ... 96 x 30 x
    40 at the default batch), each level the 2 x 2 mean of the one above."""
    from . import ops
    from .image.pyramid import downsample2x

    out, img = [], frames
    for level in range(1, 5):
        img = downsample2x(img)
        b, h, w = img.shape
        out.append({"op": f"scharr_l{level}(b{b},{h}x{w})", "kernel": "K1",
                    "fn": lambda i=img: ops.scharr_gradients_batched(i),
                    "plain": lambda i=img: ops.scharr_plain(i), **bound_scharr(img)})
    return out


def euroc_cases(dev) -> list[dict]:
    """The kernels at the rectified EUROC shapes that eval.py's configs 3, 4
    and 8-10 run (one 480 x 736 frame, B = 1): K1 on its 5 levels; at level
    0 K2 on the target's texels (C = 3: config 3's `--affine` path), K3 on
    the texels at the points (C = 3, as the depth refinement samples) and
    `lm_evaluate` FC (Huber), for 2048 top-K points of a plane frame pair
    at the bench's relative pose."""
    from . import bench, ops
    from .camera.model import PinholeCamera
    from .image.pyramid import build_pyramid
    from .lie import se3
    from .tracking.photometric import _affine_residual
    from .tracking.points import topk_gradient_points
    from .tracking.robust import WeightKind, mad_sigma

    cam = PinholeCamera(fx=EUROC_F[0], fy=EUROC_F[1], cx=(EUROC_W - 1) / 2.0,
                        cy=(EUROC_H - 1) / 2.0, width=EUROC_W, height=EUROC_H)
    poses = bench.bench_poses(2, device=dev)
    frames = bench.bench_frames(poses, cam)
    ref, tgt = (build_pyramid(frames[i], levels=bench.LEVELS) for i in (0, 1))
    pts = topk_gradient_points(ref.images[0], ref.grad_mag[0], cam, num_points=N_PTS,
                               mono_z=bench.MONO_Z)
    T = se3.compose(poses[1:], se3.inverse(poses[:1])).contiguous()
    planes = (tgt.images[0], tgt.grad_x[0], tgt.grad_y[0])
    texels, stacked = ops.pack_texels(*planes), torch.stack(planes, dim=1)
    ok2 = ops.warp_and_sample(texels, pts.p3d, T, cam, texels=True)[1]
    ok3 = ops.cuda_bilinear_sample(texels, pts.uv, texels=True)[1]
    vals, ok = ops.warp_and_sample(tgt.images[0][:, None], pts.p3d, T, cam)
    valid = pts.valid & ok
    r = torch.where(valid, vals[:, 0] - pts.intensity, 0.0)
    sigma = mad_sigma(r, valid)
    lm_args = (pts.intensity, pts.valid, sigma, cam, WeightKind.HUBER)
    evaluator = ops.LMEvaluator(texels, pts.p3d, *lm_args)
    ab = brightness(1, dev)
    sigma_ab = mad_sigma(_affine_residual(r, pts.intensity, ab, valid), valid)
    ab_args = (pts.intensity, pts.valid, sigma_ab, cam, WeightKind.HUBER)
    evaluator_ab = ops.LMEvaluator(texels, pts.p3d, *ab_args, affine=True)
    out = [pyramid_case(f"euroc_pyramid5(1x{EUROC_H}x{EUROC_W})", frames[:1].contiguous(),
                        bench.LEVELS)]
    for level, img in enumerate(ref.images):
        _, h, w = img.shape
        out.append({"op": f"euroc_scharr_l{level}(1x{h}x{w})", "kernel": "K1",
                    "fn": lambda i=img: ops.scharr_gradients_batched(i),
                    "plain": lambda i=img: ops.scharr_plain(i), **bound_scharr(img)})
    shape = f"1x{EUROC_H}x{EUROC_W},n{N_PTS}"
    return out + [
        {"op": f"euroc_warp_texels_c3({shape})", "kernel": "K2",
         "fn": lambda: ops.warp_and_sample(texels, pts.p3d, T, cam, texels=True),
         "plain": lambda: ops.warp_and_sample_plain(texels, pts.p3d, T, cam, texels=True),
         "note": "one pair, the --affine path's C = 3", **bound_sampler(ok2, 3, 12)},
        {"op": f"euroc_sample_texels_c3({shape})", "kernel": "K3",
         "fn": lambda: ops.cuda_bilinear_sample(texels, pts.uv, texels=True),
         "plain": lambda: ops.bilinear_sample_texels_plain(texels, pts.uv),
         "library": ("grid_sample", grid_sample_call(stacked, pts.uv)),
         **bound_sampler(ok3, 3, 8)},
        {"op": f"euroc_lm_evaluate(fc,{shape})", "kernel": "lm_evaluate",
         "fn": lambda: evaluator(T),
         "plain": lambda: ops.lm_evaluate_plain(texels, pts.p3d, T, *lm_args),
         "note": "one FC LM evaluation of one pair on the target's texels",
         **bound_lm_evaluate(pts.valid, ok, fc=True)},
        {"op": f"euroc_lm_evaluate_affine(fc,{shape})", "kernel": "lm_evaluate",
         "fn": lambda: evaluator_ab(T, ab),
         "plain": lambda: ops.lm_evaluate_plain(texels, pts.p3d, T, *ab_args, ab=ab),
         "note": "the same with affine brightness (--affine, configs 2 and 3)",
         **bound_lm_evaluate(pts.valid, ok, fc=True, affine=True)},
    ]


def bound_lm_step(B: int, affine: bool) -> dict:
    """lm_step on B pairs taking an accepted step: per pair the candidate's
    sums, its pose, error, damping, k and done read, and the best state's
    sums, both poses, error, count, damping, k and done written (with affine
    brightness (a, b) read and both brightnesses written)."""
    width = 80 if affine else 48
    read = 4 * width + 64 + 4 + 4 + 8 + 1 + (8 if affine else 0)
    write = 4 * width + 2 * 64 + 4 + 8 + 4 + 8 + 1 + (16 if affine else 0)
    return bound(B * (read + write), B * lm_step_flops(8 if affine else 6))


class _Given:
    """Stands in for an `LMEvaluator` whose every result is `sums`."""

    def __init__(self, sums, affine: bool):
        from .ops.cuda_track import lm_layout

        self.sums, self.affine, self.layout = sums, affine, lm_layout(affine)

    def __call__(self, T, ab=None):
        return self.sums


def lm_step_pair(state, sums, affine: bool):
    """(kernel, plain) calls of one LM update of `state` (an `ops.LMLoop`)
    from the candidate's `sums`: `ops.lm_step` and the plain step
    (`tracking.photometric.lm_step`) on the same state; on the CPU, where the
    kernel does not run, the plain step in its place. A launch updates its
    state in place, so each kernel call takes the next of LM_STEP_STOCK
    copies of `state`, made beforehand."""
    from . import ops
    from .ops.graph import tree_clone
    from .tracking import photometric

    _, evaluate, solve = photometric._fused_steps(_Given(sums, affine), state.T,
                                                  state.ab if affine else None)

    def plain():
        return photometric.lm_step(state, evaluate(state.T, state.ab), solve, LM_STEP_ITERS,
                                   1e-4, affine)

    if sums.device.type != "cuda":
        return plain, plain
    stock = itertools.cycle([tree_clone(state) for _ in range(LM_STEP_STOCK)])

    def kernel():
        ops.lm_step(next(stock), sums, LM_STEP_ITERS, 1e-4)

    return kernel, plain


def lm_step_cases(dev, pairs: tuple[int, ...]) -> list[dict]:
    """One LM update (`lm_step_pair`) of 1 pair (the live frame) and of the
    offline chunk's pairs, pose alone and with affine brightness. Every pair
    takes the full update: an accepted step of an SPD system (sums in
    `lm_evaluate`'s layout, from a seed)."""
    from . import ops
    from .lie import se3

    out = []
    for affine in (False, True):
        lay = ops.cuda_track.lm_layout(affine)
        n = lay.n
        for b in pairs:
            gen = torch.Generator().manual_seed(b + 10 * n)
            A = torch.randn(b, n, n, generator=gen)
            sums = torch.zeros(b, lay.width)
            sums[:, lay.H] = (A @ A.transpose(1, 2) * 50.0 + 5.0 * torch.eye(n)).reshape(b, -1)
            sums[:, lay.b] = torch.randn(b, n, generator=gen) * 5.0
            sums[:, lay.cost] = sums[:, lay.count] = float(N_PTS)
            sums = sums.to(dev)
            state = ops.LMLoop(
                T=se3.exp(torch.randn(b, 6, generator=gen) * 0.05).to(dev),
                ab=torch.randn(b, 2, generator=gen).to(dev),
                T_best=se3.exp(torch.randn(b, 6, generator=gen) * 0.05).to(dev),
                ab_best=torch.randn(b, 2, generator=gen).to(dev),
                s_best=(sums * 2.0,), error=torch.full((b,), 2.0, device=dev),
                lam=torch.full((b,), 1e-3, device=dev),
                k=torch.zeros(b, dtype=torch.int64, device=dev),
                done=torch.zeros(b, dtype=torch.bool, device=dev),
                n_inlier=torch.full((b,), N_PTS, dtype=torch.int64, device=dev))
            fn, plain = lm_step_pair(state, sums, affine)
            out.append({"op": f"lm_step{'_affine' if affine else ''}(b{b})", "kernel": "lm_step",
                        "fn": fn, "plain": plain,
                        "note": ("the live frame's update: launch-bound, one thread" if b == 1
                                 else "the offline chunk's pairs, one thread each"),
                        **bound_lm_step(b, affine)})
    return out


def cases(dev, batch: int = B) -> list[dict]:
    """benchmarks/micro.py:115-215's ops, at its shapes (`batch` frames), as
    the port runs them."""
    from . import bench, ops
    from .image.pyramid import build_pyramid_batched
    from .lie import se3
    from .tracking.photometric import _affine_residual, ic_jacobian
    from .tracking.points import TrackPoints, topk_gradient_points
    from .tracking.robust import WeightKind, mad_sigma
    from .utils.linalg import cholesky_solve_unrolled

    g = torch.Generator(dev).manual_seed(0)
    cam = bench.CAM
    frames = torch.rand((batch, H, W), generator=g, device=dev) * 255.0
    uv = torch.stack([torch.rand((batch, N_PTS), generator=g, device=dev) * (W - 2),
                      torch.rand((batch, N_PTS), generator=g, device=dev) * (H - 2)], dim=-1)
    stacked3 = torch.stack([frames, frames, frames], dim=1)
    J = torch.randn((batch, N_PTS, 6), generator=g, device=dev)
    Hm = (torch.eye(6, device=dev) * 10.0
          + 0.1 * torch.randn((batch, 6, 6), generator=g, device=dev))
    Hm = Hm @ Hm.transpose(-1, -2)
    rhs = Hm[..., 0].contiguous()
    tw = torch.randn((N_TWISTS, 6), generator=g, device=dev) * 0.1
    pix = batch * H * W

    # lm_evaluate at the offline shape: the bench's 96 frames, its points,
    # the relative poses its tracker finds (IC, Huber).
    poses = bench.bench_poses(batch, device=dev)
    bframes = bench.bench_frames(poses)
    pyr = build_pyramid_batched(bframes, levels=bench.LEVELS)
    pts = topk_gradient_points(pyr.images[0], pyr.grad_mag[0], cam, num_points=N_PTS,
                               mono_z=bench.MONO_Z, grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0])
    T_rel, _, _ = bench.make_tracker(cam)(bframes, mono_z=bench.MONO_Z)
    ref = pts.select(slice(None, -1))
    tgt = pyr.images[0][1:]
    vals, ok = ops.warp_and_sample(tgt[:, None], ref.p3d, T_rel, cam)
    valid = ref.valid & ok
    r = torch.where(valid, vals[:, 0] - ref.intensity, 0.0)
    sigma = mad_sigma(r, valid)
    pts0 = TrackPoints(uv=ref.uv, p3d=ref.p3d, intensity=ref.intensity, valid=ref.valid)
    J_ref = ic_jacobian(pts0, ref.gx0, ref.gy0, cam)
    lm_args = (ref.intensity, ref.valid, sigma, cam, WeightKind.HUBER, J_ref)
    evaluator = ops.LMEvaluator(tgt, ref.p3d, *lm_args)
    ab = brightness(batch - 1, dev)
    sigma_ab = mad_sigma(_affine_residual(r, ref.intensity, ab, valid), valid)
    ab_args = (ref.intensity, ref.valid, sigma_ab, cam, WeightKind.HUBER, J_ref)
    evaluator_ab = ops.LMEvaluator(tgt, ref.p3d, *ab_args, affine=True)

    ok3 = ops.cuda_bilinear_sample(stacked3, uv)[1]
    ok1 = ops.cuda_bilinear_sample(frames[:, None], uv)[1]
    return [
        pyramid_case(f"pyramid5_k1(b{batch})", frames, 5),
        pyramid_case(f"live_pyramid3(1x{H}x{W})", frames[:1].contiguous(), 3),
        pyramid_case("roi_pyramid5(1x464x624)", frames[:1, 8:472, 8:632].contiguous(), 5),
        {"op": f"scharr_l0(b{batch})", "kernel": "K1",
         "fn": lambda: ops.scharr_gradients_batched(frames),
         "plain": lambda: ops.scharr_plain(frames), **bound_scharr(frames)},
        {"op": f"sample_c3(b{batch},n2048)", "kernel": "K3",
         "fn": lambda: ops.cuda_bilinear_sample(stacked3, uv),
         "plain": lambda: ops.bilinear_sample_plain(stacked3, uv),
         "library": ("grid_sample", grid_sample_call(stacked3, uv)), **bound_sampler(ok3, 3, 8)},
        {"op": f"sample_c1(b{batch},n2048)", "kernel": "K3",
         "fn": lambda: ops.cuda_bilinear_sample(frames[:, None], uv),
         "plain": lambda: ops.bilinear_sample_plain(frames[:, None], uv),
         "library": ("grid_sample", grid_sample_call(frames[:, None], uv)),
         **bound_sampler(ok1, 1, 8)},
        {"op": f"normal_eq_6x6(b{batch},n2048)",
         "fn": lambda: (torch.einsum("bni,bnj->bij", J, J),
                        torch.einsum("bni,bn->bi", J, J[..., 0])),
         "note": "J^T J and J^T r, f32 (TF32 off)",
         **bound(4 * (J.numel() + batch * 42), 2 * batch * N_PTS * 42)},
        {"op": f"solve_6x6(b{batch})", "fn": lambda: cholesky_solve_unrolled(Hm, rhs),
         "note": "the port's unrolled Cholesky (tracking's LM solve)",
         "library": ("torch.linalg.solve", lambda: torch.linalg.solve(Hm, rhs)),
         **bound(4 * batch * (36 + 6 + 6), batch * (6 ** 3 / 3 + 2 * 36 + 6))},
        *lm_step_cases(dev, (1, batch - 1)),
        {"op": f"topk_points(b{batch})",
         "fn": lambda: topk_gradient_points(frames, frames, cam, num_points=N_PTS, mono_z=2.0,
                                            block=8),
         "note": "block argmax, top-K, unproject", **bound(8 * pix + batch * N_PTS * 24, 2 * pix)},
        {"op": "se3_exp_compose_inv(65k)",
         "fn": lambda: se3.compose(se3.exp(tw), se3.inverse(se3.exp(tw))),
         **bound(N_TWISTS * (6 + 16) * 4, N_TWISTS * 2 * (60 + 64))},
        {"op": f"lm_evaluate(ic,{batch - 1}x2048)", "kernel": "lm_evaluate",
         "fn": lambda: evaluator(T_rel),
         "plain": lambda: ops.lm_evaluate_plain(tgt, ref.p3d, T_rel, *lm_args),
         "note": "one LM evaluation of the offline chunk's pairs (bench frames)",
         **bound_lm_evaluate(ref.valid, ok, fc=False)},
        {"op": f"lm_evaluate_affine(ic,{batch - 1}x2048)", "kernel": "lm_evaluate",
         "fn": lambda: evaluator_ab(T_rel, ab),
         "plain": lambda: ops.lm_evaluate_plain(tgt, ref.p3d, T_rel, *ab_args, ab=ab),
         "note": "the same with affine brightness (a, b) from a seed",
         **bound_lm_evaluate(ref.valid, ok, fc=False, affine=True)},
        *k1_level_cases(frames),
        *euroc_cases(dev),
    ]


def measure(case: dict) -> dict:
    ms, timer = device_ms(case["fn"])
    rec = {"op": case["op"], "ms": ms, "timer": timer, "bound_ms": case["bound_ms"],
           "bound_by": case["bound_by"], "share_of_bound": case["bound_ms"] / ms,
           "bytes": case["bytes"], "flops": case["flops"],
           "GB_per_s": case["bytes"] / ms / 1e6, "TFLOP_per_s": case["flops"] / ms / 1e9}
    if "kernel" in case:
        rec["kernel"] = case["kernel"]
    if "plain" in case:
        rec["plain_ms"], rec["plain_timer"] = device_ms(case["plain"])
    if "library" in case:
        name, fn = case["library"]
        rec["library"] = name
        rec["library_ms"], _ = device_ms(fn)
    if "note" in case:
        rec["note"] = case["note"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="MICRO_TORCH_r12.json")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) times every op; cpu runs each once, untimed")
    ap.add_argument("--batch", type=int, default=B, help="frames per batch (default 96)")
    args = ap.parse_args(argv)
    if args.platform == "cpu":
        for case in cases(torch.device("cpu"), args.batch):
            for fn in (case["fn"], case.get("plain"), case.get("library", (None, None))[1]):
                if fn is not None:
                    fn()
            print(json.dumps({"op": case["op"], "ran_on": "cpu", "ms": None}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("error: --platform cuda (the default) needs a CUDA card and none is visible; "
              "pass --platform cpu to run each op once on the CPU, untimed", file=sys.stderr)
        return 2
    from .bench import gpu_identity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    identity = gpu_identity()
    records = []
    for case in cases(torch.device("cuda", 0), args.batch):
        records.append(measure(case))
        print(json.dumps(records[-1]), flush=True)
    out = {"device": identity, "torch": torch.__version__, "cuda": torch.version.cuda,
           "hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_flop_per_s": F32_FLOP_PER_S,
           "reps": REPS, "ops": records}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"device": identity, "wrote": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
