"""Per-operation micro benchmark of the port on one card: device time beside
the card's bound.

    python -m uwslam_tpu_torch.micro [--out MICRO_TORCH_r09.json] [--platform cuda|cpu]

Counterpart of `benchmarks/micro.py` (the JAX package's, whose op list and
shapes it keeps: a batch of 96 frames of 480 x 640, 2048 points per frame,
65,536 twists). Each op is timed by device time: one warm-up call, then
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
import json
import sys

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
B, H, W = 96, 480, 640
N_PTS = 2048
N_TWISTS = 65536
REPS = 20
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
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def device_ms(fn, reps: int = REPS, attempts: int = 3) -> tuple[float, str]:
    """(device ms per call, timer): the profiler's kernel time over `reps`
    calls after a warm-up call; CUDA events if no profile records a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps, "profiler"
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


def sampler_bound(ok, C: int) -> dict:
    """K3: uv (8 B) and the validity byte per point; per valid point the four
    taps of every channel (16 B each) and its sample (4 B)."""
    n_ok = int(ok.sum())
    return bound(ok.numel() * 9 + n_ok * 20 * C, n_ok * (TAPS_FLOPS + BLEND_FLOPS * C))


def cases(dev, batch: int = B) -> list[dict]:
    """benchmarks/micro.py:115-215's ops, at its shapes (`batch` frames), as
    the port runs them."""
    from . import bench, ops
    from .image.pyramid import build_pyramid_batched
    from .lie import se3
    from .tracking.photometric import ic_jacobian
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
    levels = sum(pix >> (2 * level) for level in range(5))       # pixels over 5 levels
    halved = sum(pix >> (2 * level) for level in range(4))       # levels that are halved

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
    sigma = mad_sigma(torch.where(valid, vals[:, 0] - ref.intensity, 0.0), valid)
    pts0 = TrackPoints(uv=ref.uv, p3d=ref.p3d, intensity=ref.intensity, valid=ref.valid)
    lm_args = (ref.intensity, ref.valid, sigma, cam, WeightKind.HUBER,
               ic_jacobian(pts0, ref.gx0, ref.gy0, cam))
    evaluator = ops.LMEvaluator(tgt, ref.p3d, *lm_args)
    n_lm = int(valid.sum())

    ok3 = ops.cuda_bilinear_sample(stacked3, uv)[1]
    ok1 = ops.cuda_bilinear_sample(frames[:, None], uv)[1]
    return [
        {"op": f"pyramid5_k1(b{batch})", "fn": lambda: build_pyramid_batched(frames, levels=5),
         "note": "5 levels of 2x2 means, K1 Scharr gx, gy, |g| on each",
         **bound(4 * (4 * levels + 1.25 * halved), K1_FLOPS * levels + 4 * halved)},
        {"op": f"scharr_l0(b{batch})", "kernel": "K1",
         "fn": lambda: ops.scharr_gradients_batched(frames),
         "plain": lambda: ops.scharr_plain(frames), **bound(16 * pix, K1_FLOPS * pix)},
        {"op": f"sample_c3(b{batch},n2048)", "kernel": "K3",
         "fn": lambda: ops.cuda_bilinear_sample(stacked3, uv),
         "plain": lambda: ops.bilinear_sample_plain(stacked3, uv),
         "library": ("grid_sample", grid_sample_call(stacked3, uv)), **sampler_bound(ok3, 3)},
        {"op": f"sample_c1(b{batch},n2048)", "kernel": "K3",
         "fn": lambda: ops.cuda_bilinear_sample(frames[:, None], uv),
         "plain": lambda: ops.bilinear_sample_plain(frames[:, None], uv),
         "library": ("grid_sample", grid_sample_call(frames[:, None], uv)),
         **sampler_bound(ok1, 1)},
        {"op": f"normal_eq_6x6(b{batch},n2048)",
         "fn": lambda: (torch.einsum("bni,bnj->bij", J, J),
                        torch.einsum("bni,bn->bi", J, J[..., 0])),
         "note": "J^T J and J^T r, f32 (TF32 off)",
         **bound(4 * (J.numel() + batch * 42), 2 * batch * N_PTS * 42)},
        {"op": f"solve_6x6(b{batch})", "fn": lambda: cholesky_solve_unrolled(Hm, rhs),
         "note": "the port's unrolled Cholesky (tracking's LM solve)",
         "library": ("torch.linalg.solve", lambda: torch.linalg.solve(Hm, rhs)),
         **bound(4 * batch * (36 + 6 + 6), batch * (6 ** 3 / 3 + 2 * 36 + 6))},
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
         **bound((batch - 1) * (N_PTS * 13 + 68 + 180) + n_lm * 44, n_lm * LM_FLOPS_IC)},
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
    ap.add_argument("--out", default="MICRO_TORCH_r09.json")
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
