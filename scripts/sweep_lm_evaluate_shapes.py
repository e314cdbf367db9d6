"""Device time of the port's `lm_evaluate` kernel over launch shapes.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/sweep_lm_evaluate_shapes.py`. At the bench design
point (640 x 480, 2048 points per pair, pyramid level 0) it times the kernel
for 95 pairs and for 1 pair, IC and FC, with every combination of 128 to
1024 threads per block and 1 to 8 blocks per pair (one thread-block
cluster), twice each in turns, and prints one JSON line per case: device
microseconds per launch (profiler) by "threads x blocks". The wrapper's own
choice (`ops.cuda_track.launch_shape`) is printed beside it. The first line
is the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from uwslam_tpu_torch import bench, ops  # noqa: E402
from uwslam_tpu_torch.image.pyramid import build_pyramid_batched  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402
from uwslam_tpu_torch.ops.cuda_track import launch_shape  # noqa: E402
from uwslam_tpu_torch.tracking.photometric import ic_jacobian  # noqa: E402
from uwslam_tpu_torch.tracking.points import topk_gradient_points  # noqa: E402
from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; none is visible")
    print(bench.gpu_identity())
    dev = torch.device("cuda", 0)
    cam = bench.CAM
    frames = bench.bench_frames(bench.bench_poses(device=dev))
    pyr = build_pyramid_batched(frames, levels=bench.LEVELS)
    pts = topk_gradient_points(
        pyr.images[0], pyr.grad_mag[0], cam, num_points=bench.NUM_POINTS,
        mono_z=bench.MONO_Z, grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0])
    T_rel = bench.make_tracker(cam)(frames, mono_z=bench.MONO_Z)[0].contiguous()
    kernel = _lib.library().uws_lm_evaluate
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    for B, fc in ((95, False), (95, True), (1, True), (1, False)):
        ref = pts.select(slice(0, B))
        T = T_rel[:B].contiguous()
        tgt = pyr.images[0][1:B + 1]
        vals, ok = ops.warp_and_sample(tgt[:, None], ref.p3d, T, cam)
        valid = ref.valid & ok
        sigma = mad_sigma(torch.where(valid, vals[:, 0] - ref.intensity, 0.0), valid)
        if fc:
            target = ops.pack_texels(tgt, pyr.grad_x[0][1:B + 1], pyr.grad_y[0][1:B + 1])
            J_ref = None
        else:
            target, J_ref = tgt, ic_jacobian(ref, ref.gx0, ref.gy0, cam)
        ev = ops.LMEvaluator(target, ref.p3d, ref.intensity, ref.valid, sigma, cam,
                             WeightKind.HUBER, J_ref=J_ref)

        def shaped(threads: int, blocks: int):
            args = (*ev._head, T.data_ptr(), 0, *ev._tail[:-2], threads, blocks,   # 0: no (a, b)
                    torch.cuda.current_stream().cuda_stream)

            def call():
                if kernel(*args) != 0:
                    raise RuntimeError(f"launch {threads}x{blocks} refused")
            return call

        us: dict[str, list[float]] = {}
        for _ in range(2):
            for threads in (128, 256, 512, 1024):
                for blocks in (1, 2, 4, 8):
                    ms = chip_smoke.call_ms(shaped(threads, blocks))[0]
                    us.setdefault(f"{threads}x{blocks}", []).append(round(ms * 1e3, 2))
        chosen = "{}x{}".format(*launch_shape(B, ref.p3d.shape[1], sms))
        print(json.dumps({"pairs": B, "fc": fc, "chosen": chosen, "us": us}), flush=True)


if __name__ == "__main__":
    main()
