"""Entry points of the port: one tracking step, and the multi-shard dry run.

Counterpart of the repository's `__graft_entry__.py` (the JAX package's):

- `entry(device=None)` -> (fn, example_args): the framework's hot path,
  one coarse-to-fine photometric tracking step (`tracking.track`, IC) of a
  synthetic pair at the bench's design point (TUM 640 x 480 intrinsics,
  5 pyramid levels, 2048 points, track levels (3, 2, 1, 0) with (12, 8, 5,
  3) LM iterations). `fn(ref, tgt)` returns T (4, 4), target <- reference.
- `dryrun_multichip(n, device=None)`: the three multi-shard steps at the
  JAX package's shapes, with n shards in this process (`landmark_layout`):
  sequence-sharded tracking (80 x 60, n + 2 frames), landmark-sharded BA
  (4 keyframes x 16 n landmarks) and observer-sharded photometric BA (n
  keyframes of 64 points); each output must be finite.

Both run on the card unless `device` names another ("cpu"); without a
card the default raises. Run `python -m uwslam_tpu_torch.entry [--cpu]`.
"""
from __future__ import annotations

import sys

import torch


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the entry points run on a CUDA card and none is visible; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _synthetic_pair(cam, dev):
    from .lie import se3
    from .utils.synthetic import render_plane_view

    T_tgt = se3.exp(torch.tensor([0.02, -0.01, 0.005, 0.004, -0.003, 0.008], device=dev))
    ref = render_plane_view(cam, torch.eye(4, device=dev), 2.0)
    tgt = render_plane_view(cam, T_tgt, 2.0)
    return ref, tgt


def entry(device=None):
    """-> (fn, example_args): `fn(ref (H, W), tgt (H, W)) -> T (4, 4)`."""
    from .camera import PinholeCamera
    from .image.pyramid import build_pyramid
    from .tracking import topk_gradient_points, track
    from .utils.synthetic import plane_depth

    dev = _device(device)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    ref, tgt = _synthetic_pair(cam, dev)

    def step(ref_img, tgt_img):
        ref_pyr = build_pyramid(ref_img, levels=5)
        tgt_pyr = build_pyramid(tgt_img, levels=5)
        depth = plane_depth(cam, torch.eye(4, device=ref_img.device), 2.0)
        pts = topk_gradient_points(ref_pyr.images[0], ref_pyr.grad_mag[0], cam,
                                   num_points=2048)
        u = pts.uv[..., 0].to(torch.int64).clamp(0, cam.width - 1)
        v = pts.uv[..., 1].to(torch.int64).clamp(0, cam.height - 1)
        pts = pts._replace(p3d=cam.unproject(pts.uv, depth[v, u]))
        out = track(ref_pyr, tgt_pyr, pts, cam, levels=(3, 2, 1, 0), max_iters=(12, 8, 5, 3),
                    mode="ic")
        return out.T[0]

    return step, (ref, tgt)


def _finite(x: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what} is not finite")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the three multi-shard steps over `n_devices` shards -> their
    outputs ({"track": T_rel, "ba": BAResult, "photo_ba": PhotoBAResult}),
    every one checked finite.

    The BA landmarks are drawn from a `torch.Generator` seeded 0 where the
    JAX package draws from `jax.random.PRNGKey(0)`: another draw of the
    same distribution (x in [-1, 1], y in [-0.8, 0.8], z in [3, 5])."""
    from .ba import BAProblem, photo_ba_problem_from_keyframes
    from .camera import PinholeCamera
    from .image.pyramid import build_pyramid
    from .lie import se3
    from .parallel import (
        distributed_bundle_adjust,
        distributed_photometric_ba,
        landmark_layout,
        shard_problem,
        track_sequence_sharded,
    )
    from .tracking import topk_gradient_points
    from .utils.synthetic import render_plane_view

    dev = _device(device)
    layout = landmark_layout(n_devices)

    # Sequence-sharded tracking (tiny shapes).
    cam_s = PinholeCamera(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80, height=60)
    twists = torch.zeros((n_devices + 2, 6), device=dev)
    twists[:, 0] = 0.01 * torch.arange(n_devices + 2, device=dev)
    frames = render_plane_view(cam_s, se3.exp(twists), 2.0)
    T_rel, _, _ = track_sequence_sharded(frames, cam_s, layout, mono_z=2.0, levels=3,
                                         track_levels=(1, 0), num_points=128, max_iters=4)
    _finite(T_rel, "sharded tracking's T_rel")

    # Landmark-sharded BA.
    cam = PinholeCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)
    gen = torch.Generator(device="cpu").manual_seed(0)
    num_kf, num_lm = 4, 16 * n_devices
    lo = torch.tensor([-1.0, -0.8, 3.0])
    hi = torch.tensor([1.0, 0.8, 5.0])
    pts = (lo + (hi - lo) * torch.rand((num_lm, 3), generator=gen)).to(dev)
    kf_tw = torch.zeros((num_kf, 6), device=dev)
    kf_tw[:, 0] = 0.05 * torch.arange(num_kf, device=dev)
    T = se3.exp(kf_tw)
    kf_idx = torch.arange(num_kf, device=dev).repeat_interleave(num_lm)
    lm_idx = torch.arange(num_lm, device=dev).repeat(num_kf)
    uv = cam.project(se3.apply(T[kf_idx], pts[lm_idx]))
    problem = BAProblem(T_cw=T, points=pts + 0.02, obs_kf=kf_idx.to(torch.int32),
                        obs_lm=lm_idx.to(torch.int32), obs_uv=uv,
                        obs_valid=torch.ones_like(kf_idx, dtype=torch.bool))
    ba = distributed_bundle_adjust(shard_problem(problem, n_devices), cam, layout, max_iters=3)
    _finite(ba.cost, "distributed BA's cost")

    # Observer-sharded photometric BA: one observer keyframe per shard.
    pyrs, poses, kf_pts = [], [], []
    for k in range(n_devices):
        Tk = se3.exp(torch.tensor([0.02 * k, 0.008 * k, 0, 0, 0, 0.004 * k], device=dev))
        pyr = build_pyramid(render_plane_view(cam_s, Tk, 2.0), levels=2)
        pyrs.append(pyr)
        poses.append(Tk)
        kf_pts.append(topk_gradient_points(pyr.images[0], pyr.grad_mag[0], cam_s,
                                           num_points=64, mono_z=2.0, block=4))
    photo = distributed_photometric_ba(
        photo_ba_problem_from_keyframes(pyrs, poses, kf_pts, level=1), cam_s.scaled(1),
        layout, max_iters=3)
    _finite(photo.cost, "distributed photometric BA's cost")
    return {"track": T_rel, "ba": ba, "photo_ba": photo}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    fn, args = entry(device)
    T = fn(*args)
    print("entry ok:", T[:3, 3].cpu().numpy())
    dryrun_multichip(8, device)
    print("dryrun_multichip(8) ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
