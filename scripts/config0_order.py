"""eval.py's config 0 (uw-slam's reference mode) with its tracked points in a
shuffled order, or its frames perturbed in their last bits: how far such
changes move the run.

Config 0 tracks each frame on the 5 x 5 patches of the first 200 matched
keypoint slots, which leaves 0 to a few patches (25 to 75 points) on most
frames, in the JAX package and the port alike: the pose of such a frame is
barely determined, so the last bits of its normal equations' sums decide
it. This runs the JAX CLI (`--package jax`) or the port's CLI on the CPU
(`--package port`) with the patch points of every frame permuted by a
fixed permutation drawn from `--seed` (seed 0: unpermuted). The points and
their values are the same; only the order in which sums over them are taken
changes. With `--noise SIGMA` the points keep their order and every frame
gets Gaussian noise of SIGMA gray levels instead (numpy, seeded by the seed
and the frame): 1e-4 moves an 8-bit intensity by a few ulps of f32. With
`--fused-two-view` the JAX package runs its two-view geometry on the forms
it takes on an accelerator, which the port takes on every device (inverse
subspace iteration, Jacobi eigh and svd, the inhomogeneous DLT), instead of
its CPU branch's LAPACK calls; nothing else leaves its CPU forms.

    JAX_PLATFORMS=cpu python scripts/config0_order.py DATASET_DIR --package jax|port
        --seeds 0,1,2,3 [--noise SIGMA] [--fused-two-view] [--jobs 2] [--threads 2]

DATASET_DIR is one of eval.py's TUM datasets (`rgb/`, `calib.xml`,
`groundtruth.txt`). One JSON line per run (package, seed, ATE), then one
with all of them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def child(package: str, seed: int, data: str, threads: int, noise: float,
          fused_two_view: bool) -> None:
    argv = ["-d", f"{data}/rgb", "-c", f"{data}/calib.xml", "--tum-gt",
            f"{data}/groundtruth.txt", "--reference-mode", "--platform", "cpu"]
    if package == "jax":
        import jax
        import numpy as np

        jax.config.update("jax_platforms", "cpu")
        import uwslam_tpu.system as system
        import uwslam_tpu.utils.linalg as jlinalg
        from uwslam_tpu.cli.main import main as cli_main

        if fused_two_view:
            # As tests/test_torch_ransac.py's `jax_accelerator_branch`.
            true_backend = jax.default_backend
            geometry = os.path.join("features", "geometry.py")
            jlinalg._on_cpu = lambda: False
            jax.default_backend = lambda: ("tpu" if sys._getframe(1).f_code.co_filename
                                           .endswith(geometry) else true_backend())

        def permute(x, perm):
            return None if x is None else x[np.asarray(perm)]
        axis_n = 0
    else:
        import torch

        torch.set_num_threads(threads)
        import uwslam_tpu_torch.system as system
        from uwslam_tpu_torch.cli.main import main as cli_main

        def permute(x, perm):
            return None if x is None else x[:, torch.as_tensor(perm, device=x.device)]
        axis_n = 1
    import numpy as np

    original = system.patch_points
    if noise > 0:
        frame_ids = iter(range(1 << 30))
        process_frame = system.SlamSystem.process_frame

        def noisy_frame(self, image, *a, **kw):
            rng = np.random.default_rng([seed, next(frame_ids)])
            img = np.asarray(image.cpu() if hasattr(image, "cpu") else image, np.float32)
            img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
            if package == "port":
                img = torch.from_numpy(img)
            return process_frame(self, img, *a, **kw)

        system.SlamSystem.process_frame = noisy_frame

    def patch_points(*a, **kw):
        pts = original(*a, **kw)
        if seed == 0 or noise > 0:
            return pts
        n = pts.uv.shape[axis_n]
        perm = np.random.default_rng(seed).permutation(n)
        return type(pts)(*(permute(f, perm) for f in pts))

    system.patch_points = patch_points
    cli_main(argv)


def run(package: str, seed: int, data: str, threads: int, noise: float,
        fused_two_view: bool) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(threads))
    proc = subprocess.run([sys.executable, __file__, "--child", package, str(seed), data,
                           str(threads), str(noise), str(int(fused_two_view))], env=env,
                          cwd=REPO, capture_output=True, text=True)
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+naif-]+) m", proc.stdout)
    out = {"package": package, "seed": seed, "noise": noise,
           "fused_two_view": fused_two_view, "rc": proc.returncode,
           "ate_m": float(m.group(1)) if m else None}
    if m is None:
        out["error"] = proc.stderr[-2000:]
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data")
    p.add_argument("--package", choices=("jax", "port"), required=True)
    p.add_argument("--seeds", default="0,1,2,3")
    p.add_argument("--jobs", type=int, default=2)
    p.add_argument("--threads", type=int, default=2, help="torch threads of a port run")
    p.add_argument("--noise", type=float, default=0.0,
                   help="gray levels of noise on every frame instead of a shuffled order")
    p.add_argument("--fused-two-view", action="store_true",
                   help="the JAX package's two-view geometry on its accelerator forms")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(
            lambda s: run(args.package, s, args.data, args.threads, args.noise,
                          args.fused_two_view), seeds))
    print(json.dumps({"data": args.data, "runs": runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], int(sys.argv[3]), sys.argv[4], int(sys.argv[5]), float(sys.argv[6]),
              sys.argv[7] == "1")
    else:
        main()
