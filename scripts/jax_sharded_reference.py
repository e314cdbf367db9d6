"""The JAX package's sequence-sharded tracker on the bench's 96 frames, on
the CPU: the reference ATE that `chip_smoke.py` phase 21 holds the port's
sharded run to.

Run from the repository root (8 virtual CPU devices, one per shard):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/jax_sharded_reference.py [--batched] [--mode ic]

It prints one JSON line: the call's settings, the ATE (m, Sim(3)-aligned,
over the 96 composed poses), the smallest inlier count and the seconds the
call took. The frames are the JAX package's own render of `bench.py`'s
sequence (TUM camera 640 x 480, the seed-0 textured plane at z = 2, twist
amplitude x sin(2 pi i / 24)); the call is phase 21's:
`track_sequence_sharded` over 8 shards, 2048 points, 5 levels, track
levels (3, 2, 1, 0), max_iters 10, monocular depth 2, by default FC with
the sequential scan per chunk (`batched=False`).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batched", action="store_true",
                   help="track_sequence_batched per chunk (default: track_sequence)")
    p.add_argument("--mode", default="fc", choices=("fc", "ic"))
    p.add_argument("--shards", type=int, default=8)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.io import ate_rmse
    from uwslam_tpu.lie import se3
    from uwslam_tpu.parallel import SEQ_AXIS, track_sequence_sharded
    from uwslam_tpu.tracking import compose_trajectory
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008], jnp.float32)
    poses = [se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0)) for i in range(96)]
    frames = jnp.stack([render_plane_view(cam, T, 2.0) for T in poses])
    gt = np.stack([np.asarray(se3.inverse(T)) for T in poses])
    mesh = Mesh(np.array(jax.devices()[:args.shards]), (SEQ_AXIS,))
    t0 = time.perf_counter()
    T_rel, inliers, _ = track_sequence_sharded(
        frames, cam, mesh, mono_z=2.0, levels=5, track_levels=(3, 2, 1, 0), num_points=2048,
        max_iters=10, mode=args.mode, batched=args.batched)
    T_rel.block_until_ready()
    seconds = time.perf_counter() - t0
    est = np.asarray(compose_trajectory(T_rel))
    print(json.dumps({
        "call": "track_sequence_sharded", "shards": args.shards, "mode": args.mode,
        "batched": args.batched, "frames": 96,
        "ate_m": float(ate_rmse(est[:, :3, 3], gt[:, :3, 3])),
        "min_inliers": int(np.asarray(inliers).min()), "seconds": round(seconds, 1),
    }))


if __name__ == "__main__":
    main()
