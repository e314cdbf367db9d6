"""The JAX package's live loop on the bench's 96 frames, on the CPU: the
reference ATE that `chip_smoke.py` holds the port's live configurations to.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/jax_live_reference.py --photo-ba
    JAX_PLATFORMS=cpu python scripts/jax_live_reference.py --photo-ba --pipelined

It prints one JSON line: the configuration, the loop, the ATE (m,
Sim(3)-aligned, over every frame), the keyframes, the window solves and
their LM iterations, and the seconds the run took. The frames are the JAX
package's own render of `bench.py`'s sequence (TUM camera 640 x 480, the
seed-0 textured plane at z = 2, twist amplitude x sin(2 pi i / 24)); the
configuration is `chip_smoke.py`'s live design point (FC, 3 pyramid levels,
track levels (1, 0), 10 LM iterations, 2048 points, monocular depth 2,
relocalization on), with `--ba` or `--photo-ba` as the CLI sets them.
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
    p.add_argument("--ba", action="store_true", help="reprojection window BA")
    p.add_argument("--photo-ba", action="store_true", help="photometric window BA")
    p.add_argument("--pipelined", action="store_true",
                   help="process_frame_async + flush (default: process_frame)")
    p.add_argument("--frames", type=int, default=96)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.camera.calibration import Calibration
    from uwslam_tpu.config import BAConfig, SlamConfig, TrackerConfig
    from uwslam_tpu.io import ate_rmse
    from uwslam_tpu.lie import se3
    from uwslam_tpu.system import SlamSystem
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008], jnp.float32)
    poses = [se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0)) for i in range(args.frames)]
    frames = [np.asarray(render_plane_view(cam, T, 2.0)) for T in poses]
    gt = np.stack([np.asarray(se3.inverse(T)) for T in poses])
    config = SlamConfig(
        tracker=TrackerConfig(pyramid_levels=3, track_levels=(1, 0), max_iterations=10,
                              num_points=2048, mono_depth=2.0, track_mode="fc"),
        use_reloc=True, use_ba=args.ba or args.photo_ba,
        ba=BAConfig(photometric=args.photo_ba),
    )
    system = SlamSystem(Calibration(raw=cam, out_width=640, out_height=480), config)
    step = system.process_frame_async if args.pipelined else system.process_frame
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        step(f, timestamp=float(i))
    system.flush()
    seconds = time.perf_counter() - t0
    _, est = system.export_trajectory()
    print(json.dumps({
        "config": "photo-ba" if args.photo_ba else "ba" if args.ba else "plain",
        "loop": "pipelined" if args.pipelined else "synchronous",
        "frames": args.frames,
        "ate_m": float(ate_rmse(est[:, :3, 3], gt[:, :3, 3])),
        "keyframes": [s.frame_id for s in system.trajectory if s.is_keyframe],
        "statuses_ok": sum(s.status == "ok" for s in system.trajectory),
        "ba_runs": int(system.ba_stats["runs"]), "ba_iters": int(system.ba_stats["iters"]),
        "seconds": round(seconds, 1),
    }))


if __name__ == "__main__":
    main()
