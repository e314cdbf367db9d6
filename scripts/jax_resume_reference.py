"""The JAX package's CLI on the bench's 96 frames as 8-bit files, run
through and split by a checkpoint, on the CPU: the reference ATE that
`chip_smoke.py` phase 23 holds the port's resumed run to.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/jax_resume_reference.py [--split 48]

It prints one JSON line: the ATE (m, Sim(3)-aligned, over the 96 frames,
as the CLI prints it) of the uninterrupted run and of the run stopped with
`--checkpoint` after `--split` frames and continued with `--resume`, and
the seconds each took. The dataset is `chip_smoke.py:write_dataset`'s, from
the JAX package's own render of `bench.py`'s sequence (TUM camera
640 x 480, the seed-0 textured plane at z = 2, twist amplitude x
sin(2 pi i / 24)): PGM frames truncated to 8 bits, named by the timestamps
1 + 0.033 i, TUM ground truth and a calibration XML; the flags are phase
8's live design point (`--levels 3 --track-levels 1,0 --mono-depth 2.0`,
the pipelined loop).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def write_dataset(root: Path, frames, gt_wc) -> list[str]:
    import numpy as np

    from uwslam_tpu.lie import so3

    rgb = root / "rgb"
    rgb.mkdir()
    lines = ["# ground truth\n# synthetic\n# timestamp tx ty tz qx qy qz qw\n"]
    for i, (img, T) in enumerate(zip(frames, gt_wc)):
        ts = f"{1.0 + 0.033 * i:.6f}"
        pix = np.clip(img, 0, 255).astype(np.uint8)
        h, w = pix.shape
        (rgb / f"{ts}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + pix.tobytes())
        q = np.asarray(so3.to_quaternion(T[:3, :3]))
        t = T[:3, 3]
        lines.append(f"{ts} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
    (root / "groundtruth.txt").write_text("".join(lines))
    (root / "calib.xml").write_text("""<?xml version="1.0"?>
<opencv_storage>
<in_width>640</in_width><in_height>480</in_height>
<out_width>640</out_width><out_height>480</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>525.0 525.0 319.5 239.5</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>0 0 0 0</data></rectification>
</opencv_storage>
""")
    return ["-d", str(rgb), "-c", str(root / "calib.xml"), "--tum-gt",
            str(root / "groundtruth.txt"), "--levels", "3", "--track-levels", "1,0",
            "--mono-depth", "2.0"]


def run(argv) -> tuple[float, float]:
    from uwslam_tpu.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+-]+) m over (\d+)", buf.getvalue())
    if rc != 0 or m is None:
        raise SystemExit(f"the JAX CLI exited {rc}: {buf.getvalue()!r}")
    return float(m.group(1)), round(time.perf_counter() - t0, 1)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--split", type=int, default=48)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from uwslam_tpu.camera import PinholeCamera
    from uwslam_tpu.lie import se3
    from uwslam_tpu.utils.synthetic import render_plane_view

    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    amp = jnp.asarray([0.06, 0.024, 0.008, 0.004, -0.006, 0.008], jnp.float32)
    poses = [se3.exp(amp * math.sin(2.0 * math.pi * i / 24.0)) for i in range(96)]
    frames = [np.asarray(render_plane_view(cam, T, 2.0)) for T in poses]
    gt_wc = [np.asarray(se3.inverse(T)) for T in poses]
    with tempfile.TemporaryDirectory() as tmp:
        base = write_dataset(Path(tmp), frames, gt_wc)
        ck = str(Path(tmp) / "session")
        whole, whole_s = run(base + ["--trajectory-out", str(Path(tmp) / "whole.txt")])
        _, first_s = run(base + ["--max-frames", str(args.split), "--checkpoint", ck])
        joined, second_s = run(base + ["--resume", ck + ".npz", "--trajectory-out",
                                       str(Path(tmp) / "joined.txt")])
        a = np.loadtxt(Path(tmp) / "whole.txt")
        b = np.loadtxt(Path(tmp) / "joined.txt")
    print(json.dumps({
        "frames": 96, "split": args.split, "ate_m_whole": whole, "ate_m_joined": joined,
        "first_split_rows_max_diff": float(np.abs(a[:args.split] - b[:args.split]).max()),
        "seconds": [whole_s, first_s, second_s],
    }))


if __name__ == "__main__":
    main()
