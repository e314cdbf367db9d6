"""`chip_smoke.py` phase 20 alone (configs 5, 6 and 7: loop closure and the
global distributed BA), with the pose graph's captured-pass check before it.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_phase20.py`. It prints the card's name and
power limit, then one line per part: its name, ok or FAILED, its seconds and
its JSON result (or the traceback); a failing part does not stop the next.
The parts: building the kernels, `chip_smoke.phase_pose_graph` and
`chip_smoke.phase_loop_configs` (~3.5 minutes on an H100).
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from uwslam_tpu_torch import bench  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402


def part(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        print(f"[{name}] ok {time.perf_counter() - t0:.1f} s {json.dumps(out, default=str)}",
              flush=True)
        return out
    except Exception:
        print(f"[{name}] FAILED {time.perf_counter() - t0:.1f} s\n{traceback.format_exc()}",
              flush=True)
        return None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase20: no CUDA card is visible")
    print(bench.gpu_identity(), flush=True)
    part("build", lambda: [str(x) for x in _lib.build()[:2]])
    dev = torch.device("cuda", 0)
    part("pose graph", lambda: chip_smoke.phase_pose_graph(dev))
    part("phase 20", lambda: chip_smoke.phase_loop_configs(chip_smoke.kernels_table()))


if __name__ == "__main__":
    main()
