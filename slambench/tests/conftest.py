"""The benchmark's own tests: the repository root on the import path, and a
small cell (a 160 x 120 camera, 256 points, a ring of 64 frames) that a CPU
run can hold."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(cell):
    """`cell` at test size: every width of the configuration's camera / 4
    (so a frame moves a quarter of the pixels), 512 points, a ring of one
    path period, 0.3 s of warm-up."""
    cam = dict(cell.config["camera"], width=160, height=120, fx=131.25, fy=131.25,
               cx=79.5, cy=59.5)
    config = dict(cell.config, camera=cam, flags=cell.config["flags"] + ["--num-points", "512"],
                  bench={"check_frames": 6, "trace_frames": 4})
    mix = dict(cell.traffic, ring_frames=cell.traffic["path_period"], warmup_seconds=0.3)
    return dataclasses.replace(cell, config=config, traffic=mix)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")
    return torch.device("cuda", 0)
