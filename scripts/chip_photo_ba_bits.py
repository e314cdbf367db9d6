"""`--photo-ba` on the 96 bench frames (`chip_smoke.py` phase 19), synchronous
and pipelined twice, with each photometric window solve logged.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_photo_ba_bits.py` (~1.5 minutes on an H100). For
each run it prints the ATE, the keyframes and one tuple per solve: the frame
id at the solve, the window's keyframes, LM passes, solves counted, the
largest change of a keyframe pose entry, and the largest entry of R^T R - I
over the window's poses after it. Then the pose gap of the synchronous and
the first pipelined run, and of the two pipelined runs. Run it in two trees
to find the first solve at which they part.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from uwslam_tpu_torch import bench  # noqa: E402
from uwslam_tpu_torch import system as S  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402

_lib.build()
log = []
orig = S.SlamSystem._run_window_photo_ba


def wrapped(self):
    it0, r0 = self.ba_stats["iters"], self.ba_stats["runs"]
    before = {k.frame_id: k.T_wc.cpu().numpy().copy() for k in self.keyframes.keyframes}
    out = orig(self)
    after = {k.frame_id: k.T_wc.cpu().numpy().copy() for k in self.keyframes.keyframes}
    mv = max(float(np.abs(after[f] - before[f]).max()) for f in before)
    off = max(float(np.abs(T[:3, :3].astype(np.float64).T @ T[:3, :3] - np.eye(3)).max())
              for T in after.values())
    log.append((self._frame_id, len(before), self.ba_stats["iters"] - it0,
                self.ba_stats["runs"] - r0, round(mv, 7), off))
    return out


S.SlamSystem._run_window_photo_ba = wrapped
dev = torch.device("cuda", 0)
poses = bench.bench_poses(device=dev)
frames = bench.bench_frames(poses)
res = {}
for name, pipelined in (("sync", False), ("pipe", True), ("pipe2", True)):
    log.clear()
    s = cs.photo_system(dev)
    cs.drive(s, frames, pipelined=pipelined)
    res[name] = s
    print(Path.cwd().name, name, "ate", cs.live_ate(s, poses), "kfs",
          [x.frame_id for x in s.trajectory if x.is_keyframe], "solves", log, flush=True)
print(Path.cwd().name, "gap", cs.pose_gap(res["sync"], res["pipe"]), "pipe vs pipe2",
      cs.pose_gap(res["pipe"], res["pipe2"]), flush=True)
