"""Some phases of `chip_smoke.py` alone, beside the port's CPU run of
config 5 over 64 frames (phase 20's, which loads the host while they run).

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_phases.py [21] [22] [23] [15] [17]` (default:
all five, ~6 minutes on an H100). It prints the card's name and power limit,
then one line per phase with its JSON result, its seconds and the running
total, and last the CPU run of config 5 and its health check; the first
failing phase stops it with a non-zero exit.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from uwslam_tpu_torch import bench  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402

PHASES = ("21", "22", "23", "15", "17")


def main(which) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA card is visible; nothing was run")
    dev = torch.device("cuda", 0)
    cs.say("1 device", bench.gpu_identity())
    _, build_s, _ = _lib.build()
    cs.say("2 build", f"{build_s:.1f} s")
    table = cs.kernels_table()
    poses = bench.bench_poses(device=dev)
    frames = bench.bench_frames(poses)
    with tempfile.TemporaryDirectory() as tmp:
        quick = cs.write_tum_sequence(Path(tmp) / "quick", cs.QUICK_FRAMES, cs.QUICK_LOOP_PERIOD,
                                      dev)
        cpu_out = Path(tmp) / "cpu_config5"
        proc = cs.start_cpu_config5(quick, cpu_out)
        try:
            if "21" in which:
                cs.say("21", json.dumps(cs.phase_sequence_sharded(frames, poses, table)))
            if "22" in which:
                cs.say("22", " ".join(json.dumps(x) for x in cs.phase_photo_sharded()))
            if "23" in which:
                cs.say("23", " ".join(json.dumps(x) for x in cs.phase_session(frames, poses, table)))
            if "15" in which:
                scene, scene_poses = cs.scene_sequence(dev)
                cs.say("15", json.dumps(cs.phase_config2(scene, scene_poses, frames, poses,
                                                         table)[0]))
            if "17" in which:
                # Phase 17 reports the pipelined frame times beside those of a
                # run without BA, which only phase 11 measures: a stand-in.
                cs.say("17", json.dumps(cs.phase_config4(frames, poses, table, [11.5] * 96)))
        finally:
            c = cs.finish_cpu_config5(proc, cpu_out)
        c.pop("_poses")
        cs.say("20 CPU run of config 5", json.dumps(c))
        cs.health_checks(5, c)
        cs.say("20 CPU run of config 5: health checks", "ok")


if __name__ == "__main__":
    main(sys.argv[1:] or PHASES)
