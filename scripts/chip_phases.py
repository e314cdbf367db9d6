"""Some phases of `chip_smoke.py` alone. Phases 21, 22, 23, 15 and 17 run
beside the port's CPU run of config 5 over the quick sequence (phase 20's,
which loads the host while they run; 15 and 17 read their own CPU runs from
a `chip_smoke.ProcessRuns`); phase 20 (configs 5-7, with that CPU
run of its own), phase 24 (eval.py's configs 0-4 and 8-10 at full size) and
phase 25 (the measuring tools: offline budget, attribution, scaling curve)
run after them, alone. `frames DIR [NAME ...]` renders those phases' data
on the card instead, under eval.py's directory names, and runs nothing.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_phases.py [21] [22] [23] [15] [17] [20] [24] [25]`
(default: all eight, ~16 minutes on an H100). It prints the card's name and
power limit, then one line per phase with its JSON result, its seconds and
the running total, and the CPU run of config 5 and its health check after
the phases it ran beside; the first failing phase stops it with a non-zero
exit.

`python scripts/chip_phases.py frames DIR [NAME ...]` writes the card's
render of the sequences those phases run (`chip_smoke.EVAL_DATASETS`: default
all five) to DIR/NAME, each with its DONE marker, and prints each one's
digest (`chip_smoke.frames_digest`). The JAX CLI reads such a directory as
eval.py's own (`UWSLAM_EVAL_DATA=DIR python scripts/jax_eval_reference.py` and
`scripts/jax_config5_spread.py`), which gives the JAX package's figures on
the very frames the card runs.
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

BESIDE_CPU_RUN = ("21", "22", "23", "15", "17")
ALONE = ("20", "24", "25")
PHASES = BESIDE_CPU_RUN + ALONE


def beside_cpu_run(which, table, dev) -> None:
    poses = bench.bench_poses(device=dev)
    frames = bench.bench_frames(poses)
    with tempfile.TemporaryDirectory() as tmp:
        quick = cs.write_tum_sequence(Path(tmp) / "quick", cs.QUICK_FRAMES, cs.QUICK_LOOP_PERIOD,
                                      dev)
        cpu_run5 = cs.start_cpu_config5(Path(tmp) / "cpu_config5", quick)
        try:
            if "21" in which:
                cs.say("21", json.dumps(cs.phase_sequence_sharded(frames, poses, table)))
            if "22" in which:
                cs.say("22", " ".join(json.dumps(x) for x in cs.phase_photo_sharded()))
            if "23" in which:
                cs.say("23", " ".join(json.dumps(x) for x in cs.phase_session(frames, poses, table)))
            scene, scene_poses = cs.scene_sequence(dev)
            jobs = {j: None for p, j in (("15", "config2"), ("17", "config4")) if p in which}
            worker = cs.ProcessRuns(Path(tmp) / "cpu_jobs", "cpu", jobs,
                                    {"frames": frames.cpu(), "scene": scene.cpu()})
            try:
                if "15" in which:
                    cs.say("15", json.dumps(cs.phase_config2(scene, scene_poses, frames, poses,
                                                             table, worker)[0]))
                if "17" in which:
                    # Phase 17 reports the pipelined frame times beside those of a
                    # run without BA, which only phase 11 measures: a stand-in.
                    cs.say("17", json.dumps(cs.phase_config4(frames, poses, table, [11.5] * 96,
                                                             worker)))
            finally:
                worker.stop()
            c, _ = cpu_run5.result("config5_quick")
        finally:
            cpu_run5.stop()
        c.pop("_poses")
        cs.say("20 CPU run of config 5", json.dumps(c))
        cs.health_checks(5, c)
        cs.say("20 CPU run of config 5: health checks", "ok")


def frames(root: str, names) -> None:
    dev = torch.device("cuda", 0)
    for name in names or cs.EVAL_DATASETS:
        cs.render_eval_dataset(Path(root), name, dev)
        cs.say(f"frames {name}", cs.frames_digest(Path(root) / name))


def main(which) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA card is visible; nothing was run")
    if which[:1] == ["frames"]:
        cs.say("1 device", bench.gpu_identity())
        frames(which[1], which[2:])
        return
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_phases: no phase {unknown}; the phases are {PHASES}")
    dev = torch.device("cuda", 0)
    cs.say("1 device", bench.gpu_identity())
    _, build_s, _ = _lib.build()
    cs.say("2 build", f"{build_s:.1f} s")
    table = cs.kernels_table()
    if set(which) & set(BESIDE_CPU_RUN):
        beside_cpu_run(which, table, dev)
    if "20" in which:
        with tempfile.TemporaryDirectory() as tmp:
            loops, cpu = cs.phase_loop_configs(table, Path(tmp))
            try:
                cs.phase_loop_cpu(loops, cpu)
            finally:
                cpu[0].stop()
        cs.say("20", json.dumps(loops, default=str))
    if "24" in which:
        cs.say("24", json.dumps(cs.phase_eval_configs(table), default=str))
    if "25" in which:
        cs.say("25", json.dumps(cs.phase_tools_fresh()))


if __name__ == "__main__":
    main(sys.argv[1:] or PHASES)
