"""How many kernel records a `torch.profiler` window keeps on the card, by
the way the window is opened.

    python scripts/profile_record_loss.py windows REPS CHUNK_REPS
    python scripts/profile_record_loss.py warm REPS CHUNK_REPS

Both build the bench's 96 frames of 480 x 640 (`uwslam_tpu_torch.bench`),
run one offline chunk (`offline_budget.full_chunk`) unprofiled, and print one
JSON object: for each kind of window a list of [pyramid kernel records,
kernel records] per window (the launcher's `uws_` ranges left out), or for
`kernel_profile` its (ms, launches) per call. A window holds one pyramid
launch (1 record) or one chunk (1 pyramid record of 11,090). The kinds
alternate within each of REPS rounds; the chunk windows run in the first
CHUNK_REPS rounds only.

`windows`: a window opened on the work it records (`plain`, and with Python
stacks `stack`), one that opens on a one-element add first (`sacrificial`,
the add recorded), and one after a warm-up step under a `schedule`
(`warm`). `warm`: 40 plain pyramid windows first, then windows opened by
`micro.warm_profile` with no warm-up call (`burst`: its one-element adds
only) or with the recorded work as the warm-up call (`fn`, `chunk`), and
`micro.kernel_profile` of the pyramid alone.

Run from the repository root on a machine with a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from uwslam_tpu_torch import bench, micro  # noqa: E402
from uwslam_tpu_torch.offline_budget import full_chunk  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402
from uwslam_tpu_torch.ops.cuda_pyramid import cuda_build_pyramid  # noqa: E402

ACT = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def counts(prof) -> list[int]:
    """[pyramid kernel records, kernel records] of one profile."""
    pyr = tot = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith(("uws_", "ProfilerStep")):
            tot += e.count
            pyr += e.count if "pyramid_kernel" in e.key else 0
    return [pyr, tot]


def plain(fn, stack=False):
    torch.cuda.synchronize()
    with _lib.launch_ranges(), profile(activities=ACT, with_stack=stack) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def sacrificial(fn, stack=False):
    z = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    with _lib.launch_ranges(), profile(activities=ACT, with_stack=stack) as prof:
        z.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return prof


def warm(fn, stack=False):
    torch.cuda.synchronize()
    with _lib.launch_ranges(), profile(activities=ACT, with_stack=stack, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def windows(pyr, chunk, reps: int, chunk_reps: int) -> dict:
    res = {}
    for rep in range(reps):
        for name, (win, fn, stack) in {
                "pyr_plain": (plain, pyr, False), "pyr_stack": (plain, pyr, True),
                "pyr_sacrificial": (sacrificial, pyr, True), "pyr_warm": (warm, pyr, True),
                "chunk_plain": (plain, chunk, False), "chunk_stack": (plain, chunk, True),
                "chunk_warm": (warm, chunk, True),
                "chunk_sacrificial": (sacrificial, chunk, True)}.items():
            if name.startswith("chunk") and rep >= chunk_reps:
                continue
            res.setdefault(name, []).append(counts(win(fn, stack)))
    return res


def warm_profiles(pyr, chunk, reps: int, chunk_reps: int) -> dict:
    def none():
        return None

    aged = []
    for _ in range(40):
        with profile(activities=ACT) as prof:
            pyr()
            torch.cuda.synchronize()
        aged.append(counts(prof)[0])
    res = {"aged_plain": aged}
    for rep in range(reps):
        res.setdefault("pyr_burst", []).append(counts(micro.warm_profile(pyr, none)))
        res.setdefault("pyr_fn", []).append(counts(micro.warm_profile(pyr, pyr)))
        res.setdefault("kernel_profile", []).append(micro.kernel_profile(pyr, reps=1))
        if rep < chunk_reps:
            with _lib.launch_ranges():
                res.setdefault("chunk_burst", []).append(
                    counts(micro.warm_profile(chunk, none, with_stack=True)))
                res.setdefault("chunk_chunk", []).append(
                    counts(micro.warm_profile(chunk, chunk, with_stack=True)))
    return res


def main() -> None:
    mode, reps, chunk_reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if not torch.cuda.is_available():
        raise SystemExit("profile_record_loss: no CUDA card is visible")
    frames = bench.bench_frames(bench.bench_poses(device=torch.device("cuda", 0)))
    full_chunk(frames, bench.CAM)
    torch.cuda.synchronize()

    def pyr():
        cuda_build_pyramid(frames, 5)

    def chunk():
        full_chunk(frames, bench.CAM)

    run = {"windows": windows, "warm": warm_profiles}[mode]
    print(json.dumps({"mode": mode, "gpu": bench.gpu_identity(),
                      "windows": run(pyr, chunk, reps, chunk_reps)}))


if __name__ == "__main__":
    main()
