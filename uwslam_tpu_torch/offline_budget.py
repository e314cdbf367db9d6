"""The offline chunk's time by stage on one card: each stage of the bench
chunk run alone at the full design point.

    python -m uwslam_tpu_torch.offline_budget [--out BUDGET_TORCH_r11.json] [--platform cuda|cpu]

Counterpart of `benchmarks/offline_budget.py` (the JAX package's), on the
bench's scene (`bench.bench_poses`, `bench.bench_frames`: 96 frames of 480 x
640, 5 levels, track levels (3, 2, 1, 0) with (12, 8, 5, 3) LM iterations,
2048 points, IC). Its stages, under the JAX script's names, each on inputs
built before it is timed:

- `pyramid5_batched(b96)`: `image.pyramid.build_pyramid_batched`;
- `topk_select(b96)`: `tracking.points.topk_gradient_points` on the level-0
  planes (batched already, with the gradients the chunk carries to level 0);
- `track_levels(3,)(b95)` ... `track_levels(3, 2, 1, 0)(b95)`:
  `tracking.photometric.track(mode="ic")` of the 95 pairs on those pyramids
  and points, one row per prefix of the track levels, its note the marginal
  ms of the last level;
- `full_chunk(b96)`: `tracking.sequence.track_sequence_batched`, the three
  stages in one call, as `bench` times it.

Every row has `ms_per_chunk` (CUDA events around each of `STAGE_REPS` calls
after a warm-up call, the median), `device_busy_ms` and `launches` (the
profiler's kernel time and kernel count of one call), `idle_share` (1 -
busy / ms: the share of the call with no kernel running) and the op of
`MICRO_TORCH_r11.json` that covers the stage, where one does. The eager chunk
is host-bound, so wall time and device time part widely: `ms_per_chunk` is
wall time on the device's clock, `device_busy_ms` is kernel time. Below the
rows: `fps_serial` (95 pairs over the full chunk's median) and
`fps_pipelined` (six chunks back to back, each on the frames + 0.25 p, after
one such pass), the full chunk's ATE, the stages' busy sum against the full
chunk's, and the card's name and power limit (nvidia-smi). A card is the
default and there is no fallback: without one, or when the profiler records
no kernel, the run fails. `--platform cpu` runs the same stages on the CPU
(`--frames` for fewer frames), timed by the host's clock, with no device
figures.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from . import bench, micro
from .image.pyramid import build_pyramid_batched
from .tracking.photometric import track
from .tracking.points import topk_gradient_points
from .tracking.sequence import track_sequence_batched

STAGE_REPS = 10
PIPELINED_CHUNKS = 6
PIPELINE_STEP = 0.25         # gray levels added to the frames of each pipelined chunk
MICRO_PATH = Path(__file__).resolve().parent.parent / "MICRO_TORCH_r11.json"   # cited rows
MICRO_OPS = {"pyramid5_batched": "pyramid5_k1", "topk_select": "topk_points"}


class Design(NamedTuple):
    """The chunk's configuration (the bench's by default)."""

    levels: int = bench.LEVELS
    track_levels: tuple[int, ...] = bench.TRACK_LEVELS
    iters: tuple[int, ...] = bench.ITERS
    num_points: int = bench.NUM_POINTS
    mono_z: float = bench.MONO_Z


class Stage(NamedTuple):
    name: str
    fn: Callable
    note: str = ""


def scene(num_frames: int, cam=bench.CAM, device="cuda"):
    """(poses (N, 4, 4), frames (N, H, W)): the JAX script's recipe, which is
    the bench's: the plane at z = 2 from poses amp * sin(2 pi i / 24)."""
    poses = bench.bench_poses(num_frames, device=device)
    return poses, bench.bench_frames(poses, cam)


def track_prefix(ref, tgt, pts, cam, design: Design, n_levels: int) -> torch.Tensor:
    """The pairs' poses (B, 4, 4) tracked over the first `n_levels` track
    levels, coarse first, from the identity."""
    return track(ref, tgt, pts, cam, levels=design.track_levels[:n_levels],
                 max_iters=design.iters[:n_levels], mode="ic").T


def stages(frames, cam, design: Design = Design()) -> list[Stage]:
    """The stages, their inputs built here (once, before any timing)."""
    n = frames.shape[0]
    pyrs = build_pyramid_batched(frames, levels=design.levels)

    def select():
        return topk_gradient_points(pyrs.images[0], pyrs.grad_mag[0], cam,
                                    num_points=design.num_points, mono_z=design.mono_z,
                                    grad_x=pyrs.grad_x[0], grad_y=pyrs.grad_y[0])

    pts = select()
    ref, tgt = pyrs.select(slice(None, -1)), pyrs.select(slice(1, None))
    ref_pts = pts.select(slice(None, -1))
    out = [Stage(f"pyramid5_batched(b{n})",
                 lambda: build_pyramid_batched(frames, levels=design.levels)),
           Stage(f"topk_select(b{n})", select)]
    for k in range(1, len(design.track_levels) + 1):
        out.append(Stage(f"track_levels{design.track_levels[:k]}(b{n - 1})",
                         lambda k=k: track_prefix(ref, tgt, ref_pts, cam, design, k),
                         f"marginal level {design.track_levels[k - 1]}"))
    out.append(Stage(f"full_chunk(b{n})", lambda: full_chunk(frames, cam, design),
                     "pyramid, selection and tracking of every pair in one eager call"))
    return out


def full_chunk(frames, cam, design: Design = Design()) -> torch.Tensor:
    return track_sequence_batched(
        frames, cam, mono_z=design.mono_z, levels=design.levels,
        track_levels=design.track_levels, num_points=design.num_points,
        max_iters=design.iters, mode="ic")[0]


def wall_ms(fn, reps: int, cuda: bool) -> list[float]:
    """ms of each of `reps` calls after a warm-up call: on a card CUDA events
    between consecutive calls, on the CPU the host's clock."""
    fn()
    if not cuda:
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return out
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def kernel_time(fn) -> tuple[float, float]:
    """(device busy ms, kernel launches) of one call; raises where the
    profiler records no kernel."""
    profiled = micro.kernel_profile(fn, reps=1)
    if profiled is None:
        raise RuntimeError("torch.profiler recorded no device time for the stage: "
                           "no budget without it")
    return profiled


def micro_rows(path: Path) -> dict:
    """{op prefix: row} of a micro benchmark's result file, each row naming
    the file and its card; {} without one."""
    if not path.exists():
        return {}
    cited = json.loads(path.read_text())
    return {op["op"].split("(")[0]: {"file": path.name, "device": cited["device"],
                                     "op": op["op"], "ms": op["ms"]} for op in cited["ops"]}


def _key(stage_name: str) -> str:
    """A stage's name without its batch: `track_levels(3, 2)(b95)` -> `track_levels(3, 2)`."""
    return stage_name.rsplit("(b", 1)[0]


def budget(frames, poses, cam, design: Design = Design(), reps: int = STAGE_REPS) -> dict:
    """The budget table of the chunk `frames` (see the module's docstring)."""
    cuda = frames.device.type == "cuda"
    cited = micro_rows(MICRO_PATH)
    rows, prev = [], {"ms": 0.0, "busy": 0.0}
    busy = {}
    for stage in stages(frames, cam, design):
        times = wall_ms(stage.fn, reps, cuda)
        ms = statistics.median(times)
        row = {"stage": stage.name, "ms_per_chunk": ms, "ms_spread": [min(times), max(times)]}
        if cuda:
            row["device_busy_ms"], row["launches"] = kernel_time(stage.fn)
            row["idle_share"] = 1.0 - row["device_busy_ms"] / ms
        else:
            row.update(device_busy_ms=None, launches=None, idle_share=None)
        note = stage.note
        if note.startswith("marginal"):
            note += f": {ms - prev['ms']:+.3f} ms wall"
            if cuda:
                note += f", {row['device_busy_ms'] - prev['busy']:+.4f} ms busy"
            prev = {"ms": ms, "busy": row["device_busy_ms"] or 0.0}
        row["note"] = note
        op = MICRO_OPS.get(_key(stage.name))
        if op in cited:
            row["micro"] = cited[op]
        busy[_key(stage.name)] = row["device_busy_ms"]
        rows.append(row)

    n = frames.shape[0]
    full_ms = rows[-1]["ms_per_chunk"]
    chunks = [frames + PIPELINE_STEP * p for p in range(PIPELINED_CHUNKS)]
    pipelined_ms = wall_ms(lambda: [full_chunk(c, cam, design) for c in chunks], 1, cuda)[0]
    T_rel = full_chunk(frames, cam, design)
    out = {"budget": rows,
           "fps_serial": (n - 1) / (full_ms / 1e3),
           "fps_pipelined": PIPELINED_CHUNKS * (n - 1) / (pipelined_ms / 1e3),
           "ate_m": bench.trajectory_ate(T_rel, poses),
           "frames": n, "reps": reps}
    if cuda:
        track_name = f"track_levels{design.track_levels}"
        parts = busy["pyramid5_batched"] + busy["topk_select"] + busy[track_name]
        out["stage_sum"] = {"stages_busy_ms": parts, "full_chunk_busy_ms": busy["full_chunk"],
                            "relative_gap": parts / busy["full_chunk"] - 1.0}
    return out


def identity(cuda: bool) -> str:
    if cuda:
        return bench.gpu_identity()
    return f"cpu ({platform.machine()}, {torch.get_num_threads()} threads)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="BUDGET_TORCH_r11.json")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) times on the card; cpu on the host's clock")
    ap.add_argument("--frames", type=int, default=bench.NUM_FRAMES)
    args = ap.parse_args(argv)
    cuda = args.platform == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("offline_budget: --platform cuda (the default) needs a CUDA card and "
                         "none is visible")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    poses, frames = scene(args.frames, device=dev)
    out = {"device": identity(cuda),
           "torch": torch.__version__,
           "note": ("Each stage alone on inputs built before it; ms_per_chunk is the median "
                    "of CUDA events around each call (wall time on the device's clock), "
                    "device_busy_ms the profiler's kernel time of one call. The eager chunk "
                    "is host-bound: the two part widely." if cuda else
                    "CPU run: host clock, no device figures."),
           **budget(frames, poses, bench.CAM, reps=STAGE_REPS if cuda else 1)}
    text = json.dumps(out, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
