"""One run of one benchmark cell on the card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the system from the cell's configuration, renders the
traffic's ring of 8-bit frames from the seed into pinned host memory and
runs the pipelined loop for the mix's warm-up seconds (the kernels are
built or loaded, the frame's CUDA graph is captured, and the card leaves
its slow start, PERF.md section 2). The window then
hands frames to `SlamSystem.process_frame_async` in a closed loop for
`--seconds`. With `--trace 1` a profiled stretch of the configuration's
`trace_frames` frames follows. Then the program's state is freed and the
sampled frames are checked against the plain reference that the
configuration names.

The last line of standard output is one JSON object: `correct`,
`attempted` (frames handed over in the window), `failed` (of those, frames
that did not end tracked), `metrics` (the cell's end-to-end metrics, or
with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `check`, each compared number beside its limit. The
run exits non-zero with no result where there is no card, where the card
count is short of the cell's, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uwslam_tpu")


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window: object
    trace: object
    shape: dict
    device_kind: str


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program builds its CUDA library into `uwslam_tpu_torch/_build/`)."""
    cache = ROOT / "slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Measured:
    """A run up to its check: the window's stamps, the trace, the program's
    sampled answers and what the check and the readers need beside them."""

    setup_s: float
    window: object
    trace: object
    answers: list
    sampled: int
    ring: object
    memory_peak: int
    shape: dict
    setup_parts: dict
    trace_s: float


def measure(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Measured:
    """Set-up, window and optional trace of `cell` on `device`; the
    program's state is freed before this returns."""
    import torch

    from slambench import check, program, trace
    from slambench.loop import Feeder, Loop
    from slambench.traffic.ring import make_ring

    config, mix, bench = cell.config, cell.traffic, cell.config["bench"]
    cam = config["camera"]
    marks = [("imports", time.perf_counter())]
    system = program.build_system(config, device)
    marks.append(("system", time.perf_counter()))
    ring = make_ring(mix, cam, seed, device)
    marks.append(("ring", time.perf_counter()))
    loop = Loop(system, Feeder(ring, device), cam["hz"])
    sample = check.Sample(system, bench["check_frames"], seed, cell.reference.keep)
    loop.run_for(mix["warmup_seconds"])
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    setup_parts = {name: t - prev for (name, t), prev in
                   zip(marks, [t_start] + [t for _, t in marks[:-1]])}

    sample.active = True
    window = loop.window(seconds)
    sample.active = False
    t_trace = time.perf_counter()
    profiled = trace.profile_frames(loop, bench["trace_frames"]) if traced else None
    trace_s = time.perf_counter() - t_trace
    system.flush()
    _sync(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tcfg = system.config.tracker
    shape = {"height": system.cam.height, "width": system.cam.width,
             "levels": tcfg.pyramid_levels, "num_points": tcfg.num_points,
             "fc": tcfg.track_mode == "fc", "affine": tcfg.affine_brightness}
    states = {s.frame_id: s for s in system.trajectory}
    answers = [a for a in (cell.reference.answer(i, kept, states)
                           for i, kept in sorted(sample.kept.items())) if a is not None]
    sampled = len(sample.kept)
    # The program's state goes before the reference runs; the sampled
    # answers stay to be judged.
    del loop, system, sample, states
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Measured(setup_s, window, profiled, answers, sampled, ring, memory_peak, shape,
                    setup_parts, trace_s)


def reference_rows(m: Measured, cell, device, tf32: bool = False) -> list[dict]:
    """Each sampled answer's numbers against the cell's reference (float32,
    TF32 off). With `tf32` the reference is also run with TF32 on and put in
    the program's place: the control."""
    from slambench import check

    ref_module, config = cell.reference, cell.config
    rows = []
    for a in m.answers:
        with check.precision(tf32=False):
            ref = ref_module.reference(m.ring, a, config, device)
        if tf32:
            with check.precision(tf32=True):
                a = ref_module.reference(m.ring, a, config, device)
        rows.append(ref_module.compare(a, ref))
    return rows


def report(cell, m: Measured, rows: list[dict], traced: bool, device) -> dict:
    """The result object of a run."""
    import torch

    from slambench import check, spec, trace

    correct, table = check.judge(cell.reference.summarize(rows), len(rows), m.sampled,
                                 cell.limits)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(setup_s=m.setup_s, window=m.window, trace=m.trace, shape=m.shape,
              device_kind=kind)
    metrics = {}
    for metric in cell.metrics(traced):
        value = spec.metric_reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": m.memory_peak}
    w = m.window
    result = {"correct": correct, "attempted": len(w.handed),
              "failed": sum(1 for k in w.handed if w.states[k].status != "ok"),
              "metrics": metrics, "device": dev}
    if m.trace is not None:
        dev["busy_s"] = m.trace.busy_s
        dev["window_s"] = m.trace.window_s
        result["breakdown"] = trace.breakdown(m.trace)
    result["check"] = {k: {"number": v, "limit": lim} for k, (v, lim) in table.items()}
    return result


def notes(m: Measured) -> list[str]:
    """Lines for standard error: where set-up went, and the window's poses
    delivered in each 5 s (the loop's speed drifts on a shared host)."""
    w = m.window
    per5 = [sum(1 for s in w.retired if lo <= w.delivered[s.frame_id] - w.t_open < lo + 5)
            for lo in range(0, int(w.seconds) + 1, 5)]
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in m.setup_parts.items())
    return [f"setup: {parts}", f"window: poses delivered per 5 s: {per5}",
            f"trace after the window: {m.trace_s:.2f} s"]


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> tuple[dict, list[str]]:
    """One run of `cell` on `device` -> (its result object, notes for
    standard error), without the look for a card, which `main` makes."""
    m = measure(cell, seed, seconds, traced, device, t_start)
    return report(cell, m, reference_rows(m, cell, device), traced, device), notes(m)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    cache_dirs()
    from slambench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"error: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k}: {v['number']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
