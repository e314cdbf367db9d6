"""Host spans and counters of the live loop, per-stage timing and device
traces.

Counterpart of `uwslam_tpu.utils.profiling`, and the port's one tracing
module.

`Tracer`: named host spans and counters of one system. A span records its
name, its host seconds on `time.perf_counter` (the clock of the benchmark's
stamps) and the span it opened inside. Spans are inclusive. Seconds
accumulate in `table` under the span's name, one table of host seconds by
part, and the span's self time (its seconds less its children's) under
`<name>.self`; calls in `calls`. While a `torch.profiler` run is on, each
span is also a
`record_function` range named `uws_<name>`, so that the device trace's idle
gaps fall under the program's spans; with no profiler running the range is
never entered (one check of the profiler's state per span).

`StageTimer`: the synchronous path's stages (ingest, features, track,
select, ...) as spans `sync_<stage>` of a tracer. With `sync`, each stage
ends with `torch.cuda.synchronize()` so that queued device work is charged
to the stage that issued it; on a CPU-only run there is nothing to wait for
and no synchronization happens.

`trace`: a `torch.profiler` capture written as a Chrome trace.
`device_work`: the device records of a profile less the device images of
host ranges.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

PREFIX = "uws_"   # every range name; the benchmark keeps such ranges out of device work
SYNC = "sync_"    # the synchronous path's stages
SELF = ".self"    # a span's self time in the table: `<name>.self`


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("tracer", "name", "parent", "range", "t0", "child_s")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        opened = self.tracer._open
        self.parent = opened[-1] if opened else None
        opened.append(self)
        self.range = None
        if _profiler_on():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.child_s = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        tr, name, parent = self.tracer, self.name, self.parent
        tr._open.pop()
        table = tr.table
        table[name] = table.get(name, 0.0) + dt
        own = name + SELF
        table[own] = table.get(own, 0.0) + dt - self.child_s
        tr.calls[name] += 1
        if parent is None:
            tr.parents[name].add(None)
            tr.top_s += dt
        else:
            tr.parents[name].add(parent.name)
            parent.child_s += dt
        return False


class Tracer:
    """Spans and counters of one system (see the module's docstring).

    `table` is the dict the seconds go into (the caller's, so that what it
    already holds keeps its keys). `counts` holds the counters, `step_ms`
    the summed device milliseconds of each megastep stage over the
    `counts["step_frames"]` frames that carried them."""

    def __init__(self, table: dict):
        self.table = table
        self.calls: dict[str, int] = defaultdict(int)
        self.parents: dict[str, set] = defaultdict(set)   # span -> the spans it opened in
        self.top_s = 0.0               # seconds in outermost spans
        self.counts: dict[str, int] = defaultdict(int)
        self.step_ms: dict[str, float] = defaultdict(float)
        self._open: list[_Span] = []

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def add_step_ms(self, step_ms: dict[str, float]) -> None:
        for stage, ms in step_ms.items():
            self.step_ms[stage] += ms
        self.counts["step_frames"] += 1

    def line(self) -> str:
        """One line for the operator: the counters, under the depth
        bootstrap its own (replays, prior installs and drops, the retired
        frames' matches and inliers), the LM levels of the captured steps by
        path, the mean device ms of each megastep stage,
        and host ms per frame waiting (the event wait of a retirement) and
        working (the rest of the outermost spans)."""
        c = self.counts
        frames = max(c["dispatched"] + c["sync"], 1)
        wait = self.table.get("retire_wait", 0.0)
        parts = [
            f"trace: {c['dispatched']} dispatched, {c['retired']} retired, "
            f"{c['sync']} synchronous, {c['lost']} lost, {c['relocalized']} relocalized, "
            f"{c['keyframes']} keyframes, "
            f"{c['captures']} captures ({self.table.get('capture', 0.0):.2f} s)",
        ]
        if c["boot_replays"] or c["boot_inits"]:
            parts.append(f"boot: {c['boot_replays']} replays, {c['boot_inits']} prior installs, "
                         f"{c['boot_resets']} drops, {c['boot_matches']} matches, "
                         f"{c['boot_inliers']} inliers")
        if c["captures"]:
            parts.append(f"LM levels per replay of the captures: {c['lm_kernel_levels']} "
                         f"on lm_step, {c['lm_plain_levels']} plain")
        if c["step_frames"]:
            parts.append("step ms " + " ".join(
                f"{k} {v / c['step_frames']:.3f}" for k, v in self.step_ms.items()))
        parts.append(f"host ms per frame: waiting {1e3 * wait / frames:.3f}, "
                     f"working {1e3 * (self.top_s - wait) / frames:.3f}")
        return "; ".join(parts)


class StageTimer:
    """The synchronous path's stages as spans `sync_<stage>` of `tracer`."""

    def __init__(self, tracer: Tracer, sync: bool = True):
        self.tracer, self.sync = tracer, sync

    @contextlib.contextmanager
    def stage(self, name: str):
        with self.tracer.span(SYNC + name):
            try:
                yield
            finally:
                if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()

    def summary(self) -> dict[str, dict[str, float]]:
        tr = self.tracer
        return {
            k.removeprefix(SYNC): {
                "total_s": tr.table[k],
                "count": tr.calls[k],
                "mean_ms": 1e3 * tr.table[k] / max(tr.calls[k], 1),
            }
            for k in list(tr.calls) if k.startswith(SYNC)
        }

    def report(self) -> str:
        return "\n".join(
            f"{k:>12s}: {v['mean_ms']:8.2f} ms/call x{v['count']}"
            for k, v in sorted(self.summary().items())
        )


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where a card is visible) and write its Chrome trace (JSON,
    viewable in Perfetto or chrome://tracing) into `logdir` as
    `<pid>.<ns>.pt.trace.json`. Yields the profiler; its `trace_path` names
    the file once the block has ended.

    A pipelined frame replayed from a CUDA graph is one `cudaGraphLaunch`
    on the host: no operator or kernel launch of its own appears under the
    host's rows, while the device rows hold the replayed kernels by name
    (CUPTI records a graph's kernel nodes like launched kernels: over 16
    CLI frames on an H100, 15 of them replays, the records of each kernel
    matched the wrappers' launch counts but for up to 3 of 57 Scharr
    records, which a trace can come back short of). Every kernel is a
    record, so a trace grows by about 10 MB per live frame. The system's
    spans are `uws_*` ranges on the host's rows."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


def device_work(averages) -> list:
    """The device records among a profile's `key_averages()`: kernels,
    copies and fills. A host range's image on the device (a user annotation:
    the spans' `uws_*` ranges, the launcher's, a caller's own) spans the
    work inside it and is left out."""
    from torch.autograd import DeviceType

    return [a for a in averages if a.device_type == DeviceType.CUDA
            and not (a.is_user_annotation or a.key.startswith(PREFIX))]
