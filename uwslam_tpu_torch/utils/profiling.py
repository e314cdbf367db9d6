"""Per-stage wall-clock timing and device traces.

Counterpart of `uwslam_tpu.utils.profiling`. `StageTimer`: named
accumulators of wall time per pipeline stage (ingest, features, track,
select). With `sync`, each stage ends with `torch.cuda.synchronize()` so
that queued device work is charged to the stage that issued it; on a
CPU-only run there is nothing to wait for and no synchronization happens.
`trace`: a `torch.profiler` capture written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.total: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in self.total
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
    record, so a trace grows by about 10 MB per live frame."""
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
