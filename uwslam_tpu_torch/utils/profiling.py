"""Per-stage wall-clock timing.

Counterpart of `uwslam_tpu.utils.profiling.StageTimer`: named accumulators
of wall time per pipeline stage (ingest, features, track, select). With
`sync`, each stage ends with `torch.cuda.synchronize()` so that queued
device work is charged to the stage that issued it; on a CPU-only run
there is nothing to wait for and no synchronization happens.
"""
from __future__ import annotations

import contextlib
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
