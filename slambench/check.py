"""The output check that decides `correct`, common to every reference.

Answers are checked one by one. The sample is drawn from the seed over the
frames handed over in the window (reservoir sampling, so it spans the whole
window at a fixed memory cost) and holds what the cell's reference keeps of
each sampled frame as the program dispatched it. Once the window has
closed, the reference (`reference/<module>.py`, named by the
configuration) works every compared quantity out again from the harness's
own 8-bit frames and reduces the rows to its numbers, which `judge` holds
to the configuration's limits.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions with TF32 on or off (the
    reference: off; its control: on), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Sample:
    """Reservoir of what `keep(rec, prev)` holds of the frames dispatched
    while `active`, `size` of them, chosen by a generator of the seed. It
    wraps the system's `_dispatch_pipelined`, the one place where a
    pipelined frame's outputs come back from its graph replay, and holds the
    record dispatched last (and no other) to pass as the next one's `prev`."""

    def __init__(self, system, size: int, seed: int, keep):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.keep = keep
        self.kept: dict[int, object] = {}
        self.seen = 0
        self.active = False
        self.last = None
        dispatch = system._dispatch_pipelined

        def wrapped(image, ts):
            rec = dispatch(image, ts)
            if self.active:
                self._offer(rec)
            self.last = rec
            return rec

        system._dispatch_pipelined = wrapped

    def _offer(self, rec) -> None:
        self.seen += 1
        item = self.keep(rec, self.last)
        if len(self.kept) < self.size:
            self.kept[rec["frame_id"]] = item
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[rec["frame_id"]] = item


def judge(numbers: dict, compared: int, sampled: int, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: [number, limit]}): every number the limits name
    within its limit, and at least `min_compared` of the sample comparable."""
    names = [k for k in limits if k != "min_compared"]
    table = {k: [numbers[k], limits[k]] for k in names}
    share = compared / max(sampled, 1)
    table["compared_share"] = [share, limits["min_compared"]]
    ok = share >= limits["min_compared"] and all(
        np.isfinite(v) and v <= lim for k, (v, lim) in table.items() if k in names)
    return bool(ok), table
