"""Device clock stamps at the stage boundaries of a step (`csrc/stamp.cu`).

A `StageClock` is made inside the step function, so that a CUDA graph
captures its buffer and its launches with the step. `mark()` goes at the
start and after every stage but the last; `tail()` is room for one float
per stage, concatenated onto the row the host reads; `mark(out)` after the
last stage, with `out` that room, makes the last stamp write each stage's
device milliseconds there. So every replay carries its own stage times to
the host with its row, and the host reads them when it reads the row.

On a CPU device nothing is stamped and `tail()` is None. The stamps are not
among the counted wrappers (`ops.graph.COUNTED`): a graph's count of kernel
launches leaves them out.
"""
from __future__ import annotations

import torch

from . import _lib


class StageClock:
    def __init__(self, stages: tuple[str, ...], device: torch.device):
        self.stages = tuple(stages)
        self.device = device
        self.clock = (torch.empty(len(self.stages) + 1, dtype=torch.int64, device=device)
                      if device.type == "cuda" else None)
        self.slot = 0

    def tail(self) -> torch.Tensor | None:
        """Room for the stage times (float32), or None where nothing is stamped."""
        if self.clock is None:
            return None
        return torch.empty(len(self.stages), dtype=torch.float32, device=self.device)

    def mark(self, out: torch.Tensor | None = None) -> None:
        """Stamp the device's clock here; with `out` (the last stamp, after
        the last stage), also write the stage times into it."""
        if self.clock is None:
            return
        last = self.slot == len(self.stages)
        if self.slot > len(self.stages) or (out is not None) != last:
            raise ValueError(f"stamp {self.slot} of {len(self.stages) + 1}: the last one, "
                             f"and only it, takes the stage times' room")
        if out is not None:
            _lib.require(out, "out", (len(self.stages),), self.device)
        _lib.launch("uws_stamp", self.device, self.clock.data_ptr(),
                    None if out is None else out.data_ptr(), self.slot)
        self.slot += 1
