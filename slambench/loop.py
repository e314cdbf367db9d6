"""The closed loop: the harness's camera driver and its stamps.

Frames wait in host memory (pinned where there is a card) as 8-bit images.
Each is uploaded one frame ahead on a side stream, the way
`uwslam_tpu_torch.io.dataset.DeviceFramePrefetcher._upload` does it, and
handed to `SlamSystem.process_frame_async` as soon as the previous call has
returned. Every hand-off and every call's return is stamped on the host
clock, and a frame's pose counts as delivered at the return of the call
in which its `FrameState` joined `system.trajectory`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


class Feeder:
    """Run frame k of the ring, uploaded one frame ahead."""

    def __init__(self, ring, device):
        self.ring = ring
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.k = 0
        self._held = self._upload(0)

    def _upload(self, k: int):
        host = self.ring.frame(k)
        if self.stream is None:
            return host.clone(), None
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return dev, event

    def next(self) -> tuple[int, torch.Tensor]:
        """-> (k, frame k on the device), with frame k + 1's upload started."""
        dev, event = self._held
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            dev.record_stream(current)
        k = self.k
        self.k += 1
        self._held = self._upload(self.k)
        return k, dev


@dataclass
class Window:
    """Host stamps of one measured window (seconds on `time.perf_counter`)."""

    t_open: float = 0.0
    t_close: float = 0.0
    handed: dict = field(default_factory=dict)     # frame id -> hand-off
    delivered: dict = field(default_factory=dict)  # frame id -> return of its call
    spans: list = field(default_factory=list)      # each window call's host seconds
    retired: list = field(default_factory=list)    # FrameStates delivered in [open, close]
    states: dict = field(default_factory=dict)     # frame id -> FrameState
    counters_open: dict = field(default_factory=dict)   # the program's counters
    counters_close: dict = field(default_factory=dict)

    @property
    def retired_in_window(self) -> int:
        return len(self.retired)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


class Loop:
    """`system` fed by `feeder`, one call per frame; frame k carries the
    timestamp k / hz."""

    def __init__(self, system, feeder: Feeder, hz: float):
        self.system = system
        self.feeder = feeder
        self.hz = hz

    def step(self):
        """Hand over one frame -> (frame id, hand-off, return, new states)."""
        traj = self.system.trajectory
        before = len(traj)
        k, frame = self.feeder.next()
        t_hand = time.perf_counter()
        self.system.process_frame_async(frame, timestamp=k / self.hz)
        t_ret = time.perf_counter()
        return k, t_hand, t_ret, traj[before:]

    def run_for(self, seconds: float) -> None:
        """Hand frames over for `seconds` (warm-up: nothing is recorded)."""
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            self.step()

    def window(self, seconds: float) -> Window:
        """Hand frames over for `seconds`, then keep the loop going (frames
        not counted) until every frame handed over in the window has its
        pose. The program's host-time counters are read at the window's
        opening and close."""
        w = Window(counters_open=dict(self.system.retire_host_s))
        w.t_open = time.perf_counter()
        t_end = w.t_open + seconds
        t_ret = w.t_open
        while t_ret < t_end:
            k, t_hand, t_ret, new = self.step()
            w.handed[k] = t_hand
            w.spans.append(t_ret - t_hand)
            for s in new:
                w.delivered[s.frame_id] = t_ret
                w.states[s.frame_id] = s
                w.retired.append(s)
        w.t_close = t_ret
        w.counters_close = dict(self.system.retire_host_s)
        # Drain: the loop runs on, as it would for a user, until the window's
        # last frames have their poses; their latency counts that wait.
        waiting = set(w.handed) - set(w.delivered)
        while waiting:
            _, _, t_ret, new = self.step()
            for s in new:
                w.delivered[s.frame_id] = t_ret
                w.states[s.frame_id] = s
                waiting.discard(s.frame_id)
        return w
