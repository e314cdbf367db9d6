"""The device trace of a `--trace 1` run: a `torch.profiler` window over a
few frames of the running loop, and the records the metric readers take
from it.

The window is opened after a dropped warm-up step (`WARM_LAUNCHES` one-
element adds and one frame, traced and left out), as the program's
`micro.warm_profile` does: on an H100 a profile whose tracing starts on the
work it is to record comes back short of its first kernel records.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

from . import stats

WARM_LAUNCHES = 1024
# host ranges that the profiler also draws on the device's timeline: the
# harness's frames and the program's kernel launches (`ops._lib.launch`)
RANGES = ("slambench.", "uws_")


@dataclass
class Trace:
    """Device records of the traced window (seconds, on the profiler's
    clock), the host ranges beside them, and the frames retired in it."""

    window_s: float
    kernels: list = field(default_factory=list)   # (name, start, end)
    device: list = field(default_factory=list)    # kernels, copies, fills: (name, start, end)
    host: list = field(default_factory=list)      # host ops and ranges: (name, start, end)
    states: list = field(default_factory=list)    # FrameStates retired in the window

    @property
    def busy_s(self) -> float:
        return stats.busy((s, e) for _, s, e in self.device)


def kernel_name(name: str) -> str:
    """`void (anonymous namespace)::k<true>(float const*)` -> `k<true>`."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix(
        "void ").strip()


def _records(prof) -> tuple[list, list, list]:
    from torch.autograd import DeviceType

    kernels, device, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            host.append((name, start, end))
        elif not (e.is_user_annotation() or name.startswith(RANGES)):
            # kernels, copies and fills; a host range's image on the device is none
            device.append((name, start, end))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, start, end))
    return kernels, device, host


def profile_frames(loop, frames: int) -> Trace:
    """Trace `frames` steps of `loop` (closed loop, as in the window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    system = loop.system
    dev = system.device
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    try:
        one = torch.zeros(1, device=dev)
        for _ in range(WARM_LAUNCHES):
            one.add_(1.0)
        loop.step()
        torch.cuda.synchronize(dev)
    finally:
        prof.start_trace()
    before = len(system.trajectory)
    t0 = time.perf_counter()
    try:
        for _ in range(frames):
            with record_function("slambench.frame"):
                loop.step()
        torch.cuda.synchronize(dev)
    finally:
        t1 = time.perf_counter()
        prof.stop_trace()
    kernels, device, host = _records(prof)
    return Trace(window_s=t1 - t0, kernels=kernels, device=device, host=host,
                 states=list(system.trajectory[before:]))


def breakdown(trace: Trace, top: int = 10, labelled: int = 2000) -> dict:
    """The device operations that took most time, and the idle gaps by the
    innermost host range open when each began, each summed by name (the
    `labelled` longest gaps; the rest, a replay's thousands of sub-microsecond
    gaps between its kernels, summed as one)."""
    by_op: dict[str, float] = {}
    for name, s, e in trace.device:
        key = kernel_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = sorted(stats.gaps((s, e) for _, s, e in trace.device), key=lambda g: g[0] - g[1])
    by_host = {"(shorter gaps)": sum(g1 - g0 for g0, g1 in gaps[labelled:])}
    for g0, g1 in gaps[:labelled]:
        i = bisect.bisect_right(starts, g0)
        label, width = "(no host range)", float("inf")
        # the innermost open range: the narrowest of those begun before g0
        for name, s, e in host[max(0, i - 256):i]:
            if e >= g0 and e - s < width:
                label, width = name, e - s
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
