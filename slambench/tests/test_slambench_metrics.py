"""The metric arithmetic on made-up stamps and intervals: live_fps, both
latency percentiles, the host span, keyframe time and the device union,
and a stall inside the window that has to move them."""
import pytest

from slambench import spec, stats
from slambench.loop import Window
from slambench.trace import Trace


class State:
    def __init__(self, frame_id, is_keyframe=False, inliers=2000):
        self.frame_id, self.is_keyframe, self.tracked_inliers = frame_id, is_keyframe, inliers
        self.status = "ok"


class Run:
    def __init__(self, window=None, trace=None):
        self.window, self.trace, self.setup_s = window, trace, 12.5
        self.shape = {"height": 480, "width": 640, "levels": 3, "num_points": 2048,
                      "fc": True, "affine": False}
        self.device_kind = "NVIDIA H100 80GB HBM3"


def _window(period=0.01, lag=6, n=100, stall_at=None, stall=0.0):
    """Frame k handed over at its time, its pose delivered `lag` frames
    later; a stall of `stall` s before frame `stall_at` delays all after."""
    w = Window(t_open=0.0, counters_open={"make_keyframe": 1.0},
               counters_close={"make_keyframe": 1.05})
    t = 0.0
    for k in range(n + lag):
        if k == stall_at:
            t += stall
        if k < n:
            w.handed[k] = t
            w.spans.append(period * 0.9)
        if k >= lag:
            s = State(k - lag, is_keyframe=(k - lag) % 10 == 0)
            w.delivered[s.frame_id] = t + period * 0.9
            w.states[s.frame_id] = s
            if k < n:
                w.retired.append(s)
        t += period
    w.t_close = w.handed[n - 1] + period * 0.9
    return w


def read(name, run):
    return spec.metric_reader(name)(run)


def test_percentile_matches_linear_interpolation():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_window_metrics_on_steady_stamps():
    run = Run(_window())
    assert read("live_fps", run) == pytest.approx(94 / 0.999, rel=1e-9)
    # delivered at the return of the call 6 frames later: 6 x 10 + 9 ms
    assert read("pose_latency_ms_p95", run) == pytest.approx(69.0, abs=1e-6)
    assert read("pose_latency_ms_p50", run) == pytest.approx(69.0, abs=1e-6)
    assert read("loop.host_ms_per_frame", run) == pytest.approx(9.0)
    assert read("keyframe.host_ms", run) == pytest.approx(50.0 / 10, rel=1e-6)
    assert read("setup_s", run) == 12.5


def test_a_stall_in_the_window_moves_them():
    steady, stalled = Run(_window()), Run(_window(stall_at=50, stall=0.3))
    assert read("live_fps", stalled) < 0.8 * read("live_fps", steady)
    # frames handed over just before the stall wait it out
    assert read("pose_latency_ms_p95", stalled) > read("pose_latency_ms_p95", steady) + 200
    assert read("pose_latency_ms_p50", stalled) == pytest.approx(69.0, abs=1e-6)


def test_keyframe_time_is_nothing_without_keyframes():
    w = _window()
    for s in w.retired:
        s.is_keyframe = False
    assert read("keyframe.host_ms", Run(w)) is None


def test_busy_union_and_trace_metrics():
    assert stats.busy([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.busy([(0, 2), (1, 3), (5, 6)], lo=1.5, hi=5.5) == 2.0
    assert stats.gaps([(0, 2), (1, 3), (5, 6)]) == [(3, 5)]
    kernels = [("pyramid_kernel", 0.0, 0.0001), ("lm_evaluate_kernel<true>", 0.001, 0.00101),
               ("at::add", 0.0005, 0.0011)]
    device = kernels + [("Memcpy HtoD", 0.002, 0.003)]
    trace = Trace(window_s=0.01, kernels=kernels, device=device,
                  states=[State(0), State(1)])
    run = Run(_window(), trace)
    assert read("step.kernels_per_frame", run) == 1.5
    busy = 0.0001 + (0.0011 - 0.0005) + 0.001
    assert trace.busy_s == pytest.approx(busy)
    assert read("device.busy_ms_per_frame", run) == pytest.approx(1e3 * busy / 2)
    frame_s = run.window.seconds / run.window.retired_in_window
    assert read("device.idle_share", run) == pytest.approx(100 * (1 - busy / 2 / frame_s))
    # a stall stretches the window's time per frame: the idle share grows
    stalled = Run(_window(stall_at=50, stall=0.3), trace)
    assert read("device.idle_share", stalled) > read("device.idle_share", run)
    pyr = read("pyramid_roofline", run)
    assert 0 < pyr < 100
    assert read("lm_evaluate_roofline", run) == pytest.approx(
        100 * (2048 * 13 + 2000 * 52 + 248) / 3.35e12 / 1e-5)


def test_trace_metrics_are_nothing_without_a_trace():
    run = Run(_window())
    for name in ("step.kernels_per_frame", "lm_evaluate_roofline", "pyramid_roofline",
                 "device.busy_ms_per_frame", "device.idle_share"):
        assert read(name, run) is None
