"""The readers of the bootstrap megastep's metrics on made-up windows: its
stage stamps (`FrameState.step_ms` of `features`, `match`, `prior`), the
host table's growth of the span `ransac_uniforms`, and the share of frames
that ran the bootstrap replay. A program without the span, frames without
stamps and a CPU device read None, and nothing raises."""
import pytest

from slambench import spec
from slambench.loop import Window

NAMES = ("boot.features_ms_per_frame", "boot.match_ms_per_frame", "boot.prior_ms_per_frame",
         "boot.uniforms_host_ms_per_frame", "boot.graph_share")
BOOT_MS = {"ingest": 0.01, "features": 3.0, "match": 13.0, "track": 1.0, "pose": 0.2,
           "prior": 1.5, "select": 0.3}


class State:
    def __init__(self, frame_id, step_ms=None):
        self.frame_id, self.is_keyframe, self.status = frame_id, False, "ok"
        self.step_ms = step_ms


class Run:
    def __init__(self, window, device_kind="NVIDIA H100 80GB HBM3"):
        self.window, self.trace, self.setup_s, self.device_kind = window, None, 40.0, device_kind


def _window(n=40, synchronous=4, span=True):
    """n calls of 20 ms, one frame each; the first `synchronous` frames took
    the synchronous path (no stamps); the host table grows by 0.25 ms of
    `ransac_uniforms` per call."""
    opened, closed = {"dispatch": 1.0}, {"dispatch": 1.0 + n * 0.001}
    if span:
        opened["ransac_uniforms"], closed["ransac_uniforms"] = 0.5, 0.5 + n * 0.00025
    w = Window(t_open=0.0, t_close=n * 0.02, counters_open=opened, counters_close=closed)
    for k in range(n):
        w.handed[k] = 0.02 * k
        w.spans.append(0.02)
        s = State(k, None if k < synchronous else dict(BOOT_MS))
        w.delivered[k] = 0.02 * (k + 5)
        w.states[k] = s
        w.retired.append(s)
    return w


def read(name, run):
    return spec.metric_reader(name)(run)


def test_the_readers_on_a_boot_window():
    run = Run(_window())
    assert read("boot.features_ms_per_frame", run) == pytest.approx(3.0)
    assert read("boot.match_ms_per_frame", run) == pytest.approx(13.0)
    assert read("boot.prior_ms_per_frame", run) == pytest.approx(1.5)
    assert read("boot.uniforms_host_ms_per_frame", run) == pytest.approx(0.25)
    assert read("boot.graph_share", run) == pytest.approx(90.0)


def test_plain_stamps_carry_no_boot_stage():
    w = _window(synchronous=0)
    for s in w.retired:
        s.step_ms = {"ingest": 0.01, "track": 0.5, "pose": 0.2, "select": 0.1}
    run = Run(w)
    for name in NAMES[:3]:
        assert read(name, run) is None
    assert read("boot.graph_share", run) == 0.0


def test_a_program_without_the_span_reads_no_uniforms_time():
    assert read("boot.uniforms_host_ms_per_frame", Run(_window(span=False))) is None


def test_a_cpu_device_and_an_empty_window_read_no_share():
    assert read("boot.graph_share", Run(_window(), device_kind="cpu")) is None
    empty = Window(counters_open={}, counters_close={})
    for name in NAMES:
        assert read(name, Run(empty)) is None


def test_each_is_declared_for_the_features_cell_alone():
    entries = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in NAMES:
        assert entries[name]["workloads"] == ["tum_mono_features.replay"]
        assert entries[name]["moves"] == "live_fps"
