"""The readers of the program's own spans, counters and stage stamps on
made-up windows: the host table's growth over the window (`retire_wait`,
`dispatch`, and `retire`'s self time `retire.self`), `FrameState.in_flight` and
`FrameState.step_ms`. A program without them (an older one: no such keys,
no such fields), a window with no keyframes and frames without `step_ms`
must give numbers where the reader has something to read and None where it
has not, and never raise."""
import pytest

from slambench import spec
from slambench.loop import Window

NAMES = ("loop.wait_ms_per_frame", "dispatch.host_ms_per_frame", "retire.host_ms_per_frame",
         "retire.frames_in_flight", "step.device_ms_per_frame", "step.track_ms_per_frame")
OLD_KEYS = ("make_keyframe", "match_dispatch", "match_wait", "add_keyframe_matches",
            "build_problem")


class State:
    def __init__(self, frame_id, is_keyframe=False, in_flight=None, step_ms=None):
        self.frame_id, self.is_keyframe, self.status = frame_id, is_keyframe, "ok"
        self.tracked_inliers = 2000
        if in_flight is not None:
            self.in_flight = in_flight
        if step_ms is not None:
            self.step_ms = step_ms


class Run:
    def __init__(self, window):
        self.window, self.trace, self.setup_s = window, None, 10.0


def _window(new_program=True, keyframes=True, stamps=True, n=40):
    """n calls of 11 ms, each delivering one frame: the host table grows by
    3 ms of waiting, 2 ms of dispatch and 1.5 ms of retirement per call, of
    which 0.5 ms is keyframes (the rest its self time); frames carry 3-6 in flight and 9 ms of stage
    times (8 of them track)."""
    opened = dict.fromkeys(OLD_KEYS, 1.0)
    closed = dict(opened)
    if new_program:
        grow = {"retire_wait": 0.003, "dispatch": 0.002, "retire": 0.0015,
                "keyframe": 0.0005 if keyframes else 0.0, "relocalize": 0.0,
                "retire.self": 0.001 if keyframes else 0.0015}
        opened.update(dict.fromkeys(grow, 2.0))
        closed.update({k: 2.0 + n * v for k, v in grow.items()})
    w = Window(t_open=0.0, t_close=n * 0.011, counters_open=opened, counters_close=closed)
    for k in range(n):
        w.handed[k] = 0.011 * k
        w.spans.append(0.011)
        s = State(k, is_keyframe=keyframes and k % 10 == 0,
                  in_flight=(6 - k % 4) if new_program else None,
                  step_ms=({"ingest": 0.1, "track": 8.0, "pose": 0.2, "select": 0.7}
                           if new_program and stamps else None))
        w.delivered[k] = 0.011 * (k + 5)
        w.states[k] = s
        w.retired.append(s)
    return w


def read(name, window):
    return spec.metric_reader(name)(Run(window))


def test_the_readers_on_a_steady_window():
    w = _window()
    assert read("loop.wait_ms_per_frame", w) == pytest.approx(3.0)
    assert read("dispatch.host_ms_per_frame", w) == pytest.approx(2.0)
    assert read("retire.host_ms_per_frame", w) == pytest.approx(1.0)
    assert read("retire.frames_in_flight", w) == pytest.approx(4.5)
    assert read("step.device_ms_per_frame", w) == pytest.approx(9.0)
    assert read("step.track_ms_per_frame", w) == pytest.approx(8.0)


def test_a_window_with_no_keyframes_reads_without_them():
    w = _window(keyframes=False)
    assert read("retire.host_ms_per_frame", w) == pytest.approx(1.5)
    for name in NAMES:
        assert read(name, w) is not None


def test_frames_without_stage_times_read_nothing_for_the_step():
    w = _window(stamps=False)
    assert read("step.device_ms_per_frame", w) is None
    assert read("step.track_ms_per_frame", w) is None
    assert read("retire.frames_in_flight", w) == pytest.approx(4.5)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_reads_nothing(name):
    assert read(name, _window(new_program=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_an_empty_window_reads_nothing(name):
    table = {"retire_wait": 0.0, "dispatch": 0.0, "retire": 0.0, "retire.self": 0.0}
    w = Window(counters_open=dict(table), counters_close=dict(table))
    assert read(name, w) is None


def test_each_new_metric_is_declared_for_both_cells():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NAMES:
        assert entries[name]["workloads"] == cells
        assert (spec.BENCH_DIR / "metrics" / f"{name}.py").is_file()
