"""The port's tracer (`utils.profiling.Tracer`) in the pipelined live loop,
and the stage stamps of its megastep (`ops.stamp`, `csrc/stamp.cu`).

On the CPU, at test size (160 x 120, 512 points, the megastep eager): the
spans nest as `SlamSystem.process_frame_async` documents them; under a
`torch.profiler` run they are `uws_*` ranges, and with no profiler running
no `record_function` is entered; the five host-time parts the table held
before the tracer keep their meaning (a clock that moves only inside the
timed calls gives each part exactly what those calls took); every retired
frame's `in_flight` follows from the pipeline's structure (a batch of 4
staged one call ahead); a forced loss counts its lost, relocalized and
synchronous frames as the states say; a steady run captures one graph
(a stand-in for `CapturedStep`, since the CPU has no graphs).

Marked `cuda` (skipped without a card): over 100 replays each frame's stage
times are non-negative and together within 2% of CUDA events around the
graph's replay, and in a profiled stretch every `uws_*` record on the
device is a user annotation, which `profiling.device_work` leaves out.
This file imports neither JAX nor the JAX package, so on a card it runs
alone: `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_trace.py`.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import system as system_module  # noqa: E402
from uwslam_tpu_torch.camera import Calibration, PinholeCamera  # noqa: E402
from uwslam_tpu_torch.config import BAConfig, SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.map.tracks import TrackGraph  # noqa: E402
from uwslam_tpu_torch.system import PLAIN_STAGES, SlamSystem  # noqa: E402
from uwslam_tpu_torch.utils import profiling  # noqa: E402
from uwslam_tpu_torch.utils.synthetic import render_plane_view  # noqa: E402

CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, point_block=4,
               mono_depth=2.0)
# Each span and the spans it may open inside (None: outermost).
PARENTS = {
    "frame": {None}, "flush": {None, "frame"}, "dispatch": {"frame"},
    "replay": {"dispatch"}, "capture": {"dispatch"}, "retire_wait": {"frame", "flush"},
    "retire": {"frame", "flush"}, "keyframe": {"retire"}, "make_keyframe": {"keyframe"},
    "relocalize": {"retire"}, "stage_diags": {"frame"},
}


def frames(n, bad=None):
    """Views of the textured plane along a sinusoidal motion with reversals
    (several keyframes); with `bad`, along a slow straight motion with frame
    `bad` replaced by noise (found lost, relocalized)."""
    i = torch.arange(n, dtype=torch.float32)
    s, c = torch.sin(0.35 * i), torch.cos(0.22 * i)
    xi = torch.stack([0.28 * s, 0.10 * c, 0.05 * s, 0.010 * c, -0.012 * s, 0.015 * c], -1)
    if bad is not None:
        z = torch.zeros_like(i)
        xi = torch.stack([0.02 * i, 0.008 * i, z, z, z, 0.002 * i], -1)
    out = render_plane_view(CAM, se3.exp(xi), 2.0)
    if bad is not None:
        out[bad] = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (120, 160))
                                    .astype(np.float32))
    return out


def make_system(device="cpu", **change):
    tracker = dict(TRACKER, **change.pop("tracker", {}))
    return SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**tracker), **change), device=device)


def run(system, seq):
    """The pipelined loop over `seq`, then flush -> the states each call
    delivered (the flush's last)."""
    per_call = []
    for k, f in enumerate(seq):
        before = len(system.trajectory)
        system.process_frame_async(f, timestamp=float(k))
        per_call.append(system.trajectory[before:])
    before = len(system.trajectory)
    system.flush()
    per_call.append(system.trajectory[before:])
    return per_call


@pytest.fixture(scope="module")
def steady():
    system = make_system()
    return system, run(system, frames(22))


def test_spans_nest_as_documented(steady):
    system, _ = steady
    tr = system.tracer
    seen = {k for k, n in tr.calls.items() if n}
    assert {"frame", "flush", "dispatch", "replay", "retire_wait", "retire", "keyframe",
            "make_keyframe", "stage_diags"} <= seen
    for name in seen & set(PARENTS):
        assert tr.parents[name] <= PARENTS[name], name
    # the synchronous first frame's stages run inside the call
    assert tr.parents["sync_ingest"] == {"frame"}
    # inclusive: a parent holds its children, and its self time is the rest
    host = system.retire_host_s
    for name, children in {"frame": ("dispatch", "stage_diags", "sync_ingest"),
                           "keyframe": ("make_keyframe",)}.items():
        assert 0 <= host[name + ".self"] <= host[name] - sum(host[c] for c in children)
    for name, children in {"retire": ("keyframe", "relocalize"),
                           "dispatch": ("replay", "capture")}.items():
        assert 0 <= host[name + ".self"] == pytest.approx(
            host[name] - sum(host[c] for c in children))
    assert host["keyframe"] > 0
    assert host["replay.self"] == host["replay"] and host["stage_diags.self"] == host["stage_diags"]
    assert tr.top_s >= host["frame"]
    assert tr.calls["frame"] == 22 and tr.calls["dispatch"] == 21


def test_in_flight_follows_the_pipeline_frame_by_frame(steady):
    system, per_call = steady
    assert per_call[0][0].in_flight is None            # the first frame: synchronous
    newest = 0
    for k, states in enumerate(per_call[1:], start=1):
        newest = min(k, 21)                            # the flush dispatches nothing
        for s in states:
            assert s.in_flight == newest - s.frame_id + 1
    pipelined = [s.in_flight for s in system.trajectory[1:]]
    # retired in batches of 4 one call after staging: 6, 5, 4, 3 in turn
    assert pipelined[:8] == [6, 5, 4, 3] * 2
    assert all(s.step_ms is None for s in system.trajectory)   # no stamps on a CPU


def test_counters_match_the_states(steady):
    system, _ = steady
    c, traj = system.tracer.counts, system.trajectory
    assert (c["dispatched"], c["retired"], c["sync"]) == (21, 21, 1)
    assert c["keyframes"] == sum(s.is_keyframe for s in traj) >= 3
    assert c["lost"] == c["relocalized"] == c["captures"] == 0
    line = system.tracer.line()
    assert line.startswith("trace: 21 dispatched, 21 retired, 1 synchronous, 0 lost")
    assert "host ms per frame: waiting" in line and "step ms" not in line


def test_a_profiler_run_shows_the_spans_as_uws_ranges():
    system = make_system()
    seq = frames(7)
    for f in seq[:5]:
        system.process_frame_async(f)      # frames 1-4 in flight
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for f in seq[5:]:
            system.process_frame_async(f)  # frame 5's call stages 1-4, frame 6's retires them
        system.flush()
    names = {e.name for e in prof.events()}
    want = {"uws_frame", "uws_dispatch", "uws_replay", "uws_retire_wait", "uws_retire",
            "uws_stage_diags", "uws_flush"}
    assert want <= names


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    system = make_system()
    run(system, frames(12))
    assert system.tracer.calls["frame"] == 12 and entered == []
    # the same spans do enter it while a profiler runs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        system.process_frame_async(frames(13)[12])
    assert "uws_frame" in entered and "uws_dispatch" in entered


def test_the_old_table_keys_time_what_they_timed(monkeypatch):
    """A clock that stands still but inside the calls each old key times,
    each call moving it by its own power of two: each key reads exactly its
    calls' share (nothing around them, none of them missed)."""
    clock = types.SimpleNamespace(now=0.0)
    fake = types.SimpleNamespace(perf_counter=lambda: clock.now)
    monkeypatch.setattr(system_module, "time", fake)
    monkeypatch.setattr(profiling, "time", fake)
    calls = {}

    def ticking(cls, name, step):
        orig = getattr(cls, name)

        def timed(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            clock.now += step
            return orig(*args, **kw)

        monkeypatch.setattr(cls, name, timed)

    ticking(SlamSystem, "_make_keyframe", 1.0)
    ticking(SlamSystem, "_keyframe_match_table", 2.0 ** -4)
    ticking(TrackGraph, "add_keyframe_matches", 2.0 ** -8)
    ticking(TrackGraph, "build_problem", 2.0 ** -12)
    system = make_system(use_ba=True, ba=BAConfig(max_iterations=4))
    run(system, frames(18))
    host = system.retire_host_s
    made_in_retirement = sum(s.is_keyframe and s.in_flight is not None for s in system.trajectory)
    assert made_in_retirement >= 2 and calls["build_problem"] >= 1
    assert host["make_keyframe"] == 1.0 * made_in_retirement
    assert host["match_dispatch"] == 2.0 ** -4 * calls["_keyframe_match_table"]
    assert host["add_keyframe_matches"] == 2.0 ** -8 * calls["add_keyframe_matches"]
    assert host["build_problem"] == 2.0 ** -12 * calls["build_problem"]
    assert host["match_wait"] == 0.0                  # no event to wait for on a CPU
    # the spans around them hold them
    assert host["keyframe"] >= host["make_keyframe"] + host["match_dispatch"]
    # every call the clock moved in ran inside an outermost span
    assert system.tracer.top_s == clock.now


def test_a_forced_loss_counts_as_the_states_say():
    system = make_system(tracker={"point_block": 8})
    per_call = run(system, frames(20, bad=8))
    traj = system.trajectory
    statuses = [s.status for s in traj]
    assert "relocalized" in statuses and "lost" in statuses
    c = system.tracer.counts
    assert c["lost"] == statuses.count("lost")
    assert c["relocalized"] == statuses.count("relocalized")
    assert c["keyframes"] == sum(s.is_keyframe for s in traj)
    # the first frame and the re-entry after the drain took the synchronous path
    sync = [s.frame_id for s in traj if s.in_flight is None]
    assert c["sync"] == len(sync) >= 2 and sync[0] == 0
    assert c["dispatched"] == c["retired"] == len(traj) - len(sync)
    assert system.tracer.parents["relocalize"] == {"retire"}
    assert system.tracer.parents["flush"] == {None, "frame"}
    assert sum(len(s) for s in per_call) == 20


class EagerStep:
    """Stands in for `CapturedStep` on the CPU: runs the step as it is."""

    def __init__(self, fn, example_inputs):
        self.fn, self.replays = fn, 0

    def __call__(self, *inputs):
        self.replays += 1
        return self.fn(*inputs)


def test_a_steady_run_captures_once(monkeypatch):
    """The card's path of `_run_step` on the CPU: its device check sees a
    card, everything after it the CPU, and `EagerStep` stands in for the
    graph."""
    monkeypatch.setattr(system_module, "CapturedStep", EagerStep)
    run_step, graph = SlamSystem._run_step, SlamSystem._graph

    def seen_as_card(self, *args):
        self.device = types.SimpleNamespace(type="cuda")
        return run_step(self, *args)

    def on_the_cpu(self, *args):
        self.device = torch.device("cpu")
        return graph(self, *args)

    monkeypatch.setattr(SlamSystem, "_run_step", seen_as_card)
    monkeypatch.setattr(SlamSystem, "_graph", on_the_cpu)
    system = make_system()
    run(system, frames(14))
    assert system.tracer.counts["captures"] == 1 and system.tracer.calls["capture"] == 1
    assert system.tracer.parents["capture"] == {"dispatch"}
    assert system.graph_replays == 13 and "captures (" in system.tracer.line()


# ---- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are a CUDA kernel")
    return torch.device("cuda", 0)


class TimedGraph:
    """A captured graph whose replays are bracketed by CUDA events."""

    def __init__(self, graph):
        self.graph, self.events = graph, []

    def replay(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))


@pytest.mark.cuda
def test_stage_stamps_match_cuda_events_on_card(cuda_device):
    seq = frames(103).to(cuda_device)
    system = make_system(cuda_device)
    system.process_frame_async(seq[0], timestamp=0.0)
    system.process_frame_async(seq[1], timestamp=1.0)       # captures the graph
    (key,) = [k for k in system._steps if k[0] == "plain"]
    timed = TimedGraph(system._steps[key].graph)
    system._steps[key].graph = timed
    for k in range(2, 103):
        system.process_frame_async(seq[k], timestamp=float(k))
    system.flush()
    torch.cuda.synchronize(cuda_device)
    assert system.tracer.counts["captures"] == 1 and len(timed.events) == 101
    by_id = {s.frame_id: s for s in system.trajectory}
    stamped = event_ms = 0.0
    for k, (start, end) in zip(range(2, 103), timed.events):
        ms = by_id[k].step_ms
        assert list(ms) == list(PLAIN_STAGES) and min(ms.values()) >= 0.0   # monotone
        total, elapsed = sum(ms.values()), start.elapsed_time(end)
        assert total <= elapsed + 2e-3          # the stamps lie inside the replay
        stamped, event_ms = stamped + total, event_ms + elapsed
    assert stamped == pytest.approx(event_ms, rel=0.02)
    assert system.tracer.counts["step_frames"] == 102
    assert max(by_id[k].step_ms["track"] for k in range(2, 103)) > 0


@pytest.mark.cuda
def test_no_uws_range_is_device_work_on_card(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seq = frames(24).to(cuda_device)
    system = make_system(cuda_device)
    for k in range(12):
        system.process_frame_async(seq[k], timestamp=float(k))
    torch.cuda.synchronize(cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(12, 24):
            system.process_frame_async(seq[k], timestamp=float(k))
        system.flush()
        torch.cuda.synchronize(cuda_device)
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    # a span's image on the device is a user annotation, never a kernel
    ranges = [e for e in on_card if e.name().startswith(profiling.PREFIX)]
    assert all(e.is_user_annotation() for e in ranges), {e.name() for e in ranges}
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    assert {"uws_frame", "uws_dispatch", "uws_replay", "uws_retire_wait"} <= host
    assert any("stamp_kernel" in e.name() for e in on_card)
    # and the sums of device work leave every such image out
    work = profiling.device_work(prof.key_averages())
    assert work and not [a.key for a in work if a.key.startswith(profiling.PREFIX)]
    assert not [a.key for a in work if a.is_user_annotation]
