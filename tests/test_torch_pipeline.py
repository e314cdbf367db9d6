"""The port's pipelined live loop (`SlamSystem.process_frame_async` +
`flush`) on the CPU, where the megastep runs eagerly: the four cases of
tests/test_pipeline.py on the port, the port's pipelined loop against the
JAX package's (which retires with the same lag, so keyframes land on the
same frames), a garbage frame found lost at retirement, and
`io.DeviceFramePrefetcher`.

Tolerances: statuses, keyframe flags and reference keyframes equal; poses
atol 1e-4 (f32 sums in another order); a pose relocalized from the port's
own RANSAC samples within 0.1 of ground truth, as tests/test_reloc.py asks.
The `cuda` tests that hold the CUDA graph of the megastep to the eager
megastep bit for bit are in tests/test_torch_kernels.py, which needs no JAX.

The bootstrap megastep (config 2) and window BA in the pipelined loop
(config 4) follow: pipelined against synchronous on the port (1e-4), the
bootstrap loop against the JAX package's pipelined loop from the same RANSAC
samples, the JAX package on the two-view forms the port runs (see
tests/test_torch_ransac.py; 5e-3 over 16 frames, after 0.77 m of travel;
2.1e-3 on this host), and a window
solve that is dispatched, left alone while its result is not there, and
applied through the pending correction when it is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.camera.calibration import Calibration as JaxCalibration  # noqa: E402
from uwslam_tpu.config import SlamConfig as JaxConfig  # noqa: E402
from uwslam_tpu.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view, render_scene_view  # noqa: E402
from uwslam_tpu_torch.camera import Calibration  # noqa: E402
from uwslam_tpu_torch.config import BAConfig, SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.io import DeviceFramePrefetcher, Sequence, ate_rmse  # noqa: E402
from uwslam_tpu_torch.io.dataset import as_uint8_if_exact  # noqa: E402
from uwslam_tpu_torch.ops.graph import CapturedStep, tree_clone, tree_leaves  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from test_torch_ransac import jax_accelerator_branch  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, point_block=4,
               mono_depth=2.0)


def _render(xis):
    frames, gts = [], []
    for xi in xis:
        T_cw = jse3.exp(jnp.asarray(xi, jnp.float32))
        frames.append(np.asarray(render_plane_view(JCAM, T_cw, 2.0)))
        gts.append(np.asarray(jse3.inverse(T_cw)))
    return frames, np.stack(gts)


def easy_sequence(n=12):
    return _render([[0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i]
                    for i in range(n)])


def fast_sequence(n=40):
    """Sinusoidal motion with reversals, about three times the easy
    sequence's per-frame motion: several keyframes, decided 5-9 frames late."""
    xis = []
    for i in range(n):
        s, c = np.sin(0.35 * i), np.cos(0.22 * i)
        xis.append([0.28 * s, 0.10 * c, 0.05 * s, 0.010 * c, -0.012 * s, 0.015 * c])
    return _render(xis)


def port_system(**tracker):
    return SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**dict(TRACKER, **tracker))),
                      device="cpu")


def jax_system(**tracker):
    return JaxSystem(JaxCalibration(raw=JCAM, out_width=160, out_height=120),
                     JaxConfig(tracker=JaxTrackerConfig(**dict(TRACKER, **tracker))))


def run(system, frames, pipelined: bool):
    step = system.process_frame_async if pipelined else system.process_frame
    for i, f in enumerate(frames):
        step(f, timestamp=float(i))
    if pipelined:
        system.flush()
    return system


@pytest.fixture(scope="module")
def easy_runs():
    frames, gt = easy_sequence(12)
    return (frames, gt, run(port_system(), frames, False), run(port_system(), frames, True),
            run(jax_system(), frames, True))


@pytest.fixture(scope="module")
def fast_runs():
    frames, gt = fast_sequence(40)
    return (frames, gt, run(port_system(), frames, False), run(port_system(), frames, True),
            run(jax_system(), frames, True))


def _ate(system, gt):
    _, poses = system.export_trajectory()
    return ate_rmse(poses[:, :3, 3], gt[:, :3, 3])


def test_matches_sync_trajectory(easy_runs):
    frames, gt, sync, pipe, _ = easy_runs
    assert len(pipe.trajectory) == len(frames)
    assert [s.frame_id for s in pipe.trajectory] == list(range(len(frames)))
    rmse_sync, rmse_pipe = _ate(sync, gt), _ate(pipe, gt)
    assert rmse_pipe < 0.01, f"pipelined ATE {rmse_pipe}"
    assert abs(rmse_pipe - rmse_sync) < 5e-3, (rmse_sync, rmse_pipe)


def test_matches_sync_on_long_fast_motion(fast_runs):
    frames, gt, sync, pipe, _ = fast_runs
    assert [s.frame_id for s in pipe.trajectory] == list(range(len(frames)))
    rmse_sync, rmse_pipe = _ate(sync, gt), _ate(pipe, gt)
    assert rmse_pipe < 0.02, f"pipelined ATE {rmse_pipe}"
    assert rmse_pipe < max(0.015, 1.5 * rmse_sync), (rmse_sync, rmse_pipe)
    assert sum(s.is_keyframe for s in pipe.trajectory) >= 3


def test_flush_mid_sequence_then_sync():
    frames, _ = easy_sequence(10)
    system = port_system()
    for i, f in enumerate(frames[:6]):
        system.process_frame_async(f, timestamp=float(i))
    system.flush()
    assert [s.frame_id for s in system.trajectory] == list(range(6))
    assert system.flush() is None                      # nothing left in flight
    for i, f in enumerate(frames[6:], start=6):
        system.process_frame(f, timestamp=float(i))
    assert [s.frame_id for s in system.trajectory] == list(range(10))
    assert all(np.all(np.isfinite(s.T_wc)) for s in system.trajectory)


def test_async_returns_lag_and_flush_completes():
    frames, _ = easy_sequence(8)
    system = port_system()
    returned = []
    for i, f in enumerate(frames):
        st = system.process_frame_async(f, timestamp=float(i))
        returned.append(None if st is None else st.frame_id)
    # Frame 0 is synchronous; a batch of 4 is staged at the 6th call and
    # retired at the 7th: the lag of the JAX package's loop.
    assert returned == [0, None, None, None, None, None, 4, None]
    system.flush()
    assert len(system.trajectory) == len(frames)


def _assert_same_run(port, ref):
    assert len(port.trajectory) == len(ref.trajectory)
    for a, b in zip(port.trajectory, ref.trajectory):
        assert (a.frame_id, a.status, a.is_keyframe, a.ref_kf_id) == (
            b.frame_id, b.status, b.is_keyframe, b.ref_kf_id)
        assert a.tracked_inliers == b.tracked_inliers
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)
        np.testing.assert_allclose(a.T_kf_frame, np.asarray(b.T_kf_frame), atol=1e-4)
    np.testing.assert_allclose(port.export_trajectory()[1], ref.export_trajectory()[1],
                               atol=1e-4)


def test_pipelined_loop_matches_jax_pipelined_loop(easy_runs):
    _, _, _, pipe, jpipe = easy_runs
    _assert_same_run(pipe, jpipe)


def test_pipelined_loop_matches_jax_on_long_fast_motion(fast_runs):
    _, _, _, pipe, jpipe = fast_runs
    _assert_same_run(pipe, jpipe)


def test_eager_megastep_equals_the_synchronous_stages():
    """On the easy sequence no keyframe lands inside the first frames, so
    the pipelined poses are the synchronous ones bit for bit: the megastep
    is the same code in one function."""
    frames, _ = easy_sequence(5)
    sync, pipe = run(port_system(), frames, False), run(port_system(), frames, True)
    assert pipe.graph_replays == 0                     # no graph on the CPU
    for a, b in zip(sync.trajectory, pipe.trajectory):
        np.testing.assert_array_equal(a.T_wc, b.T_wc)
        assert a.tracked_inliers == b.tracked_inliers


def garbage_sequence(n=20, bad=8):
    frames, gt = _render([[0.02 * i, 0.008 * i, 0.0, 0.0, 0.0, 0.002 * i] for i in range(n)])
    frames[bad] = np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(np.float32)
    return frames, gt


def test_garbage_frame_drains_and_relocalizes_like_jax():
    frames, gt = garbage_sequence()
    port, ref = port_system(point_block=8), jax_system(point_block=8)
    run(port, frames, True)
    run(ref, frames, True)
    got = [s.status for s in port.trajectory]
    assert got == [s.status for s in ref.trajectory]
    assert [s.is_keyframe for s in port.trajectory] == [s.is_keyframe for s in ref.trajectory]
    assert [s.frame_id for s in port.trajectory] == list(range(len(frames)))
    # The failure is found at retirement and relocalized there; the frames
    # already in flight coast as lost; the loop re-enters and ends tracking.
    at = got.index("relocalized")
    assert at in (8, 9) and got[at + 1] == "lost" and got[-3:] == ["ok"] * 3
    assert set(got[:8]) == {"ok"}
    assert not port._pipe_broken
    # The drained frames coast on the recovered pose (their motion is not
    # tracked), so the run ends that far from ground truth, in both packages;
    # the relocalized pose itself is within 0.1 (tests/test_reloc.py's bound).
    assert np.linalg.norm(port.trajectory[at].T_wc[:3, 3] - gt[at][:3, 3]) < 0.1
    np.testing.assert_allclose(port.trajectory[-1].T_wc, np.asarray(ref.trajectory[-1].T_wc),
                               atol=2e-2)
    for a, b in zip(port.trajectory[:8], ref.trajectory[:8]):
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)


def test_live_correction_reaches_the_chain_and_frames_in_flight():
    """A left-multiplied correction registered while frames are in flight
    moves their retired poses and the chain head alike (the mechanism that
    bundle adjustment and loop closure will use)."""
    frames, _ = easy_sequence(8)
    plain, moved = run(port_system(), frames, True), port_system()
    C = np.asarray(jse3.exp(jnp.asarray([0.1, -0.05, 0.02, 0.0, 0.01, 0.0], jnp.float32)))
    for i, f in enumerate(frames):
        moved.process_frame_async(f, timestamp=float(i))
        if i == 3:
            moved._pipelined = True
            moved._apply_live_correction(C)
            moved._pipelined = False
    moved.flush()
    for a, b in zip(plain.trajectory[1:], moved.trajectory[1:]):
        np.testing.assert_allclose(C @ a.T_wc, b.T_wc, atol=1e-5)
    np.testing.assert_allclose(moved._T_wc.numpy(), C @ plain._T_wc.numpy(), atol=1e-5)
    # On the synchronous path the correction applies at once.
    sync = run(port_system(), frames[:3], False)
    before = sync._T_wc.numpy().copy()
    sync._apply_live_correction(C)
    np.testing.assert_allclose(sync._T_wc.numpy(), C @ before, atol=1e-6)


def test_host_corrections_stay_rigid():
    """Corrections composed on the host stay rigid motions. Each is a refined
    pose times the transposed rotation of an earlier pose, and f32 products
    drift off SO(3); fed back through the keyframe poses, unnormalized drift
    compounds until a pose is singular (a 640-frame loop-closure run did
    so). Here every correction is 0.2% off SO(3) on purpose."""
    rng = np.random.default_rng(0)
    pipe, sync = port_system(), port_system()
    pipe._pipelined = True
    for _ in range(300):
        C = np.array(jse3.exp(jnp.asarray(0.01 * rng.standard_normal(6), jnp.float32)))
        C[:3, :3] *= np.float32(1.002)
        pipe._apply_live_correction(C)
        sync._apply_live_correction(C)
    for M in (pipe._corr_pending, pipe._corr_accum, sync._corr_accum, sync._T_wc.numpy()):
        R = M[:3, :3]
        assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5
        np.testing.assert_array_equal(M[3], [0, 0, 0, 1])


class _ListSequence(Sequence):
    """A Sequence over arrays in memory."""

    def __init__(self, items):
        super().__init__(image_paths=[str(i) for i in range(len(items))])
        self._items = items

    def load(self, i):
        return self._items[i]


def test_device_prefetcher_keeps_order_and_passes_depth_frames_through():
    rng = np.random.default_rng(0)
    img = lambda: rng.integers(0, 256, (6, 8)).astype(np.float32)   # noqa: E731
    depth = np.full((6, 8), 5000.0, np.float32)
    items = [(img(), None), (img(), None), (img(), depth), (img(), None), (img(), depth),
             (img(), None)]
    pre = DeviceFramePrefetcher(_ListSequence(items), "cpu")
    got = list(pre)
    pre.close()
    assert [i for i, _ in got] == list(range(6))
    for (i, (frame, d)), (src, src_d) in zip(got, items):
        if src_d is None:
            assert isinstance(frame, torch.Tensor) and frame.dtype == torch.uint8 and d is None
            np.testing.assert_array_equal(frame.numpy(), src)
        else:                                  # un-uploaded, as decoded
            assert isinstance(frame, np.ndarray) and frame.dtype == np.float32
            assert d is src_d and frame is src


@pytest.mark.parametrize("change,dtype", [
    (None, np.uint8), ("negative", np.float32), ("fractional", np.float32),
    ("sixteen-bit", np.float32), ("already-uint8", np.uint8),
])
def test_uint8_rule_keeps_f32_unless_the_cast_is_exact(change, dtype):
    img = np.random.default_rng(1).integers(0, 256, (6, 8)).astype(np.float32)
    if change == "negative":
        img[2, 3] = -1.0
    elif change == "fractional":
        img[2, 3] = 17.5
    elif change == "sixteen-bit":
        img[2, 3] = 300.0
    elif change == "already-uint8":
        img = img.astype(np.uint8)
    out = as_uint8_if_exact(img)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.astype(np.float32), img.astype(np.float32))
    pre = DeviceFramePrefetcher(_ListSequence([(img, None)]), "cpu")
    (_, (frame, _)), = list(pre)
    pre.close()
    assert frame.numpy().dtype == dtype


def test_prefetched_uint8_frames_track_like_f32_frames():
    frames, _ = easy_sequence(6)
    quantized = [np.clip(np.rint(f), 0, 255).astype(np.float32) for f in frames]
    a = run(port_system(), quantized, True)
    b = port_system()
    pre = DeviceFramePrefetcher(_ListSequence([(f, None) for f in quantized]), "cpu")
    for i, (frame, depth) in pre:
        assert frame.dtype == torch.uint8
        b.process_frame_async(frame, depth, timestamp=float(i))
    pre.close()
    b.flush()
    for x, y in zip(a.trajectory, b.trajectory):
        np.testing.assert_array_equal(x.T_wc, y.T_wc)


def test_can_pipeline_follows_the_jax_rule():
    frames, _ = easy_sequence(3)
    system = port_system()
    assert not system._can_pipeline(None)              # no previous frame yet
    system.process_frame_async(frames[0])
    assert system._can_pipeline(None) and not system._can_pipeline(frames[0])
    system._pipe_broken = True
    assert not system._can_pipeline(None)
    profiled = SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                          SlamConfig(tracker=TrackerConfig(**TRACKER), profile=True),
                          device="cpu")
    run(profiled, frames, True)
    assert not profiled._can_pipeline(None) and len(profiled.trajectory) == 3
    assert "track" in profiled.timers.summary()


def test_captured_step_refuses_cpu_tensors_and_trees_keep_their_shape():
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(lambda x: x + 1, (torch.zeros(3),))
    system = run(port_system(), easy_sequence(2)[0], False)
    pyr, pts, _ = system._prev
    copy = tree_clone((pyr, pts, None))
    assert type(copy[0]) is type(pyr) and type(copy[1]) is type(pts) and copy[2] is None
    assert copy[1].gx0 is None
    assert len(tree_leaves((pyr, pts))) == 4 * pyr.levels + 4
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(tree_leaves(copy), tree_leaves((pyr, pts))))


# ------------------------------------------- config 2: the bootstrap megastep

def _scene_sequence(n=16):
    """The default multi-plane scene along a parallax-rich path. The first
    pair is three steps apart: the two-view bootstrap fixes the monocular
    scale from that pair, and at one step's baseline (0.04 m at 2.5 m) the
    essential matrix is determined to 1e-3 only, which the triangulated
    depths turn into 10% of scale, whatever package or branch computes it."""
    frames, gts = [], []
    for j in range(n):
        i = j + 2 if j else 0
        T = jse3.exp(jnp.asarray([0.04 * i, 0.015 * i, 0.01 * i, 0.003 * i, 0.01 * i, 0.004 * i],
                                 jnp.float32))
        frames.append(np.asarray(render_scene_view(JCAM, T)))
        gts.append(np.asarray(jse3.inverse(T)))
    return frames, np.stack(gts)


def _jax_uniforms(self, num_matches, seed):
    H = self.config.features.ransac_hypotheses
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (H, num_matches), minval=1e-9, maxval=1.0)))


BOOT = dict(TRACKER, mono_depth=2.5, depth_bootstrap=True, bootstrap_anchor_frames=4)


def boot_system(**kw):
    return SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**BOOT), use_features=True, **kw),
                      device="cpu")


@pytest.fixture(scope="module")
def boot_runs():
    frames, gt = _scene_sequence(16)
    mp = pytest.MonkeyPatch()
    mp.setattr(SlamSystem, "_ransac_uniforms", _jax_uniforms)
    try:
        sync = run(boot_system(), frames, False)
        pipe = boot_system()
        entered = []
        for i, f in enumerate(frames):
            entered.append(pipe._can_pipeline(None))
            pipe.process_frame_async(f, timestamp=float(i))
        pipe.flush()
        # The JAX package on the two-view forms the port runs on every device.
        with jax_accelerator_branch():
            ref = run(JaxSystem(JaxCalibration(raw=JCAM, out_width=160, out_height=120),
                                JaxConfig(tracker=JaxTrackerConfig(**BOOT), use_features=True)),
                      frames, True)
    finally:
        mp.undo()
    return frames, gt, sync, pipe, ref, entered


def test_boot_loop_enters_the_megastep_after_the_init_window(boot_runs):
    *_, entered = boot_runs
    # Frame 0 and the anchor's 4 frames are synchronous; then the megastep.
    assert entered[:5] == [False] * 5 and all(entered[6:])


def test_boot_pipelined_matches_sync_trajectory(boot_runs):
    _, gt, sync, pipe, _, _ = boot_runs
    assert len(pipe.trajectory) == len(sync.trajectory) == 16
    assert [s.frame_id for s in pipe.trajectory] == list(range(16))
    assert all(s.status == "ok" for s in pipe.trajectory)
    np.testing.assert_allclose(pipe.export_trajectory()[1], sync.export_trajectory()[1],
                               atol=1e-4)
    assert _ate(pipe, gt) < 0.05


def test_boot_pipelined_loop_matches_jax_pipelined_loop(boot_runs):
    _, gt, _, pipe, ref, _ = boot_runs
    for a, b in zip(pipe.trajectory, ref.trajectory):
        assert (a.frame_id, a.status, a.is_keyframe, a.ref_kf_id) == (
            b.frame_id, b.status, b.is_keyframe, b.ref_kf_id)
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=5e-3)
    assert abs(_ate(pipe, gt) - _ate(ref, gt)) <= 0.05 * _ate(ref, gt)


def test_boot_keyframes_carry_prior_depths(boot_runs):
    """A keyframe made at retirement reads the depths of ITS frame's prior
    and keypoint table (staged from the record), not the chain head's."""
    *_, pipe, _, _ = boot_runs
    kf = pipe.keyframes.latest
    z = kf.kp_p3d[:, 2][kf.kp_valid]
    assert kf.frame_id > 5 and float(z.std()) > 0.05          # not the constant 2.5
    assert pipe._prev_feats is not None and pipe._kp_depth is not None


def test_lost_frame_drops_the_prior():
    frames, _ = _scene_sequence(9)
    system = run(boot_system(), frames[:8], False)
    assert system._depth_prior is not None
    rng = np.random.default_rng(0)
    state = system.process_frame(rng.uniform(0, 255, frames[0].shape).astype(np.float32))
    assert state.status in ("lost", "relocalized")
    assert system._depth_prior is None and system._kp_depth is None
    assert not system._can_pipeline(None)


# ------------------------------------------------ config 4: window BA, async

def ba_system(asynchronous=True, **tracker):
    return SlamSystem(
        Calibration(raw=CAM, out_width=160, out_height=120),
        SlamConfig(tracker=TrackerConfig(**dict(TRACKER, **tracker)), use_ba=True,
                   ba=BAConfig(asynchronous=asynchronous, max_iterations=6)),
        device="cpu",
    )


@pytest.fixture(scope="module")
def ba_runs():
    frames, gt = fast_sequence(40)
    return (frames, gt, run(ba_system(), frames, True), run(ba_system(False), frames, True),
            run(ba_system(), frames, False))


def test_window_ba_runs_in_the_pipelined_loop(ba_runs, fast_runs):
    _, gt, pipe, _, _ = ba_runs
    plain = fast_runs[3]
    assert pipe.ba_stats["runs"] >= 2 and pipe.ba_stats["iters"] > 0
    assert pipe._ba_inflight is None                          # flush retired the last
    assert [s.is_keyframe for s in pipe.trajectory] == [s.is_keyframe for s in plain.trajectory]
    assert _ate(pipe, gt) < 1.1 * _ate(plain, gt) + 1e-4
    # The refined keyframe poses are what the export recomposes against.
    for kf in pipe.keyframes.keyframes:
        np.testing.assert_allclose(pipe._kf_poses[kf.frame_id], kf.T_wc.numpy(), atol=1e-6)


def test_window_ba_async_and_sync_retirement_agree(ba_runs):
    """On the CPU a dispatched solve is ready at once; retired inside the
    dispatch or one call later (the frames retired in between keep the
    uncorrected live pose, and the export recomposes both against the
    refined keyframes) the trajectory agrees to 2e-3."""
    _, _, pipe, pipe_sync_retire, sync_loop = ba_runs
    np.testing.assert_allclose(pipe.export_trajectory()[1],
                               pipe_sync_retire.export_trajectory()[1], atol=2e-3)
    assert sync_loop.ba_stats["runs"] >= 2
    np.testing.assert_allclose(pipe.export_trajectory()[1], sync_loop.export_trajectory()[1],
                               atol=2e-3)


class _Pending:
    """An event that has not passed: `query()` False until released."""

    def __init__(self):
        self.done = False
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_unfinished_solve_is_left_alone_then_applied_through_the_correction():
    frames, _ = fast_sequence(40)
    system = ba_system()
    pending = []
    dispatch = system._run_window_ba

    def dispatch_and_hold(*window):
        """The first solve's result 'has not arrived': give it an event."""
        dispatch(*window)
        if system._ba_inflight is not None and not pending:
            pending.append(_Pending())
            system._ba_inflight["event"] = pending[0]

    system._run_window_ba = dispatch_and_hold
    for i, f in enumerate(frames):
        system.process_frame_async(f, timestamp=float(i))
        if pending:
            runs = system.ba_stats["runs"]
            break
    assert pending, "no window solve was dispatched"
    before = system._corr_accum.copy()
    system.process_frame_async(frames[i + 1], timestamp=float(i + 1))
    # Not ready: nothing retired, nobody waited.
    assert system._ba_inflight is not None and pending[0].waited == 0
    assert system.ba_stats["runs"] == runs and np.array_equal(system._corr_accum, before)
    pending[0].done = True
    system.process_frame_async(frames[i + 2], timestamp=float(i + 2))
    assert system._ba_inflight is None and system.ba_stats["runs"] == runs + 1
    # The newest keyframe's refinement reaches the chain as a left correction.
    assert not np.array_equal(system._corr_accum, before)
    system.flush()
    assert np.allclose(system._corr_pending, np.eye(4))


def _graph(tracks):
    """A track graph as plain values: track id -> keyframe -> (u, v, slot)."""
    return ({tid: {kf: (*map(float, uv), int(slot)) for kf, (uv, slot) in t.obs.items()}
             for tid, t in tracks.tracks.items()}, tracks._tails, tracks._alias)


def test_deferred_keyframe_match_builds_the_eager_track_graph_and_problems():
    """The pipelined loop dispatches a new keyframe's match with the keyframe
    before it and applies it once the table has arrived (on the CPU: at the
    end of the call that retired the keyframe). Held against the retirement
    as it was, the match run and applied inside it: equal match tables,
    track graphs and window problems, and so the same trajectory."""
    frames, _ = fast_sequence(40)

    def spied(system):
        tables, problems = [], []
        add, solve = system._tracks.add_keyframe_matches, system._solve_window

        def add_spy(*args):
            tables.append(args)
            return add(*args)

        def solve_spy(*problem):
            problems.append([t.clone() for t in problem])
            return solve(*problem)

        system._tracks.add_keyframe_matches = add_spy
        system._solve_window = solve_spy
        return tables, problems

    deferred = ba_system()
    got = spied(deferred)
    eager = ba_system()
    want = spied(eager)

    def eager_hook(prev_kf, kf):
        if prev_kf is None or prev_kf.kp_desc is None or kf.kp_desc is None:
            return
        table = eager._keyframe_match_table(
            prev_kf.kp_uv, prev_kf.kp_desc, prev_kf.kp_valid, kf.kp_uv, kf.kp_desc, kf.kp_valid,
            eager._ransac_uniforms(prev_kf.kp_desc.shape[0], kf.frame_id)).numpy()
        eager._tracks.add_keyframe_matches(
            prev_kf.frame_id, kf.frame_id, table[:, 0].astype(np.int64),
            table[:, 1].astype(np.int64), table[:, 2:4], table[:, 4:6], table[:, 6] > 0.5)
        eager._kf_since_ba += 1
        if eager._kf_since_ba >= eager.config.ba.run_every_n_keyframes:
            eager._run_window_ba()
            eager._kf_since_ba = 0

    eager._window_ba_on_keyframe = eager_hook
    run(deferred, frames, True)
    run(eager, frames, True)
    assert len(got[0]) == len(want[0]) >= 3 and len(got[1]) == len(want[1]) >= 2
    for a, b in zip(got[0], want[0]):
        assert a[:2] == b[:2] and all(np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))
    for a, b in zip(got[1], want[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _graph(deferred._tracks) == _graph(eager._tracks)
    assert np.array_equal(deferred.export_trajectory()[1], eager.export_trajectory()[1])
    assert deferred._match_inflight is None and deferred.retire_host_s["match_dispatch"] > 0
