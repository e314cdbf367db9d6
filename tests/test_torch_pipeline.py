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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.camera.calibration import Calibration as JaxCalibration  # noqa: E402
from uwslam_tpu.config import SlamConfig as JaxConfig  # noqa: E402
from uwslam_tpu.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch.camera import Calibration  # noqa: E402
from uwslam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.io import DeviceFramePrefetcher, Sequence, ate_rmse  # noqa: E402
from uwslam_tpu_torch.io.dataset import as_uint8_if_exact  # noqa: E402
from uwslam_tpu_torch.ops.graph import CapturedStep, tree_clone, tree_leaves  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402

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
