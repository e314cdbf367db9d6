"""Depth images in the port: `_depth_at` (kernel K3's plain version with
C = 1 on the CPU), `topk_gradient_points(depth_image=)`, `dense_points`,
`track_sequence_batched(depth_frames=)`, `track_sequence` and
`SlamSystem.process_frame(depth=)`, each against the JAX package's CPU
branch on the same numpy inputs (160 x 120, 512 points, 4 levels).

Depth images are TUM-encoded: uint16 at 5000 per metre, handed over as f32.
Tolerances: validity masks, selected pixels and statuses equal; depths
atol 1e-6 m (the 4-corner blend in another instruction order); poses atol
1e-4 (f32 sums in another order).
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
from uwslam_tpu.image import pyramid as jpyr  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.tracking import points as jpoints  # noqa: E402
from uwslam_tpu.tracking import sequence as jsequence  # noqa: E402
from uwslam_tpu.utils.synthetic import plane_depth, render_plane_view  # noqa: E402
from uwslam_tpu_torch.camera import Calibration  # noqa: E402
from uwslam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.image.pyramid import build_pyramid_batched  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax, depth_from_numpy  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from uwslam_tpu_torch.tracking import points, sequence  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
H, W = 120, 160
N_FRAMES = 6


def _pose(i):
    return jse3.exp(jnp.asarray(
        [0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i], jnp.float32))


def _tum_depth(i):
    """The plane's exact depth at pose i as a TUM depth image: uint16, 5000
    per metre, as the f32 array a decoder hands over."""
    metres = np.asarray(plane_depth(JCAM, _pose(i), 2.0))
    return np.round(metres * 5000.0).astype(np.uint16).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    frames = np.stack([np.asarray(render_plane_view(JCAM, _pose(i), 2.0))
                       for i in range(N_FRAMES)])
    depths = np.stack([_tum_depth(i) for i in range(N_FRAMES)])
    return frames, depths


def _awkward_depth():
    """A depth image with a step (the right part 1.6 times farther), a block
    of holes and a single hole."""
    d = _tum_depth(1)
    d[:, 100:] = np.round(d[:, 100:] * 1.6)
    d[30:40, 20:35] = 0.0
    d[80, 60] = 0.0
    return d


def _awkward_uv(seed=0):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([-2.0, -2.0], [W + 1.0, H + 1.0], size=(400, 2)).astype(np.float32)
    special = [
        [W - 1, 10.0], [W - 1, 57.25], [W - 1, H - 1], [33.5, H - 1], [0.0, 0.0],   # last column, row
        [W - 1.5, H - 1.5], [W - 1 + 1e-3, 5.0], [-1e-3, 5.0], [5.0, H - 1 + 1e-3],
        [99.5, 50.0], [99.0, 50.0], [100.0, 50.0], [98.75, 71.5],                 # the step
        [19.5, 35.0], [34.5, 39.5], [27.0, 33.0], [59.5, 79.5], [60.0, 80.0],     # the holes
    ]
    uv[: len(special)] = np.asarray(special, np.float32)
    return uv


def test_depth_at_matches_jax_on_holes_steps_and_edges():
    depth, uv = _awkward_depth(), _awkward_uv()
    want_d, want_ok = jpoints._depth_at(jnp.asarray(depth), jnp.asarray(uv), 2.0)
    got_d, got_ok = points._depth_at(depth_from_numpy(depth, "cpu"), torch.from_numpy(uv), 2.0)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)
    ok = got_ok.numpy()
    # Last column and row are read, the step and the holes are refused.
    assert ok[:6].all() and not ok[6:9].any()
    # (An integer u still reads column u + 1: 99 straddles the step at 100.)
    assert not ok[9] and not ok[10] and ok[11] and ok[12]
    assert not ok[13:18].any()
    assert 50 < ok.sum() < 380
    assert np.all(got_d.numpy()[~ok] == 2.0)


def test_depth_at_batched_equals_per_frame_and_mono_is_all_valid():
    depth = torch.from_numpy(np.stack([_awkward_depth(), _tum_depth(3)]))
    uv = torch.from_numpy(np.stack([_awkward_uv(1), _awkward_uv(2)]))
    d, ok = points._depth_at(depth, uv, 1.5)
    for b in range(2):
        d1, ok1 = points._depth_at(depth[b], uv[b], 1.5)
        assert torch.equal(d[b], d1) and torch.equal(ok[b], ok1)
    d, ok = points._depth_at(None, uv, 1.5)
    assert bool(ok.all()) and bool((d == 1.5).all()) and d.shape == (2, 400)


def test_depth_at_edge_ratio_is_honoured():
    depth, uv = _awkward_depth(), _awkward_uv()
    for ratio in (1.0, 2.0):
        _, want = jpoints._depth_at(jnp.asarray(depth), jnp.asarray(uv), 2.0, ratio)
        _, got = points._depth_at(torch.from_numpy(depth), torch.from_numpy(uv), 2.0, ratio)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[9]          # a 1.6x step passes a ratio of 2


def _jax_pyramid(frame):
    return jpyr.build_pyramid(jnp.asarray(frame), levels=4)


@pytest.mark.parametrize("awkward", [False, True], ids=["plane", "holes-and-step"])
def test_topk_points_with_depth_match_jax(scene, awkward):
    frames, depths = scene
    depth = _awkward_depth() if awkward else depths[1]
    jp = _jax_pyramid(frames[1])
    want = jpoints.topk_gradient_points(
        jp.images[0], jp.grad_mag[0], JCAM, depth_image=jnp.asarray(depth),
        num_points=512, mono_z=2.0, block=4, grad_x=jp.grad_x[0], grad_y=jp.grad_y[0])
    pyr = build_pyramid_batched(torch.from_numpy(frames[1:2]), levels=4)
    got = points.topk_gradient_points(
        pyr.images[0], pyr.grad_mag[0], CAM, depth_image=torch.from_numpy(depth)[None],
        num_points=512, mono_z=2.0, block=4, grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0])
    np.testing.assert_array_equal(got.uv[0].numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.p3d[0].numpy(), np.asarray(want.p3d), atol=2e-6)
    if awkward:
        assert 0 < int(got.valid.sum()) < 512
    else:
        assert bool(got.valid.all())
        np.testing.assert_allclose(got.p3d[0, :, 2].numpy(), 2.0, atol=0.05)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("with_depth", [False, True], ids=["mono", "depth"])
def test_dense_points_match_jax(scene, stride, with_depth):
    frames, _ = scene
    depth = _awkward_depth() if with_depth else None
    want = jpoints.dense_points(
        jnp.asarray(frames[2]), JCAM,
        depth_image=None if depth is None else jnp.asarray(depth), mono_z=2.0, stride=stride)
    got = points.dense_points(
        torch.from_numpy(frames[2:3]), CAM,
        depth_image=None if depth is None else torch.from_numpy(depth)[None],
        mono_z=2.0, stride=stride)
    assert got.uv.shape == (1, (H // stride) * (W // stride), 2) and got.gx0 is None
    np.testing.assert_array_equal(got.uv[0].numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.intensity[0].numpy(), np.asarray(want.intensity))
    np.testing.assert_allclose(got.p3d[0].numpy(), np.asarray(want.p3d), atol=2e-6)


SEQ = dict(levels=4, track_levels=(2, 1, 0), num_points=512, max_iters=8, block=4)


@pytest.mark.parametrize("mode", ["fc", "ic"])
def test_track_sequence_batched_with_depth_frames_matches_jax(scene, mode):
    frames, depths = scene
    want = jsequence.track_sequence_batched(
        jnp.asarray(frames), JCAM, depth_frames=jnp.asarray(depths), mono_z=2.0,
        mode=mode, **SEQ)
    got = sequence.track_sequence_batched(
        torch.from_numpy(frames), CAM, depth_frames=depth_from_numpy(depths, "cpu"),
        mono_z=2.0, mode=mode, **SEQ)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-3, atol=1e-5)
    for i in range(N_FRAMES - 1):       # and the poses are the rendered motion
        rel = np.asarray(_pose(i + 1) @ jse3.inverse(_pose(i)))
        np.testing.assert_allclose(got[0][i].numpy(), rel, atol=5e-3)


@pytest.mark.parametrize("mode,affine,with_depth", [
    ("fc", False, False), ("ic", False, True), ("fc", True, True),
], ids=["fc-mono", "ic-depth", "fc-affine-depth"])
def test_track_sequence_matches_jax(scene, mode, affine, with_depth):
    frames, depths = scene
    want = jsequence.track_sequence(
        jnp.asarray(frames), JCAM,
        depth_frames=jnp.asarray(depths) if with_depth else None, mono_z=2.0,
        mode=mode, affine=affine, **SEQ)
    got = sequence.track_sequence(
        torch.from_numpy(frames), CAM,
        depth_frames=torch.from_numpy(depths) if with_depth else None, mono_z=2.0,
        mode=mode, affine=affine, **SEQ)
    assert got[0].shape == (N_FRAMES - 1, 4, 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-3, atol=1e-5)


def test_sequence_tracker_chooses_the_sequential_scan(scene):
    frames, depths = scene
    tracker = sequence.SequenceTracker(CAM, levels=4, track_levels=(2, 1, 0),
                                       num_points=512, max_iters=8, mode="fc")
    fr, dp = torch.from_numpy(frames[:4]), torch.from_numpy(depths[:4])
    kw = dict(levels=4, track_levels=(2, 1, 0), num_points=512, max_iters=8, mode="fc",
              mono_z=2.0, depth_frames=dp)
    for sequential, fn in ((True, sequence.track_sequence),
                           (False, sequence.track_sequence_batched)):
        got = tracker(fr, mono_z=2.0, depth_frames=dp, sequential=sequential)
        want = fn(fr, CAM, **kw)
        assert torch.equal(got[0], want[0])
    # The scan starts each pair from the previous motion: other iterates.
    assert not torch.equal(tracker(fr, mono_z=2.0, sequential=True)[0][1:],
                           tracker(fr, mono_z=2.0)[0][1:])


TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, mono_depth=1.0,
               point_block=4)


def _rgbd_systems(**tracker):
    cfg = dict(TRACKER, **tracker)
    return (
        SlamSystem(Calibration(raw=CAM, out_width=W, out_height=H),
                   SlamConfig(tracker=TrackerConfig(**cfg)), device="cpu"),
        JaxSystem(JaxCalibration(raw=JCAM, out_width=W, out_height=H),
                  JaxConfig(tracker=JaxTrackerConfig(**cfg))),
    )


def _assert_states_match(got, want):
    for a, b in zip(got, want):
        assert (a.status, a.is_keyframe, a.ref_kf_id) == (b.status, b.is_keyframe, b.ref_kf_id)
        assert a.tracked_inliers == b.tracked_inliers
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)
        np.testing.assert_allclose(a.T_kf_frame, np.asarray(b.T_kf_frame), atol=1e-4)


def test_rgbd_live_path_matches_jax_frame_by_frame(scene):
    """`process_frame(depth=)`: the monocular depth is deliberately wrong
    (1 where the plane is at 2), so the right trajectory needs the depth
    images."""
    frames, depths = scene
    port, ref = _rgbd_systems()
    got = [port.process_frame(f, depth=d, timestamp=float(i))
           for i, (f, d) in enumerate(zip(frames, depths))]
    want = [ref.process_frame(f, depth=d, timestamp=float(i))
            for i, (f, d) in enumerate(zip(frames, depths))]
    _assert_states_match(got, want)
    gt = np.asarray(jse3.inverse(_pose(N_FRAMES - 1)))
    assert np.linalg.norm(got[-1].T_wc[:3, 3] - gt[:3, 3]) < 5e-3
    kf = port.keyframes.latest
    assert kf.kp_p3d is not None and abs(float(kf.kp_p3d[kf.kp_valid][:, 2].median()) - 2.0) < 0.1


def test_rgbd_frames_take_the_synchronous_path_in_the_async_loop(scene):
    frames, depths = scene
    port, _ = _rgbd_systems()
    sync, _ = _rgbd_systems()
    for i in range(4):
        assert port.process_frame_async(frames[i], depths[i], timestamp=float(i)) is not None
        sync.process_frame(frames[i], depths[i], timestamp=float(i))
    assert port.flush() is None and port.graph_replays == 0
    for a, b in zip(port.trajectory, sync.trajectory):
        np.testing.assert_array_equal(a.T_wc, b.T_wc)


def test_dense_point_mode_matches_jax(scene):
    frames, depths = scene
    port, ref = _rgbd_systems(point_mode="dense", dense_stride=4, mono_depth=2.0)
    got = [port.process_frame(f, timestamp=float(i)) for i, f in enumerate(frames[:4])]
    want = [ref.process_frame(f, timestamp=float(i)) for i, f in enumerate(frames[:4])]
    _assert_states_match(got, want)
    assert port._prev[1].uv.shape == (1, (H // 4) * (W // 4), 2)
    assert not port._can_pipeline(None)
