"""The port's live path (`SlamSystem.process_frame`, configuration 1: FC
tracking, keyframes, relocalization) against the JAX package's on the
sequences of tests/test_system.py and tests/test_reloc.py, and the
package's boundaries: unported switches refuse loudly, the default device
is the card, and no module needs JAX.

Tolerances: per-frame T_wc atol 1e-4 (f32 sums in another order), statuses,
keyframe flags and the exported trajectory's timestamps equal. A
relocalized pose comes from RANSAC samples, which the two packages draw
from different generators: with its own samples the port must recover
within 0.1 of ground truth (the JAX test's bound); given the JAX package's
samples it must agree with the JAX pose within 1e-3.
"""
import os
import subprocess
import sys
from pathlib import Path

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
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch import system as tsystem  # noqa: E402
from uwslam_tpu_torch.camera import Calibration, PinholeCamera  # noqa: E402
from uwslam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.io import read_trajectory_tum  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "uwslam_tpu_torch"
JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, mono_depth=2.0)


def _systems(**tracker):
    cfg = dict(TRACKER, **tracker)
    return (
        SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                   SlamConfig(tracker=TrackerConfig(**cfg)), device="cpu"),
        JaxSystem(JaxCalibration(raw=JCAM, out_width=160, out_height=120),
                  JaxConfig(tracker=JaxTrackerConfig(**cfg))),
    )


def _view(xi):
    return np.asarray(render_plane_view(JCAM, jse3.exp(jnp.asarray(xi, jnp.float32)), 2.0))


@pytest.fixture(scope="module")
def clean_runs(tmp_path_factory):
    """tests/test_system.py's 8-frame sequence through both systems."""
    xis = [[0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i]
           for i in range(8)]
    frames = [_view(xi) for xi in xis]
    gt = np.stack([np.asarray(jse3.inverse(jse3.exp(jnp.asarray(xi, jnp.float32))))
                   for xi in xis])
    port, ref = _systems(point_block=4)
    got = [port.process_frame(f, timestamp=float(i)) for i, f in enumerate(frames)]
    want = [ref.process_frame(f, timestamp=float(i)) for i, f in enumerate(frames)]
    out = tmp_path_factory.mktemp("traj")
    exported = (port.export_trajectory(str(out / "port.txt")),
                ref.export_trajectory(str(out / "jax.txt")))
    return frames, gt, got, want, exported, out


def test_live_path_matches_jax_frame_by_frame(clean_runs):
    _, _, got, want, _, _ = clean_runs
    for a, b in zip(got, want):
        assert (a.status, a.is_keyframe, a.ref_kf_id) == (b.status, b.is_keyframe, b.ref_kf_id)
        assert a.tracked_inliers == b.tracked_inliers
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)
        np.testing.assert_allclose(a.T_kf_frame, np.asarray(b.T_kf_frame), atol=1e-4)
        np.testing.assert_allclose(a.track_error, b.track_error, rtol=1e-3, atol=1e-5)
    assert sum(s.is_keyframe for s in got) >= 2


def test_exported_trajectory_matches_jax(clean_runs):
    _, gt, _, _, ((ts, poses), (ts_j, poses_j)), out = clean_runs
    np.testing.assert_array_equal(ts, ts_j)
    np.testing.assert_allclose(poses, poses_j, atol=1e-4)
    from uwslam_tpu_torch.io import ate_rmse

    assert ate_rmse(poses[:, :3, 3], gt[:, :3, 3]) < 0.01
    a, b = np.loadtxt(out / "port.txt"), np.loadtxt(out / "jax.txt")
    np.testing.assert_allclose(a, b, atol=1e-4)
    ts_r, poses_r = read_trajectory_tum(str(out / "port.txt"))
    assert len(ts_r) == 8 and np.isfinite(poses_r).all()


def test_uint8_and_tensor_frames_give_the_same_poses(clean_runs):
    frames, _, got, _, _, _ = clean_runs
    a, _ = _systems(point_block=4)
    b, _ = _systems(point_block=4)
    for i, f in enumerate(frames[:4]):
        q = np.clip(f, 0, 255).astype(np.uint8)
        sa = a.process_frame(q)
        sb = b.process_frame(torch.from_numpy(q.astype(np.float32)))
        np.testing.assert_array_equal(sa.T_wc, sb.T_wc)
    assert a.trajectory[-1].status == "ok"


def _garbage_sequence():
    poses = [jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0.0, 0.0, 0.0, 0.002 * i]))
             for i in range(6)]
    frames = [np.asarray(render_plane_view(JCAM, poses[i], 2.0)) for i in range(4)]
    frames.append(np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(np.float32))
    frames += [np.asarray(render_plane_view(JCAM, poses[i], 2.0)) for i in (4, 5)]
    return frames, np.asarray(jse3.inverse(poses[5]))


def _jax_samples(valid, num_hypotheses, generator):
    """The minimal samples the JAX package draws (PRNGKey(frame id))."""
    key = jax.random.PRNGKey(generator.initial_seed())
    u = jax.random.uniform(key, (num_hypotheses, valid.shape[0]), minval=1e-9, maxval=1.0)
    keys = jnp.where(jnp.asarray(valid.numpy())[None, :], -jnp.log(-jnp.log(u)), -jnp.inf)
    return torch.from_numpy(np.asarray(jax.lax.top_k(keys, 6)[1]).astype(np.int64))


@pytest.fixture(scope="module")
def reloc_runs():
    frames, gt_last = _garbage_sequence()
    port, ref = _systems()
    got = [port.process_frame(f) for f in frames]
    want = [ref.process_frame(f) for f in frames]
    return frames, gt_last, got, want


def test_garbage_frame_lost_and_relocalized_like_jax(reloc_runs):
    _, gt_last, got, want = reloc_runs
    assert [s.status for s in got] == [s.status for s in want]
    assert [s.status for s in got][4:6] == ["lost", "relocalized"]
    assert [s.is_keyframe for s in got] == [s.is_keyframe for s in want]
    assert np.linalg.norm(got[-1].T_wc[:3, 3] - gt_last[:3, 3]) < 0.1


def test_relocalized_pose_matches_jax_given_its_samples(reloc_runs, monkeypatch):
    frames, gt_last, _, want = reloc_runs
    monkeypatch.setattr(tsystem, "sample_hypotheses", _jax_samples)
    port, _ = _systems()
    got = [port.process_frame(f) for f in frames]
    assert [s.status for s in got] == [s.status for s in want]
    for a, b in zip(got[5:], want[5:]):
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-3)
    assert np.linalg.norm(got[-1].T_wc[:3, 3] - gt_last[:3, 3]) < 0.1


def test_clean_sequence_never_lost():
    port, _ = _systems()
    for i in range(5):
        assert port.process_frame(_view([0.02 * i, 0, 0, 0, 0, 0])).status == "ok"


@pytest.mark.parametrize("change", [
    dict(use_features=True), dict(use_ba=True), dict(use_loop_closure=True),
    dict(global_ba=True), dict(tracker=TrackerConfig(depth_bootstrap=True)),
])
def test_unported_switches_raise_naming_the_roadmap(change):
    with pytest.raises(NotImplementedError, match="ROADMAP slice"):
        SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120), SlamConfig(**change),
                   device="cpu")


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120), SlamConfig())


def test_crop_and_profile_timers():
    calib = Calibration(raw=PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5,
                                          width=165, height=123),
                        out_width=165, out_height=123)
    port = SlamSystem(calib, SlamConfig(tracker=TrackerConfig(**TRACKER), profile=True),
                      device="cpu")
    assert (port.cam.width, port.cam.height) == (160, 120)
    big = np.zeros((123, 165), np.float32)
    big[:120, :160] = _view([0.0] * 6)
    port.process_frame(big)
    big[:120, :160] = _view([0.01, 0, 0, 0, 0, 0])
    assert port.process_frame(big).status == "ok"
    summary = port.timers.summary()
    assert {"ingest", "track", "select"} <= set(summary)
    assert "ms/call" in port.timers.report()


def test_every_module_imports_where_jax_cannot_be_imported():
    modules = sorted(
        "uwslam_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'uwslam_tpu'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "uwslam_tpu_torch.system" in modules and "uwslam_tpu_torch.cli.main" in modules
