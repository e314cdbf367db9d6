"""The port's session tooling (`SlamSystem.export_map_ply`,
`save_checkpoint`, `resume_from`, `utils.checkpoint`) on the cases of
tests/test_session.py (160 x 120, 4 levels, track levels (2, 1, 0), 512
points, monocular depth 2), against the JAX package's.

Tolerances: the checkpoint round trip as tests/test_session.py holds the
JAX package (live pose 1e-6, the first six exported poses 1e-5, the last
within 0.05 m of the truth); a session saved by either package and
resumed by the other continues three frames to the poses of the same file
resumed by its own package within 1e-4 (f32 sums in another order, as
tests/test_torch_system.py holds the live path); the map's vertex count
equal to the JAX package's and its points within 1e-3 m (each keyframe's
selected points and pose agree to f32 rounding; the file is written with
six decimals).
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
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from uwslam_tpu_torch.utils.checkpoint import load_session, save_session  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, mono_depth=2.0)


def _port():
    return SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**TRACKER)), device="cpu")


def _jax():
    return JaxSystem(JaxCalibration(raw=JCAM, out_width=160, out_height=120),
                     JaxConfig(tracker=JaxTrackerConfig(**TRACKER)))


def _frame(i):
    T = jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0, 0, 0, 0.002 * i]))
    return np.asarray(render_plane_view(JCAM, T, 2.0))


@pytest.fixture(scope="module")
def frames():
    return [_frame(i) for i in range(9)]


def test_checkpoint_roundtrip_continues_the_trajectory(frames, tmp_path):
    """tests/test_session.py's round trip, on the port."""
    s1 = _port()
    for i in range(6):
        s1.process_frame(frames[i])
    ck = str(tmp_path / "sess")
    s1.save_checkpoint(ck)
    _, poses1 = s1.export_trajectory()
    s2 = _port()
    assert s2.resume_from(ck) == 6
    np.testing.assert_allclose(np.asarray(s2._T_wc), np.asarray(s1._T_wc), atol=1e-6)
    for i in range(6, 9):
        s2.process_frame(frames[i])
    ts2, poses2 = s2.export_trajectory()
    assert len(ts2) == 9
    np.testing.assert_allclose(poses2[:6], poses1, atol=1e-5)
    gt = np.asarray(jse3.inverse(jse3.exp(jnp.asarray([0.16, 0.064, 0, 0, 0, 0.016]))))
    assert np.linalg.norm(poses2[-1][:3, 3] - gt[:3, 3]) < 0.05
    # The resumed frame is a first frame: a keyframe at the restored pose.
    assert s2.trajectory[6].is_keyframe and s2.trajectory[6].ref_kf_id == 6


@pytest.fixture(scope="module")
def saved(frames, tmp_path_factory):
    """Six frames through each package, each saved to its own file."""
    out = tmp_path_factory.mktemp("sessions")
    paths = {}
    for name, system in (("port", _port()), ("jax", _jax())):
        for i in range(6):
            system.process_frame(frames[i], timestamp=float(i))
        paths[name] = str(out / name)
        system.save_checkpoint(paths[name])
    return paths


def _continue(system, path, frames):
    assert system.resume_from(path) == 6
    for i in range(6, 9):
        system.process_frame(frames[i], timestamp=float(i))
    return system.export_trajectory()[1]


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_a_session_resumes_in_the_other_package(saved, frames, saved_by):
    a = load_session(saved["jax"])
    b = load_session(saved["port"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype.kind == b[k].dtype.kind and a[k].shape == b[k].shape, k
    in_port = _continue(_port(), saved[saved_by], frames)
    in_jax = _continue(_jax(), saved[saved_by], frames)
    assert in_port.shape == (9, 4, 4)
    np.testing.assert_allclose(in_port, in_jax, atol=1e-4)


def test_save_session_is_atomic_and_appends_npz(tmp_path):
    path = str(tmp_path / "state")
    save_session(path, {"a": np.arange(3), "b": 2.5})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.npz"]
    got = load_session(path + ".npz")
    assert np.array_equal(got["a"], np.arange(3)) and float(got["b"]) == 2.5


def _read_ply(path):
    lines = open(path).read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    return n, np.array([[float(x) for x in ln.split()] for ln in body]).reshape(-1, 3)


def test_export_map_ply_matches_jax(frames, tmp_path):
    """tests/test_session.py's five-frame map, from both packages."""
    port, ref = _port(), _jax()
    for i in range(5):
        port.process_frame(frames[i])
        ref.process_frame(frames[i])
    n = port.export_map_ply(str(tmp_path / "port.ply"))
    n_j = ref.export_map_ply(str(tmp_path / "jax.ply"))
    assert n == n_j > 100
    got, want = _read_ply(tmp_path / "port.ply"), _read_ply(tmp_path / "jax.ply")
    assert got[0] == want[0] == n
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    # The stride subsampling of a large map, as the JAX package's.
    assert (port.export_map_ply(str(tmp_path / "small.ply"), max_points=100)
            == ref.export_map_ply(str(tmp_path / "small_j.ply"), max_points=100) <= 100)
    empty = _port()
    assert empty.export_map_ply(str(tmp_path / "empty.ply")) == 0
