"""Lens distortion and rectification in the port against the JAX package's
CPU branch (the exact gather remap; the JAX package's two-pass remap is its
TPU stand-in and has no counterpart): the radtan model, `optimal_new_camera`,
`undistort_map`, `remap_bilinear`, `compute_roi`, the distorted renderer and
a distorted `SlamSystem` (EUROC-like coefficients on a 192 x 128 image, the
calibration written as the XML both packages' loaders read).

Tolerances: normalized coordinates atol 1e-6; rectified intrinsics rtol
1e-5; map entries atol 1e-4 px; remapped intensities atol 1e-3 gray levels
(1e-4 px times gradients of some gray levels per pixel); region of interest
and camera of the system equal; poses atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu import camera as jcamera  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.camera import model as jmodel  # noqa: E402
from uwslam_tpu.config import SlamConfig as JaxConfig  # noqa: E402
from uwslam_tpu.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch import camera  # noqa: E402
from uwslam_tpu_torch.camera import model  # noqa: E402
from uwslam_tpu_torch.config import SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.io import ate_rmse  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from uwslam_tpu_torch.utils import synthetic  # noqa: E402

JRAW = JaxCamera(fx=140.0, fy=140.0, cx=95.5, cy=63.5, width=192, height=128,
                 k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5)
RAW = camera_from_jax(JRAW)
JBARREL = JaxCamera(fx=100.0, fy=105.0, cx=70.0, cy=50.0, width=144, height=96,
                    k1=0.12, k2=-0.02, p1=-1e-3, p2=5e-4)
CAMS = {"euroc-like": JRAW, "pincushion": JBARREL}

XML = """<?xml version="1.0"?>
<opencv_storage>
<in_width>{w}</in_width><in_height>{h}</in_height>
<out_width>{w}</out_width><out_height>{h}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{fx} {fy} {cx} {cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{k1} {k2} {p1} {p2}</data></rectification>
</opencv_storage>
"""


def _pose(i):
    return jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0.003 * i, 0.0, 0.0, 0.002 * i],
                                jnp.float32))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_distort_and_undistort_normalized_match_jax(name):
    jcam = CAMS[name]
    cam = camera_from_jax(jcam)
    xy = np.random.default_rng(0).uniform(-0.7, 0.7, size=(5, 200, 2)).astype(np.float32)
    got = cam.distort_normalized(torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcam.distort_normalized(xy)), atol=1e-6)
    back = cam.undistort_normalized(got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jcam.undistort_normalized(jnp.asarray(got.numpy()))), atol=1e-6)
    for iters in (1, 3):
        np.testing.assert_allclose(
            cam.undistort_normalized(got, iters=iters).numpy(),
            np.asarray(jcam.undistort_normalized(jnp.asarray(got.numpy()), iters=iters)),
            atol=1e-6)
    np.testing.assert_allclose(back.numpy(), xy, atol=2e-3)   # 8 iterations invert it


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("name", sorted(CAMS))
def test_optimal_new_camera_matches_jax(name, alpha):
    jcam = CAMS[name]
    want = jmodel.optimal_new_camera(jcam, jcam.width, jcam.height, alpha=alpha)
    got = model.optimal_new_camera(camera_from_jax(jcam), jcam.width, jcam.height, alpha=alpha)
    assert (got.width, got.height) == (want.width, want.height)
    assert not got.has_distortion
    np.testing.assert_allclose([got.fx, got.fy, got.cx, got.cy],
                               [want.fx, want.fy, want.cx, want.cy], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_undistort_map_matches_jax(name):
    jcam = CAMS[name]
    jrect = jmodel.optimal_new_camera(jcam, jcam.width, jcam.height)
    want = np.asarray(jmodel.undistort_map(jcam, jrect))
    got = model.undistort_map(camera_from_jax(jcam), camera_from_jax(jrect))
    assert got.shape == (jcam.height, jcam.width, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # The port's own rectified camera gives the same map.
    rect = model.optimal_new_camera(camera_from_jax(jcam), jcam.width, jcam.height)
    np.testing.assert_allclose(
        model.undistort_map(camera_from_jax(jcam), rect).numpy(), want, atol=1e-3)


def test_remap_bilinear_matches_jax_with_exact_edges_and_outside():
    rng = np.random.default_rng(1)
    H, W = 40, 56
    image = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    coords = rng.uniform([-3.0, -3.0], [W + 2.0, H + 2.0], size=(30, 50, 2)).astype(np.float32)
    special = np.asarray([
        [W - 1, 7.0], [W - 1, H - 1], [12.0, H - 1], [0.0, 0.0], [W - 1, 3.5], [20.25, H - 1],
        [W - 1 + 1e-3, 5.0], [-1e-3, 5.0], [5.0, H - 1 + 1e-3], [5.0, -1e-3], [1e6, 1e6],
        [np.nan, 2.0],
    ], np.float32)
    coords[0, : len(special)] = special
    want = np.asarray(jmodel.remap_bilinear(jnp.asarray(image), jnp.asarray(coords)))
    got = model.remap_bilinear(torch.from_numpy(image), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0, 0] == image[7, W - 1] and got[0, 1] == image[H - 1, W - 1]
    assert got[0, 2] == image[H - 1, 12] and got[0, 3] == image[0, 0]
    np.testing.assert_allclose(got[0, 4], 0.5 * (image[3, W - 1] + image[4, W - 1]), rtol=1e-6)
    assert (got[0, 6:12] == 0.0).all()
    filled = model.remap_bilinear(torch.from_numpy(image), torch.from_numpy(coords), fill=-1.0)
    assert (filled[0, 6:12] == -1.0).all()


def _valid_mask(m, cam):
    return ((m[..., 0] >= 0) & (m[..., 0] <= cam.width - 1)
            & (m[..., 1] >= 0) & (m[..., 1] <= cam.height - 1))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_compute_roi_matches_jax_on_the_rectification_mask(name):
    jcam = CAMS[name]
    cam = camera_from_jax(jcam)
    rect = model.optimal_new_camera(cam, cam.width, cam.height, alpha=0.5)
    mask = _valid_mask(model.undistort_map(cam, rect).numpy(), cam)
    assert not mask.all() and mask.any()
    assert model.compute_roi(mask) == jmodel.compute_roi(mask)
    assert model.compute_roi(mask, margin=0) == jmodel.compute_roi(mask, margin=0)


@pytest.mark.parametrize("shape,box", [
    ((64, 96), (0, 0, 64, 96)), ((64, 96), (7, 11, 50, 80)), ((64, 96), (0, 0, 0, 0)),
    ((40, 40), (3, 3, 30, 33)),
])
def test_compute_roi_matches_jax_on_boxes(shape, box):
    mask = np.zeros(shape, bool)
    y0, x0, y1, x1 = box
    mask[y0:y1, x0:x1] = True
    got = model.compute_roi(mask)
    assert got == jmodel.compute_roi(mask)
    assert got[2] % 16 == 0 and got[3] % 16 == 0


@pytest.mark.parametrize("i", [0, 3])
def test_render_plane_view_distorted_matches_jax(i):
    T = _pose(i)
    want = np.asarray(jsyn.render_plane_view_distorted(JRAW, T, 2.0))
    got = synthetic.render_plane_view_distorted(RAW, torch.from_numpy(np.array(T)), 2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    # Not the undistorted view: the lens moves the corners by pixels.
    plain = synthetic.render_plane_view(RAW, torch.from_numpy(np.array(T)), 2.0)
    assert float((got - plain).abs().max()) > 5.0


@pytest.fixture(scope="module")
def distorted_runs(tmp_path_factory):
    """8 distorted frames through both systems, each built from the XML
    calibration as its own loader reads it."""
    path = tmp_path_factory.mktemp("calib") / "euroc_like.xml"
    path.write_text(XML.format(w=JRAW.width, h=JRAW.height, fx=JRAW.fx, fy=JRAW.fy,
                               cx=JRAW.cx, cy=JRAW.cy, k1=JRAW.k1, k2=JRAW.k2,
                               p1=JRAW.p1, p2=JRAW.p2))
    tracker = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, mono_depth=2.0)
    port = SlamSystem(camera.load(str(path)), SlamConfig(tracker=TrackerConfig(**tracker)),
                      device="cpu")
    ref = JaxSystem(jcamera.load(str(path)), JaxConfig(tracker=JaxTrackerConfig(**tracker)))
    frames = [np.asarray(jsyn.render_plane_view_distorted(JRAW, _pose(i), 2.0))
              for i in range(8)]
    got = [port.process_frame(f) for f in frames]
    want = [ref.process_frame(f) for f in frames]
    gt = np.stack([np.asarray(jse3.inverse(_pose(i))) for i in range(8)])
    return port, ref, frames, got, want, gt


def test_distorted_system_has_the_roi_and_camera_of_jax(distorted_runs):
    port, ref, frames, _, _, _ = distorted_runs
    assert port.calib.needs_rectification and port._rect_map is not None
    assert port._roi == ref._roi
    assert port.cam.width < RAW.width or port.cam.height < RAW.height
    assert (port.cam.width, port.cam.height) == (ref.cam.width, ref.cam.height)
    np.testing.assert_allclose([port.cam.fx, port.cam.fy, port.cam.cx, port.cam.cy],
                               [ref.cam.fx, ref.cam.fy, ref.cam.cx, ref.cam.cy], rtol=1e-5)
    np.testing.assert_allclose(port._ingest(frames[2]).numpy(),
                               np.asarray(ref._ingest(frames[2])), atol=1e-3)


def test_distorted_system_tracks_like_jax(distorted_runs):
    _, _, _, got, want, gt = distorted_runs
    for a, b in zip(got, want):
        assert (a.status, a.is_keyframe, a.ref_kf_id) == (b.status, b.is_keyframe, b.ref_kf_id)
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)
    est = np.stack([s.T_wc[:3, 3] for s in got])
    assert ate_rmse(est, gt[:, :3, 3]) < 0.02


def test_distorted_frames_need_the_rectification(distorted_runs):
    """The same frames through an undistorted calibration track worse."""
    _, _, frames, got, _, gt = distorted_runs
    plain = camera.Calibration(
        raw=camera.PinholeCamera(fx=RAW.fx, fy=RAW.fy, cx=RAW.cx, cy=RAW.cy,
                                 width=RAW.width, height=RAW.height),
        out_width=RAW.width, out_height=RAW.height)
    system = SlamSystem(plain, SlamConfig(tracker=TrackerConfig(
        pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, mono_depth=2.0)),
        device="cpu")
    est = np.stack([system.process_frame(f).T_wc[:3, 3] for f in frames])
    rectified = np.stack([s.T_wc[:3, 3] for s in got])
    assert ate_rmse(est, gt[:, :3, 3]) > 2.0 * ate_rmse(rectified, gt[:, :3, 3])
