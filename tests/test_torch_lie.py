"""Parity of the port's Lie groups and pinhole camera with the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Tolerances: f32 closed forms agree to a few ulps of O(1) values (1e-5
absolute); f64 to 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3, so3 as jso3  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.lie import se3, so3  # noqa: E402

jax.config.update("jax_enable_x64", False)


def _twists(kind: str, n: int = 64, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6))
    if kind == "tiny":
        xi *= 1e-8           # Taylor branches
    elif kind == "small":
        xi *= 0.05
    elif kind == "large":
        xi[:, 3:] *= 1.0
    elif kind == "near_pi":
        w = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
        xi[:, 3:] = w * (np.pi - 1e-4)
    return xi.astype(np.float32)


KINDS = ["tiny", "small", "large", "near_pi"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", KINDS)
def test_se3_exp_log_match_jax(kind):
    xi = _twists(kind)
    T_j = np.asarray(jse3.exp(jnp.asarray(xi)))
    T_t = se3.exp(_t(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-5)
    log_j = np.asarray(jse3.log(jnp.asarray(T_j)))
    log_t = se3.log(_t(T_j)).numpy()
    atol = 2e-3 if kind == "near_pi" else 1e-5   # log is ill-conditioned at pi
    np.testing.assert_allclose(log_t, log_j, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_so3_jacobians_match_jax(kind):
    w = _twists(kind)[:, 3:]
    if kind == "near_pi":
        w = w * 0.9          # J_l^-1 is singular at 2 pi, fine below
    np.testing.assert_allclose(
        so3.left_jacobian(_t(w)).numpy(),
        np.asarray(jso3.left_jacobian(jnp.asarray(w))), atol=1e-5,
    )
    np.testing.assert_allclose(
        so3.left_jacobian_inverse(_t(w)).numpy(),
        np.asarray(jso3.left_jacobian_inverse(jnp.asarray(w))), atol=1e-4,
    )


def test_hat_vee_inverse_compose_apply_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(so3.hat(_t(w)).numpy(), np.asarray(jso3.hat(w)))
    np.testing.assert_array_equal(so3.vee(so3.hat(_t(w))).numpy(), w)
    Ta = np.asarray(jse3.exp(jnp.asarray(_twists("large", 16, 2))))
    Tb = np.asarray(jse3.exp(jnp.asarray(_twists("large", 16, 3))))
    p = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        se3.inverse(_t(Ta)).numpy(), np.asarray(jse3.inverse(Ta)), atol=1e-6)
    np.testing.assert_allclose(
        se3.compose(_t(Ta), _t(Tb)).numpy(), np.asarray(jse3.compose(Ta, Tb)),
        atol=1e-5)
    np.testing.assert_allclose(
        se3.apply(_t(Ta), _t(p)).numpy(), np.asarray(jse3.apply(Ta, p)), atol=1e-5)


def test_normalize_and_right_update_match_jax():
    rng = np.random.default_rng(4)
    T = np.asarray(jse3.exp(jnp.asarray(_twists("large", 16, 5))))
    drift = T.copy()
    drift[:, :3, :3] *= 1.0 + 0.05 * rng.normal(size=(16, 1, 1)).astype(np.float32)
    drift[:, :3, :3] += 1e-3 * rng.normal(size=(16, 3, 3)).astype(np.float32)
    out_t = se3.normalize(_t(drift)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(jse3.normalize(drift)), atol=1e-5)
    R = out_t[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)),
                               atol=1e-5)
    d = _twists("small", 16, 6)
    np.testing.assert_allclose(
        se3.right_update(_t(T), _t(d)).numpy(),
        np.asarray(jse3.right_update(T, d)), atol=1e-5)


def test_float64_roundtrip():
    xi = _twists("large", 32, 7).astype(np.float64)
    back = se3.log(se3.exp(_t(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=1e-9)


CAMS = [
    dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480),
    dict(fx=120.0, fy=110.0, cx=79.5, cy=59.5, width=160, height=120),
]


@pytest.mark.parametrize("level", [0, 1, 3])
@pytest.mark.parametrize("cam_kw", CAMS)
def test_camera_matches_jax(cam_kw, level):
    jcam = JaxCamera(**cam_kw).scaled(level)
    cam = camera_from_jax(JaxCamera(**cam_kw)).scaled(level)
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height) == (
        jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.width, jcam.height)
    rng = np.random.default_rng(level)
    pts = rng.normal(size=(256, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[:4, 2] = [0.0, 1e-10, -1e-10, -2.0]   # the |z| < 1e-9 guard
    np.testing.assert_allclose(
        cam.project(_t(pts)).numpy(), np.asarray(jcam.project(pts)), rtol=1e-6)
    np.testing.assert_allclose(
        cam.project_jacobian(_t(pts)).numpy(),
        np.asarray(jcam.project_jacobian(pts)), rtol=1e-6)
    uv = rng.uniform(0, 100, size=(256, 2)).astype(np.float32)
    z = rng.uniform(0.5, 4, size=(256,)).astype(np.float32)
    np.testing.assert_allclose(
        cam.unproject(_t(uv), _t(z)).numpy(),
        np.asarray(jcam.unproject(uv, z)), rtol=1e-6)


def test_camera_refuses_distortion():
    with pytest.raises(ValueError):
        camera_from_jax(JaxCamera(100.0, 100.0, 50.0, 50.0, 100, 100, k1=0.1))
    assert PinholeCamera(1.0, 1.0, 0.0, 0.0, 8, 8).scaled(1).width == 4
