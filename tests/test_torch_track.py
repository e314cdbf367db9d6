"""Parity of the port's IC tracking (`_cholesky_solve6`, `_solve_damped`,
`lm_level_ic`, `track`) with the JAX package's CPU branch, vmapped over the
same frame pairs.

Both sides get identical inputs (the JAX pyramid and points, carried over
by `uwslam_tpu_torch.interop`). Sums are taken in another order, so LM
states agree to f32 rounding: poses to 1e-4 on se3.log, counts exactly.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image.pyramid import bilinear_sample as jax_sample  # noqa: E402
from uwslam_tpu.image.pyramid import build_pyramid_batched as jax_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import photometric as jphoto  # noqa: E402
from uwslam_tpu.tracking.points import TrackPoints as JaxPoints  # noqa: E402
from uwslam_tpu.tracking.points import topk_gradient_points as jax_topk  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch.interop import (  # noqa: E402
    camera_from_jax,
    points_from_numpy,
    pyramid_from_numpy,
)
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.tracking import photometric  # noqa: E402

# The tests run on the CPU, where the wrappers take their plain versions.
points_from_numpy = partial(points_from_numpy, device="cpu")
pyramid_from_numpy = partial(pyramid_from_numpy, device="cpu")

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
NUM_POINTS = 384


def _spd(seed, n=6, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(8, n, n)))
    ev = np.geomspace(1.0, cond, n) * rng.uniform(0.5, 2.0, size=(8, 1))
    A = (Q * ev[:, None, :]) @ Q.transpose(0, 2, 1)
    return A.astype(np.float32), rng.normal(size=(8, n)).astype(np.float32)


F32_EPS = 6e-8   # unit roundoff of float32


def _solve_error(x, x64):
    """Largest error of each system's solution relative to its largest
    entry (a normwise error: small entries of x carry the absolute error of
    the large ones)."""
    return float((np.abs(x - x64).max(-1) / np.abs(x64).max(-1)).max())


@pytest.mark.parametrize("n", [6, 8])
@pytest.mark.parametrize("cond", [10.0, 1e4])
def test_cholesky_solve_matches_jax(n, cond):
    """Port and JAX run the same operation order, but XLA's CPU code
    generator contracts `s - L * L` into fused multiply-adds where the host
    has them, so the two differ by rounding, amplified by the condition
    number: a backward-stable f32 solve is within a small multiple of
    cond * eps of the exact solution. Each is held to 4 * cond * eps of a
    float64 solve (measured: at most 0.25 * cond * eps), and the two to the
    same bound of each other."""
    A, b = _spd(int(cond) + n, n, cond)
    bound = 4.0 * cond * F32_EPS
    x64 = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    want = np.asarray(jphoto._cholesky_solve6(jnp.asarray(A), jnp.asarray(b)))
    got = photometric._cholesky_solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert _solve_error(want, x64) <= bound
    assert _solve_error(got, x64) <= bound
    assert _solve_error(got, want) <= bound


def test_cholesky_solve_clamps_pivots_like_jax():
    """Singular systems: the 1e-20 pivot clamp acts, where
    torch.linalg.cholesky would raise. A diagonal matrix with zeros has zero
    pivots in any arithmetic (every off-diagonal term is exactly 0), so the
    clamped solve b / (1e-10)^2 is compared by value. A random rank-3 matrix
    has pivots that are rounding errors of either sign, so its solutions
    overflow in a pattern that depends on the host's arithmetic: there the
    port must be finite wherever JAX is."""
    d = np.array([[4.0, 0.0, 9.0, 1.0, 0.0, 0.25],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [1.0, 2.0, 3.0, 4.0, 5.0, 0.0]], np.float32)
    A = np.stack([np.diag(row) for row in d])
    b = np.array([[1.0, -2.0, 3.0, 0.5, 0.0, -1.0],
                  [1e-3, 1.0, -1.0, 2.0, 0.0, 7.0],
                  [-1.0, 1.0, -1.0, 1.0, -1.0, 3.0]], np.float32)
    want = np.asarray(jphoto._cholesky_solve6(jnp.asarray(A), jnp.asarray(b)))
    got = photometric._cholesky_solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[0, 1], -2.0 / np.float32(1e-10) ** 2, rtol=1e-5)
    np.testing.assert_allclose(got[0, [0, 2]], [0.25, 1.0 / 3.0], rtol=1e-6)

    rng = np.random.default_rng(0)
    J = rng.normal(size=(8, 6, 3)).astype(np.float32)
    A = J @ J.transpose(0, 2, 1)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    want = np.asarray(jphoto._cholesky_solve6(jnp.asarray(A), jnp.asarray(b)))
    got = photometric._cholesky_solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isfinite(got)[np.isfinite(want)].all()


@pytest.mark.parametrize("lam", [1e-4, 0.5, 100.0])
def test_solve_damped_matches_jax(lam):
    A, b = _spd(5, 6, 1e3)
    want = np.stack([
        np.asarray(jphoto._solve_damped(jnp.asarray(A[i]), jnp.asarray(b[i]),
                                        jnp.float32(lam)))
        for i in range(8)
    ])
    got = photometric._solve_damped(
        torch.from_numpy(A), torch.from_numpy(b), torch.full((8,), lam)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pairs():
    """Five synthetic frames (four pairs) with the JAX package's pyramid and
    selected points; the last target is replaced by an unrelated texture so
    one pair tracks garbage (the basin guard's territory)."""
    twists = [[0.02 * i, 0.01 * i, 0.004 * i, 0.002 * i, -0.003 * i, 0.004 * i]
              for i in range(5)]
    frames = np.stack([
        np.asarray(render_plane_view(JCAM, jse3.exp(jnp.asarray(t, jnp.float32)), 2.0))
        for t in twists
    ])
    frames[4] = np.asarray(render_plane_view(
        JCAM, jse3.exp(jnp.asarray([0.3, 0.2, 0.0, 0.0, 0.0, 0.4], jnp.float32)), 2.0,
        seed=3))
    pyr = jax_pyramid(jnp.asarray(frames), levels=4)
    pts = jax.vmap(lambda i, g, gx, gy: jax_topk(
        i, g, JCAM, num_points=NUM_POINTS, mono_z=2.0, grad_x=gx, grad_y=gy,
    ))(pyr.images[0], pyr.grad_mag[0], pyr.grad_x[0], pyr.grad_y[0])
    ref_pyr = jax.tree.map(lambda x: x[:-1], pyr)
    tgt_pyr = jax.tree.map(lambda x: x[1:], pyr)
    ref_pts = jax.tree.map(lambda x: x[:-1], pts)
    return ref_pyr, tgt_pyr, ref_pts


def _level_inputs(ref_pyr, ref_pts, lvl):
    """The JAX CPU branch's reference pass at level `lvl` (three gathers)."""
    uv = ref_pts.uv * (1.0 / (1 << lvl))

    def one(img, gx, gy, uv_b, p3d, valid):
        i_ref, ok = jax_sample(img, uv_b)
        g_x, _ = jax_sample(gx, uv_b)
        g_y, _ = jax_sample(gy, uv_b)
        return JaxPoints(uv=uv_b, p3d=p3d, intensity=i_ref, valid=valid & ok), g_x, g_y

    return jax.vmap(one)(ref_pyr.images[lvl], ref_pyr.grad_x[lvl],
                         ref_pyr.grad_y[lvl], uv, ref_pts.p3d, ref_pts.valid)


@pytest.mark.parametrize("lvl,iters,init", [(2, 8, "identity"), (1, 5, "perturbed"),
                                             (0, 3, "identity")])
def test_lm_level_ic_matches_jax(pairs, lvl, iters, init):
    ref_pyr, tgt_pyr, ref_pts = pairs
    pts_l, gx, gy = _level_inputs(ref_pyr, ref_pts, lvl)
    cam_l = JCAM.scaled(lvl)
    B = pts_l.uv.shape[0]
    if init == "identity":
        T0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))
    else:
        T0 = jse3.exp(jnp.tile(jnp.asarray([0.01, 0.005, 0.0, 0.0, 0.002, 0.0]), (B, 1)))
    want = jax.vmap(partial(jphoto.lm_level_ic, cam=cam_l, max_iters=iters))(
        T0, pts_l, pts_l.intensity, gx, gy, tgt_pyr.images[lvl])
    got = photometric.lm_level_ic(
        torch.from_numpy(np.array(T0)), points_from_numpy(pts_l._replace(gx0=None, gy0=None)),
        torch.from_numpy(np.array(pts_l.intensity)), torch.from_numpy(np.array(gx)),
        torch.from_numpy(np.array(gy)), torch.from_numpy(np.array(tgt_pyr.images[lvl])),
        camera_from_jax(cam_l), max_iters=iters,
    )
    dlog = se3.log(got.T) - se3.log(torch.from_numpy(np.array(want.T)))
    assert float(dlog[:3].abs().max()) < 1e-4       # the three real pairs
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.n_inlier.numpy(), np.asarray(want.n_inlier))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.valid_best.numpy(), np.asarray(want.valid_best))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), rtol=1e-3)
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J_best), rtol=1e-5, atol=1e-4)


def test_track_ic_matches_jax(pairs):
    ref_pyr, tgt_pyr, ref_pts = pairs
    levels, iters = (3, 2, 1, 0), (12, 8, 5, 3)
    want = jax.vmap(lambda rp, tp, p: jphoto.track(
        rp, tp, p, JCAM, levels=levels, max_iters=iters, mode="ic",
    ))(ref_pyr, tgt_pyr, ref_pts)
    got = photometric.track(
        pyramid_from_numpy(ref_pyr), pyramid_from_numpy(tgt_pyr),
        points_from_numpy(ref_pts), CAM, levels=levels, max_iters=iters, mode="ic",
    )
    dlog = se3.log(got.T) - se3.log(torch.from_numpy(np.array(want.T)))
    assert float(dlog[:3].abs().max()) < 1e-4
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), rtol=1e-3)


def test_track_refuses_forward_compositional_mode(pairs):
    """Forward-compositional tracking is spelled "fc": the long name
    "forward", like any mode other than "fc" and "ic", is refused. FC itself
    is held against the JAX package in tests/test_torch_fc.py."""
    ref_pyr, tgt_pyr, ref_pts = pairs
    with pytest.raises(ValueError):
        photometric.track(pyramid_from_numpy(ref_pyr), pyramid_from_numpy(tgt_pyr),
                          points_from_numpy(ref_pts), CAM, mode="forward")
