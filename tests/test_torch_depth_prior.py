"""Parity of the port's depth bootstrap (`tracking.depth_prior`,
`tracking.depth_refine`) with the JAX package on the same numpy inputs
(160x120 and 320x240 frames of the multi-plane scene). Triangulation is
held to the JAX package's accelerator branch (the inhomogeneous DLT, which
the port runs on every device; see tests/test_torch_ransac.py) and, more
loosely, to its CPU branch (the homogeneous DLT by LAPACK).

Tolerances: grids atol 1e-5 (sums of a few f32 votes per cell in another
order), bilinear reads atol 1e-5, flags equal; triangulated depths rtol
2e-4 where both are good, gates equal but for points within 1e-3 of a
gate (against the homogeneous form 5e-3: the two weigh the 0.1 px noise of
the matches differently); refined inverse depths
atol 1e-3 (4 Gauss-Newton steps through bilinear reads of values up to 255;
2.1e-4 on this host).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image.pyramid import build_pyramid as jbuild_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import depth_prior as jprior  # noqa: E402
from uwslam_tpu.tracking import depth_refine as jrefine  # noqa: E402
from uwslam_tpu.tracking import points as jpoints  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch.interop import (  # noqa: E402
    camera_from_jax,
    depth_prior_from_numpy,
    points_from_numpy,
)
from uwslam_tpu_torch.tracking import depth_prior, depth_refine  # noqa: E402
from test_torch_ransac import jax_accelerator_branch  # noqa: E402

JCAM = JaxCamera(fx=130.0, fy=130.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
XI = np.array([0.05, 0.018, 0.012, 0.004, 0.012, 0.005], np.float32)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _sparse_points(seed=0, n=400):
    """Random pixels with depths of a two-level scene and a validity mask."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, JCAM.width - 1, n), rng.uniform(0, JCAM.height - 1, n)],
                  axis=-1).astype(np.float32)
    depth = np.where(uv[:, 0] < 80, 2.0, 3.5).astype(np.float32) * rng.uniform(0.95, 1.05, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    return uv, depth, valid


def _grids(seed=0, block=16, n=400):
    uv, depth, valid = _sparse_points(seed, n)
    gj = jprior.prior_from_points(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid),
                                  JCAM.height, JCAM.width, block=block)
    gt = depth_prior.prior_from_points(_t(uv), _t(depth), _t(valid), CAM.height, CAM.width,
                                       block=block)
    return gj, gt


def _same_grid(gj, gt, atol=1e-5):
    np.testing.assert_allclose(gt.inv_depth.numpy(), np.asarray(gj.inv_depth), atol=atol)
    np.testing.assert_allclose(gt.weight.numpy(), np.asarray(gj.weight), atol=atol)
    assert gt.block == gj.block


@pytest.mark.parametrize("block", [16, 32])
def test_prior_from_points_matches_jax(block):
    gj, gt = _grids(block=block)
    _same_grid(gj, gt)
    assert float(gt.weight.sum()) > 0 and bool(gt.ok)


def test_prior_from_points_with_weights_matches_jax():
    uv, depth, valid = _sparse_points(1)
    w = np.random.default_rng(2).uniform(-0.5, 2.0, len(depth)).astype(np.float32)
    gj = jprior.prior_from_points(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(valid),
                                  JCAM.height, JCAM.width, block=16, weights=jnp.asarray(w))
    gt = depth_prior.prior_from_points(_t(uv), _t(depth), _t(valid), CAM.height, CAM.width,
                                       block=16, weights=_t(w))
    _same_grid(gj, gt)


def test_prior_from_points_repeats_bit_for_bit():
    uv, depth, valid = _sparse_points(3)
    a = depth_prior.prior_from_points(_t(uv), _t(depth), _t(valid), 120, 160, block=16)
    b = depth_prior.prior_from_points(_t(uv), _t(depth), _t(valid), 120, 160, block=16)
    assert torch.equal(a.inv_depth, b.inv_depth) and torch.equal(a.weight, b.weight)


@pytest.mark.parametrize("n", [400, 12, 0])
def test_fill_prior_matches_jax(n):
    """Dense, sparse (holes filled by neighbours, then the median) and empty
    (stays zero) grids."""
    gj, gt = _grids(seed=4, n=max(n, 1))
    if n == 0:
        gj = gj._replace(weight=gj.weight * 0, inv_depth=gj.inv_depth * 0)
        gt = gt._replace(weight=gt.weight * 0, inv_depth=gt.inv_depth * 0)
    _same_grid(jprior.fill_prior(gj), depth_prior.fill_prior(gt))


def test_gauge_ratio_matches_jax():
    gj, gt = _grids(seed=5)
    rj, rt = _grids(seed=6)
    rj = rj._replace(inv_depth=rj.inv_depth * 1.3)
    rt = rt._replace(inv_depth=rt.inv_depth * 1.3)
    np.testing.assert_allclose(float(depth_prior.gauge_ratio(gt, rt)),
                               float(jprior.gauge_ratio(gj, rj)), rtol=1e-6)
    empty = rt._replace(weight=rt.weight * 0)
    assert float(depth_prior.gauge_ratio(gt, empty)) == 1.0


@pytest.mark.parametrize("shrink", [1.0, 0.25])
def test_sample_prior_matches_jax(shrink):
    gj, gt = _grids(seed=7)
    gj, gt = jprior.fill_prior(gj), depth_prior.fill_prior(gt)
    gt = depth_prior_from_numpy(gj, device="cpu")            # identical grids
    uv = _sparse_points(8, 300)[0]
    dj = jprior.sample_prior(gj, jnp.asarray(uv), 2.5, shrink=shrink)
    dt = depth_prior.sample_prior(gt, _t(uv), 2.5, shrink=shrink)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("shrink", [1.0, 0.25])
def test_sample_prior_checked_matches_jax(shrink):
    gj, _ = _grids(seed=9, n=150)
    gj = jprior.fill_prior(gj)
    gt = depth_prior_from_numpy(gj, device="cpu")
    uv = _sparse_points(10, 300)[0]
    dj, okj = jprior.sample_prior_checked(gj, jnp.asarray(uv), 2.5, max_edge_ratio=1.3,
                                          shrink=shrink)
    dt, okt = depth_prior.sample_prior_checked(gt, _t(uv), 2.5, max_edge_ratio=1.3,
                                               shrink=shrink)
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    assert 0 < int(okt.sum()) < len(uv)                      # both branches taken
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    # The port's reads take batched pixels as they come from the selection.
    db, okb = depth_prior.sample_prior_checked(gt, _t(uv)[None], 2.5, max_edge_ratio=1.3,
                                               shrink=shrink)
    assert torch.equal(db[0], dt) and torch.equal(okb[0], okt)


def test_propagate_prior_matches_jax():
    gj, _ = _grids(seed=11)
    gj = jprior.fill_prior(gj)
    gt = depth_prior_from_numpy(gj, device="cpu")
    T = np.asarray(jse3.exp(jnp.asarray(XI)))
    pj = jprior.propagate_prior(gj, jnp.asarray(T), JCAM)
    pt = depth_prior.propagate_prior(gt, _t(T), CAM)
    _same_grid(pj, pt)
    assert float(pt.weight.max()) <= 2.0                     # decayed support


def _matches(seed=12, n=256):
    """Exact matches of scene points seen from two poses, with pixel noise."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(1.5, 4.0, n)], axis=-1).astype(np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(XI * 2)))
    Pb = P @ T[:3, :3].T + T[:3, 3]

    def proj(X):
        return np.stack([JCAM.fx * X[:, 0] / X[:, 2] + JCAM.cx,
                         JCAM.fy * X[:, 1] / X[:, 2] + JCAM.cy], axis=-1).astype(np.float32)

    uv_a = proj(P)
    uv_b = proj(Pb) + 0.1 * rng.standard_normal((n, 2)).astype(np.float32)
    uv_b[:16] += 9.0                                          # gross mismatches
    valid = rng.uniform(size=n) > 0.1
    return T, uv_a, uv_b, valid, P[:, 2], Pb[:, 2]


def test_triangulate_matches_matches_jax():
    T, uv_a, uv_b, valid, z_a, z_b = _matches()
    with jax_accelerator_branch():
        tj = jprior.triangulate_matches(JCAM, jnp.asarray(T), jnp.asarray(uv_a),
                                        jnp.asarray(uv_b), jnp.asarray(valid))
    tt = depth_prior.triangulate_matches(CAM, _t(T), _t(uv_a), _t(uv_b), _t(valid))
    gj, gt = np.asarray(tj.good), tt.good.numpy()
    assert (gj != gt).sum() <= 2                             # points on a gate may flip
    both = gj & gt
    assert both.sum() > 150 and not gt[:16].any()
    np.testing.assert_allclose(tt.depth_a.numpy()[both], np.asarray(tj.depth_a)[both], rtol=2e-4)
    np.testing.assert_allclose(tt.depth_b.numpy()[both], np.asarray(tj.depth_b)[both], rtol=2e-4)
    np.testing.assert_allclose(tt.depth_b.numpy()[both], z_b[both], rtol=0.15)   # 0.1 px noise


def test_triangulate_matches_agrees_with_jax_homogeneous_dlt():
    """Against the JAX package's CPU branch (the 4x4 eigenvector by LAPACK),
    an independent form of the same triangulation: same gates but for
    points on one, depths to 5e-3 relative."""
    T, uv_a, uv_b, valid, _, _ = _matches(seed=13)
    tj = jprior.triangulate_matches(JCAM, jnp.asarray(T), jnp.asarray(uv_a), jnp.asarray(uv_b),
                                    jnp.asarray(valid))
    tt = depth_prior.triangulate_matches(CAM, _t(T), _t(uv_a), _t(uv_b), _t(valid))
    gj, gt = np.asarray(tj.good), tt.good.numpy()
    both = gj & gt
    assert (gj != gt).sum() <= 2 and both.sum() > 150
    np.testing.assert_allclose(tt.depth_b.numpy()[both], np.asarray(tj.depth_b)[both], rtol=5e-3)


@pytest.fixture(scope="module")
def tracked_pair():
    """Two views of the multi-plane scene (JAX pyramids), the points selected
    on the first at the scene's exact depths times 1.15, and the true
    relative pose."""
    T = jse3.exp(jnp.asarray(XI))
    pa = jbuild_pyramid(jsyn.render_scene_view(JCAM, jnp.eye(4)), levels=3)
    pb = jbuild_pyramid(jsyn.render_scene_view(JCAM, T), levels=3)
    depth = jsyn.scene_depth(JCAM, jnp.eye(4))
    pts = jpoints.topk_gradient_points(pa.images[0], pa.grad_mag[0], JCAM, num_points=512,
                                       mono_z=2.5, block=4)
    u = np.asarray(pts.uv[:, 0]).astype(int)
    v = np.asarray(pts.uv[:, 1]).astype(int)
    z = np.asarray(depth)[v, u] * 1.15
    pts = pts._replace(p3d=JCAM.unproject(pts.uv, jnp.asarray(z)))
    return T, pb, pts, np.asarray(depth)[v, u]


def _port_points(pts):
    """The JAX package's (N, ...) points as the port's batch of one."""
    class One:
        uv, p3d = np.asarray(pts.uv)[None], np.asarray(pts.p3d)[None]
        intensity, valid = np.asarray(pts.intensity)[None], np.asarray(pts.valid)[None]
        gx0 = gy0 = None
    return points_from_numpy(One, device="cpu")


@pytest.mark.parametrize("ab", [None, (0.02, -1.5)], ids=["plain", "affine"])
def test_refine_inverse_depth_matches_jax(tracked_pair, ab):
    T, pb, pts, z_true = tracked_pair
    abj = None if ab is None else jnp.asarray(ab, jnp.float32)
    rj = jrefine.refine_inverse_depth(pts, T, pb.images[0], pb.grad_x[0], pb.grad_y[0], JCAM,
                                      ab=abj)
    img, gx, gy = (_t(np.asarray(x))[None] for x in (pb.images[0], pb.grad_x[0], pb.grad_y[0]))
    rt = depth_refine.refine_inverse_depth(
        _port_points(pts), _t(np.asarray(T)), img, gx, gy, CAM,
        ab=None if ab is None else _t(ab, np.float32),
    )
    assert rt.inv_depth.shape == (1, 512)
    np.testing.assert_allclose(rt.inv_depth[0].numpy(), np.asarray(rj.inv_depth), atol=1e-3)
    assert int((rt.good[0].numpy() != np.asarray(rj.good)).sum()) <= 3
    np.testing.assert_allclose(rt.slope[0].numpy(), np.asarray(rj.slope), rtol=3e-2, atol=0.2)
    if ab is None:
        good = rt.good[0].numpy()
        assert good.sum() > 100
        # The refinement pulls the 15% depth error in: median error under 5%.
        err = np.abs(1.0 / rt.inv_depth[0].numpy()[good] / z_true[good] - 1.0)
        assert np.median(err) < 0.05


def test_transfer_depths_matches_jax(tracked_pair):
    T, pb, pts, _ = tracked_pair
    rho = 1.0 / np.maximum(np.asarray(pts.p3d[:, 2]), 1e-6)
    good = np.asarray(pts.valid)
    uj, zj, okj = jrefine.transfer_depths(pts, jnp.asarray(rho), jnp.asarray(good), T, JCAM)
    ut, zt, okt = depth_refine.transfer_depths(_port_points(pts), _t(rho)[None], _t(good)[None],
                                               _t(np.asarray(T)), CAM)
    np.testing.assert_allclose(ut[0].numpy(), np.asarray(uj), atol=2e-4)
    np.testing.assert_allclose(zt[0].numpy(), np.asarray(zj), rtol=1e-6)
    assert np.array_equal(okt[0].numpy(), np.asarray(okj))


def test_masked_median_keeps_the_lower_element():
    x = _t([4.0, 1.0, 3.0, 2.0, 9.0])
    assert float(depth_prior._masked_median(x, _t([True, True, True, True, False]))) == 2.0
    assert float(depth_prior._masked_median(x, _t([False] * 5))) == 1.0
    xj = jnp.asarray(x.numpy())
    assert float(jprior._masked_median(xj, jnp.asarray([True, True, True, True, False]))) == 2.0
