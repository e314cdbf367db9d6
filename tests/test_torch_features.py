"""Parity of the port's relocalization front end (`features.detect`,
`describe`, `match_descriptors`, PnP and the small-matrix linalg) with the
JAX package's CPU branch, on the same numpy inputs.

Tolerances: keypoints uv atol 1e-4 (subpixel parabolas divide by small
curvatures), levels and validity equal; descriptors atol 1e-5; matches
equal; PnP poses atol 1e-4 from the same minimal samples (JAX's Gumbel
indices computed here and handed to the port). Eigen- and singular vectors
are compared by sign-invariant quantities (LAPACK and torch may pick other
signs).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.features import descriptors as jdesc  # noqa: E402
from uwslam_tpu.features import detect as jdetect  # noqa: E402
from uwslam_tpu.features import match as jmatch  # noqa: E402
from uwslam_tpu.features import pnp as jpnp  # noqa: E402
from uwslam_tpu.image.pyramid import build_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.utils import linalg as jlinalg  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch.features import descriptors, detect, match, pnp  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax, descriptor_projection_from_numpy  # noqa: E402
from uwslam_tpu_torch.utils import linalg  # noqa: E402

# The tests run on the CPU, where the wrappers take their plain versions.
descriptor_projection_from_numpy = functools.partial(descriptor_projection_from_numpy, device="cpu")

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def two_views():
    """Pyramids (4 levels) of two nearby views of the textured plane, and the
    JAX package's keypoints and descriptors of each."""
    out = []
    for xi in ([0.0] * 6, [0.03, 0.01, 0.0, 0.0, 0.0, 0.01]):
        pyr = build_pyramid(render_plane_view(JCAM, jse3.exp(jnp.asarray(xi, jnp.float32)),
                                              2.0), levels=4)
        kps = jdetect.detect_multiscale(pyr.grad_x, pyr.grad_y, per_level=256, levels=3)
        desc = jdesc.describe(pyr.images, kps.uv, kps.level, kps.valid)
        out.append((pyr, kps, desc))
    return out


def test_box_blur_and_harris_match_jax_bit_for_bit(two_views):
    pyr = two_views[0][0]
    gx, gy = pyr.grad_x[0], pyr.grad_y[0]
    np.testing.assert_array_equal(
        detect._box_blur(_t(gx * gy)).numpy(), np.asarray(jdetect._box_blur(gx * gy)))
    np.testing.assert_array_equal(
        detect.harris_response(_t(gx), _t(gy)).numpy(),
        np.asarray(jdetect.harris_response(gx, gy)))
    resp = jdetect.harris_response(gx, gy)
    np.testing.assert_array_equal(detect.nms_maxpool(_t(resp)).numpy(),
                                  np.asarray(jdetect.nms_maxpool(resp)))


def test_scan_matches_xla_cumsum_beyond_two_block_levels():
    x = np.random.default_rng(0).uniform(0, 3e3, (3, 700)).astype(np.float32)
    np.testing.assert_array_equal(detect._cumsum(_t(x), -1).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


def test_detect_multiscale_matches_jax(two_views):
    for pyr, kps, _ in two_views:
        got = detect.detect_multiscale([_t(g) for g in pyr.grad_x],
                                       [_t(g) for g in pyr.grad_y], per_level=256, levels=3)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(kps.valid))
        np.testing.assert_array_equal(got.level.numpy(), np.asarray(kps.level))
        np.testing.assert_allclose(got.uv.numpy(), np.asarray(kps.uv), atol=1e-4)
        np.testing.assert_allclose(got.score.numpy(), np.asarray(kps.score), rtol=1e-4)
        assert int(got.valid.sum()) > 10


def test_in_order_cumsum_would_move_keypoints(two_views, monkeypatch):
    """Why `_box_blur` reproduces XLA's blocked scan: with `torch.cumsum`'s
    in-order sums the box-filtered structure tensor rounds differently, NMS
    and top-K pick other pixels, and keypoints move by whole pixels, far
    beyond the 1e-4 tolerance that the emulated scan keeps."""
    pyr, kps, _ = two_views[1]
    monkeypatch.setattr(detect, "_cumsum", lambda x, dim: torch.cumsum(x, dim))
    got = detect.detect_multiscale([_t(g) for g in pyr.grad_x],
                                   [_t(g) for g in pyr.grad_y], per_level=256, levels=3)
    assert np.abs(got.uv.numpy() - np.asarray(kps.uv)).max() > 0.5


def test_carried_projection_equals_jax():
    want = np.asarray(jdesc._projection_matrix(64, 64))
    np.testing.assert_array_equal(descriptors.projection_matrix().numpy(), want)
    np.testing.assert_array_equal(descriptor_projection_from_numpy(want).numpy(), want)


def test_describe_matches_jax(two_views):
    for pyr, kps, desc in two_views:
        proj = descriptor_projection_from_numpy(jdesc._projection_matrix(64, 64))
        got = descriptors.describe([_t(im) for im in pyr.images], _t(kps.uv),
                                   _t(kps.level), _t(kps.valid), proj=proj)
        np.testing.assert_allclose(got.numpy(), np.asarray(desc), atol=1e-5)


def test_match_descriptors_matches_jax(two_views):
    (_, ka, da), (_, kb, db) = two_views
    want = jmatch.match_descriptors(da, db, ka.valid, kb.valid)
    got = match.match_descriptors(_t(da), _t(db), _t(ka.valid), _t(kb.valid))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.idx_b.numpy()[v], np.asarray(want.idx_b)[v])
    assert v.sum() >= 10
    # Ties: duplicated descriptors make equal similarities; the lower index wins.
    dup = np.concatenate([np.asarray(db)[:1], np.asarray(db)])
    vb = np.concatenate([[True], np.asarray(kb.valid)])
    want = jmatch.match_descriptors(da, jnp.asarray(dup), ka.valid, jnp.asarray(vb))
    got = match.match_descriptors(_t(da), _t(dup), _t(ka.valid), _t(vb))
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(want.idx_b))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def _jax_sample_idx(valid, key, num_hypotheses=128):
    """The minimal samples JAX's pnp_ransac draws from `key`."""
    u = jax.random.uniform(key, (num_hypotheses, valid.shape[0]), minval=1e-9, maxval=1.0)
    scores = jnp.where(jnp.asarray(valid)[None, :], -jnp.log(-jnp.log(u)), -jnp.inf)
    return np.asarray(jax.lax.top_k(scores, 6)[1])


def _scene(seed, n, planar=False, noise=0.3 / 500.0, outliers=0):
    rng = np.random.default_rng(seed)
    hi = 2 if planar else 5
    P = rng.uniform([-1, -1, 2], [1, 1, hi], (n, 3)).astype(np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.2, -0.1, 0.05, 0.03, -0.02, 0.04])))
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    xy = pc[:, :2] / pc[:, 2:3] + rng.normal(0, noise, (n, 2))
    if outliers:
        xy[rng.choice(n, outliers, replace=False)] += rng.normal(0, 0.1, (outliers, 2))
    valid = np.ones(n, bool)
    valid[-3:] = False
    return P, xy.astype(np.float32), valid, T_true


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_ransac_matches_jax_with_the_same_samples(planar):
    P, xy, valid, _ = _scene(3, 80, planar=planar, outliers=15)
    key = jax.random.PRNGKey(7)
    want = jpnp.pnp_ransac(jnp.asarray(P), jnp.asarray(xy), jnp.asarray(valid), key,
                           threshold_norm=3.0 / 120.0)
    got = pnp.pnp_ransac(_t(P), _t(xy), _t(valid), _t(_jax_sample_idx(valid, key)),
                         threshold_norm=3.0 / 120.0)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert bool(got.ok) == bool(want.ok)


def test_pnp_components_match_jax():
    """The hypothesis solvers on 30-point noise-free samples, atol 1e-3: a
    6-point f32 DLT is ill-conditioned (A^T A squares the condition number;
    either package can lose a sample there, which RANSAC absorbs)."""
    P, xy, valid, _ = _scene(4, 40, noise=0.0)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(37)[:30] for _ in range(8)])
    w = np.ones(idx.shape, np.float32)
    T_dlt = jax.vmap(jpnp._dlt_pose)(jnp.asarray(P)[idx], jnp.asarray(xy)[idx], w)
    np.testing.assert_allclose(pnp._dlt_pose(_t(P)[idx], _t(xy)[idx], _t(w)).numpy(),
                               np.asarray(T_dlt), atol=1e-3)
    Pp, xyp, _, _ = _scene(5, 40, planar=True, noise=0.0)
    hp, hm = jax.vmap(jpnp._planar_poses)(jnp.asarray(Pp)[idx], jnp.asarray(xyp)[idx])
    gp, gm = pnp._planar_poses(_t(Pp)[idx], _t(xyp)[idx])
    # The homography's null vector has no fixed sign: the two candidates may
    # come out swapped, but each JAX candidate is one of the port's.
    for want in (np.asarray(hp), np.asarray(hm)):
        err = np.minimum(np.abs(gp.numpy() - want).max((1, 2)),
                         np.abs(gm.numpy() - want).max((1, 2)))
        assert err.max() < 1e-3
    T = np.asarray(jse3.exp(jnp.asarray([0.1, 0.0, 0.02, 0.01, 0.0, 0.02])))
    scale = np.asarray([120.0, 120.0], np.float32)
    d_want = jpnp._reproj_sq(jnp.asarray(T), jnp.asarray(P), jnp.asarray(xy), scale)
    np.testing.assert_allclose(pnp._reproj_sq(_t(T), _t(P), _t(xy), _t(scale)).numpy(),
                               np.asarray(d_want), rtol=1e-4)
    t2 = (3.0 / 120.0) ** 2
    Tw, sw = jpnp._gn_polish_pose(jnp.asarray(T), jnp.asarray(P), jnp.asarray(xy),
                                  jnp.asarray(valid), t2, jnp.asarray(scale))
    Tg, sg = pnp._gn_polish_pose(_t(T)[None], _t(P), _t(xy), _t(valid), t2, _t(scale))
    np.testing.assert_allclose(Tg[0].numpy(), np.asarray(Tw), atol=1e-4)
    np.testing.assert_allclose(float(sg[0]), float(sw), rtol=1e-3, atol=1e-6)


def _own_samples(valid, seed=0):
    return pnp.sample_hypotheses(_t(valid), 128, torch.Generator().manual_seed(seed))


def test_pnp_exact_recovery_with_outliers():
    """tests/test_reloc.py's first scene, with the port's own sampler."""
    rng = np.random.default_rng(1)
    P = rng.uniform([-1, -1, 2], [1, 1, 5], (100, 3)).astype(np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.2, -0.1, 0.05, 0.03, -0.02, 0.04])))
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    xy = pc[:, :2] / pc[:, 2:3]
    xy += rng.normal(0, 0.3 / 500.0, xy.shape)
    out_idx = rng.choice(100, 20, replace=False)
    xy[out_idx] += rng.normal(0, 0.1, (20, 2))
    valid = np.ones(100, bool)
    res = pnp.pnp_ransac(_t(P), _t(xy.astype(np.float32)), _t(valid), _own_samples(valid),
                         threshold_norm=2.0 / 500.0)
    T = res.T.numpy()
    assert bool(res.ok) and int(res.num_inliers) >= 75
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.01
    cos = (np.trace(T[:3, :3] @ T_true[:3, :3].T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2


def test_pnp_planar_scene():
    rng = np.random.default_rng(1)
    P = rng.uniform([-1, -1, 2], [1, 1, 2], (50, 3)).astype(np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray([0.08, 0.03, 0.0, 0.0, 0.0, 0.008])))
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    xy = (pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.3 / 120.0, (50, 2))).astype(np.float32)
    valid = np.ones(50, bool)
    res = pnp.pnp_ransac(_t(P), _t(xy), _t(valid), _own_samples(valid),
                         threshold_norm=3.0 / 120.0, min_inliers=12)
    assert bool(res.ok)
    assert np.linalg.norm(res.T.numpy()[:3, 3] - T_true[:3, 3]) < 0.02


def test_pnp_rejects_garbage():
    rng = np.random.default_rng(2)
    P = rng.uniform([-1, -1, 2], [1, 1, 5], (64, 3)).astype(np.float32)
    xy = rng.normal(0, 0.3, (64, 2)).astype(np.float32)
    valid = np.ones(64, bool)
    res = pnp.pnp_ransac(_t(P), _t(xy), _t(valid), _own_samples(valid),
                         threshold_norm=2.0 / 500.0, min_inliers=30)
    assert not bool(res.ok)


def test_sample_hypotheses_draws_distinct_valid_indices():
    valid = np.zeros(50, bool)
    valid[::3] = True
    idx = _own_samples(valid, seed=5).numpy()
    assert idx.shape == (128, 6)
    assert valid[idx].all()
    assert all(len(set(row)) == 6 for row in idx)
    np.testing.assert_array_equal(idx, _own_samples(valid, seed=5).numpy())


def test_pnp_from_pixels_matches_normalized_call():
    P, xy, valid, _ = _scene(6, 60)
    uv = xy * np.float32(120.0) + np.asarray([79.5, 59.5], np.float32)
    idx = _own_samples(valid)
    a = pnp.pnp_from_pixels(CAM, _t(P), _t(uv), _t(valid), idx, threshold_px=3.0)
    b = pnp.pnp_ransac(_t(P), (_t(uv) - torch.tensor([79.5, 59.5])) / 120.0, _t(valid), idx,
                       threshold_norm=3.0, axis_scale=(120.0, 120.0))
    np.testing.assert_allclose(a.T.numpy(), b.T.numpy(), atol=1e-6)


def _spd(seed, n, batch=6):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n + 2)).astype(np.float32)
    return M @ M.transpose(0, 2, 1)


@pytest.mark.parametrize("n", [3, 9, 12])
def test_smallest_eigvec_matches_jax_up_to_sign(n):
    A = _spd(n, n)
    want = np.asarray(jlinalg.smallest_eigvec_spd(jnp.asarray(A)))
    got = linalg.smallest_eigvec_spd(_t(A)).numpy()
    np.testing.assert_allclose(np.abs((got * want).sum(-1)), 1.0, atol=1e-4)


def test_sym3_eigh_and_svd3_match_jax_by_invariants():
    A = _spd(1, 3)
    w_want, _ = jlinalg.sym3_eigh(jnp.asarray(A))
    w, V = linalg.sym3_eigh(_t(A))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_want), rtol=1e-4, atol=1e-4)
    recon = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), A, rtol=1e-4, atol=1e-3)
    F = np.random.default_rng(2).normal(size=(6, 3, 3)).astype(np.float32)
    _, s_want, _ = jlinalg.svd3(jnp.asarray(F))
    U, s, Vt = linalg.svd3(_t(F))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((U @ torch.diag_embed(s) @ Vt).numpy(), F, atol=1e-5)


def test_cholesky_solve_unrolled_matches_jax():
    A = _spd(3, 6) + 1e-3 * np.eye(6, dtype=np.float32)
    b = np.random.default_rng(3).normal(size=(6, 6)).astype(np.float32)
    want = np.asarray(jlinalg.cholesky_solve_unrolled(jnp.asarray(A), jnp.asarray(b)))
    got = linalg.cholesky_solve_unrolled(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
