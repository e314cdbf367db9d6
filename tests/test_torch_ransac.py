"""Parity of the port's two-view geometry (`features.ransac`,
`features.geometry`, and the fused small-matrix forms of `utils.linalg`
under them) with the JAX package, both on the SAME branch and both solvers
fed the SAME minimal samples.

The branch: the JAX package runs LAPACK's eigh and svd and the homogeneous
DLT when its backend is the CPU, and fused forms (inverse subspace
iteration, cyclic Jacobi, the inhomogeneous DLT) on an accelerator. The
port runs the fused forms on every device, because the card runs them
inside a captured graph. So every test of this file puts the JAX package
on its accelerator branch (`jax_accelerator_branch`, nothing in the package
changes), and what is held to JAX here is what the card runs.

The samples: the JAX package draws its uniforms from
`jax.random.uniform(key, (H, K), 1e-9, 1)` inside the solver, the test draws
the same table from the same key and hands it to the port.

Tolerances: the small-matrix forms to a few ulp, signs included (the same
operations in the same order: eigenvalues 5e-6, Jacobi vectors 5e-6, the
9x9 null vector 2e-4 after eight solves). F and E compared up to scale and
sign (normalized to unit Frobenius norm, sign fixed by the largest entry)
atol 2e-3 for F (a RANSAC winner refit by three IRLS steps of eigen-solves
in f32) and 1e-2 for E (a Gauss-Newton polish from 38 starts); inlier masks
equal; recovered rotation atol 1e-4, triangulated points rtol 5e-4 (2e-3
at the 30 m depths a unit baseline gives `recover_pose`).

A minimal 8-point solve is the null vector of a 9x9 matrix of rank 8, in
f32: the two packages' hypotheses score within about 1% of each other, not
to the last bit. Where two of the eight refit chains end nearly tied in
MSAC score the packages may crown different ones, and which one rests on
the host's XLA build (seed 0 below: F differs by 3e-2 under AVX-512 and
AVX2, by 1e-5 under AVX and SSE4_2; seed 1 differs under all four). Where
the winner is the same, the inlier masks must be equal; a near tie is held
by score and by the true matches each package's mask keeps instead.
"""
import contextlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.features import geometry as jgeom  # noqa: E402
from uwslam_tpu.features import ransac as jransac  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.utils import linalg as jlinalg  # noqa: E402
from uwslam_tpu_torch.features import geometry, ransac  # noqa: E402
from uwslam_tpu_torch.utils import linalg  # noqa: E402



@contextlib.contextmanager
def jax_accelerator_branch():
    """The JAX package's two-view geometry on its accelerator branch, which
    is the one the port implements: `utils.linalg._on_cpu` answers False
    (inverse subspace iteration, Jacobi eigh and svd), and
    `features.geometry.triangulate_linear`, which asks
    `jax.default_backend()` itself, is told "tpu" (the inhomogeneous DLT).
    Every other caller of `jax.default_backend` gets the true answer, so
    sampling and the Pallas switches stay on their CPU forms. The branch is
    chosen when a function is traced, so the compilation caches are dropped
    on the way in and on the way out."""
    true_backend = jax.default_backend
    geometry_file = os.path.join("features", "geometry.py")

    def backend():
        caller = sys._getframe(1).f_code.co_filename
        return "tpu" if caller.endswith(geometry_file) else true_backend()

    mp = pytest.MonkeyPatch()
    mp.setattr(jlinalg, "_on_cpu", lambda: False)
    mp.setattr(jax, "default_backend", backend)
    jax.clear_caches()
    try:
        yield
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _jax_on_the_ports_branch():
    with jax_accelerator_branch():
        yield


F_PX = 260.0
C = np.array([159.5, 119.5], np.float32)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _scene(seed=0, n=200, outliers=40, noise=0.2):
    """Matches (pixels) of points at 1.5 to 5 m seen from two poses; the last
    `outliers` are wrong, some slots are invalid."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                  rng.uniform(1.5, 5.0, n)], axis=-1).astype(np.float32)
    T = np.asarray(jse3.exp(jnp.asarray([0.12, 0.03, 0.02, 0.01, 0.03, 0.01], jnp.float32)))
    Pb = P @ T[:3, :3].T + T[:3, 3]
    uv_a = (F_PX * P[:, :2] / P[:, 2:] + C).astype(np.float32)
    uv_b = (F_PX * Pb[:, :2] / Pb[:, 2:] + C).astype(np.float32)
    uv_b += noise * rng.standard_normal(uv_b.shape).astype(np.float32)
    uv_b[n - outliers:] += rng.uniform(8, 40, (outliers, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::17] = False
    return T, uv_a, uv_b, valid


def _uniforms(seed, H, K):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (H, K), minval=1e-9, maxval=1.0))


def _canonical(F):
    """Unit Frobenius norm, the largest entry positive."""
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.abs(F).argmax()])


def test_sample_minimal_matches_jax_top_k():
    _, _, _, valid = _scene()
    u = _uniforms(3, 64, len(valid))
    gumbel = -jnp.log(-jnp.log(jnp.asarray(u)))
    _, idx_j = jax.lax.top_k(jnp.where(jnp.asarray(valid)[None, :], gumbel, -jnp.inf), 8)
    idx_t = ransac.sample_minimal(_t(u), _t(valid))
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert valid[idx_t.numpy()].all()


def test_draw_uniforms_is_seeded_and_in_range():
    a = ransac.draw_uniforms(50, 16, torch.Generator().manual_seed(5))
    b = ransac.draw_uniforms(50, 16, torch.Generator().manual_seed(5))
    c = ransac.draw_uniforms(50, 16, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (16, 50) and float(a.min()) >= 1e-9 and float(a.max()) < 1.0


def test_sampson_distance_matches_jax():
    T, uv_a, uv_b, _ = _scene(1)
    F = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)
    dj = jransac.sampson_distance(jnp.asarray(F), jnp.asarray(uv_a), jnp.asarray(uv_b))
    dt = ransac.sampson_distance(_t(F), _t(uv_a), _t(uv_b))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2e-4, atol=1e-6)
    batch = ransac.sampson_distance(_t(F)[None].repeat(3, 1, 1), _t(uv_a), _t(uv_b))
    assert torch.equal(batch[1], dt)


def test_normalize_points_matches_jax():
    _, uv_a, _, valid = _scene(2)
    pj, Tj = jransac._normalize_points(jnp.asarray(uv_a), jnp.asarray(valid))
    pt, Tt = ransac._normalize_points(_t(uv_a), _t(valid))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-5, atol=1e-6)


def test_eight_point_matches_jax_up_to_sign():
    _, uv_a, uv_b, valid = _scene(3, outliers=0, noise=0.0)
    pa, _ = jransac._normalize_points(jnp.asarray(uv_a), jnp.asarray(valid))
    pb, _ = jransac._normalize_points(jnp.asarray(uv_b), jnp.asarray(valid))
    w = valid.astype(np.float32)
    Fj = jransac._eight_point(pa, pb, jnp.asarray(w))
    Ft = ransac._eight_point(_t(np.asarray(pa)), _t(np.asarray(pb)), _t(w))
    np.testing.assert_allclose(_canonical(Ft.numpy()), _canonical(Fj), atol=1e-3)
    assert abs(float(torch.linalg.det(Ft.double()))) < 1e-6          # rank 2


def _both_fundamental(seed, noise=0.05, H=64):
    T, uv_a, uv_b, valid = _scene(seed, noise=noise)
    rj = jransac.fundamental_ransac(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(valid),
                                    jax.random.PRNGKey(seed), num_hypotheses=H)
    rt = ransac.fundamental_ransac(_t(uv_a), _t(uv_b), _t(valid), _t(_uniforms(seed, H, len(valid))))
    return rj, rt, (uv_a, uv_b, valid)


def _msac(F, uv_a, uv_b, valid, t2=9.0):
    d = ransac.sampson_distance(_t(np.asarray(F, np.float32)), _t(uv_a), _t(uv_b)).numpy()
    return float(np.where(valid, np.minimum(d, t2), 0.0).sum())


def _explains_the_matches(inliers, valid):
    """The true matches are in; a wrong match stays out unless it happens to
    lie along its epipolar line (Sampson distance cannot see that)."""
    inl = np.asarray(inliers)
    return bool(inl[:160][valid[:160]].all()) and float(inl[160:].mean()) < 0.3


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fundamental_ransac_matches_jax(seed):
    rj, rt, (uv_a, uv_b, valid) = _both_fundamental(seed)
    flips = int((rt.inliers.numpy() != np.asarray(rj.inliers)).sum())
    gap = np.abs(_canonical(rt.F.numpy()) - _canonical(rj.F)).max()
    if gap <= 2e-3:
        # The packages crowned the same refit chain (seed 3 on every host
        # measured, F within 7e-4): the inlier masks must be equal.
        assert flips == 0 and int(rt.num_inliers) == int(rj.num_inliers)
    else:
        # A near tie (see the module's docstring). Which chain wins rests on
        # the host's XLA build: measured under the default ISA (AVX-512),
        # AVX2, AVX and SSE4_2, seed 1 crowns another chain than the port's
        # on all four (MSAC 329.44 against 328.48, 0.3% apart; the masks
        # differ in 9 wrong matches) and seed 2 crosses F's 2e-3 on some.
        # Two models of one scene are held by what they explain, not by
        # which wrong matches happen to fit both: equal MSAC scores within
        # 2%, and each package's mask has every true match and few wrong.
        sj, st = _msac(rj.F, uv_a, uv_b, valid), _msac(rt.F, uv_a, uv_b, valid)
        assert abs(sj - st) <= 0.02 * sj
        assert _explains_the_matches(rj.inliers, valid)
    assert bool(rt.ok) == bool(rj.ok)
    assert _explains_the_matches(rt.inliers, valid)


def test_fundamental_ransac_near_tie_is_held_by_score():
    """Seed 0: two refit chains end within 1% in MSAC score and, on some
    hosts' XLA builds, the packages crown different ones (2 flips of the
    mask under AVX-512 and AVX2, none under AVX and SSE4_2). Both models
    explain the matches equally well."""
    rj, rt, (uv_a, uv_b, valid) = _both_fundamental(0)
    sj, st = _msac(rj.F, uv_a, uv_b, valid), _msac(rt.F, uv_a, uv_b, valid)
    assert abs(sj - st) <= 0.02 * sj
    assert _explains_the_matches(rj.inliers, valid)
    assert _explains_the_matches(rt.inliers, valid)


@pytest.mark.parametrize("seed", [0, 1])
def test_essential_ransac_matches_jax(seed):
    T, uv_a, uv_b, valid = _scene(seed, noise=0.1)
    xy_a, xy_b = (uv_a - C) / F_PX, (uv_b - C) / F_PX
    H = 64
    kw = dict(threshold_norm=2.0 / F_PX)
    rj = jransac.essential_ransac(jnp.asarray(xy_a), jnp.asarray(xy_b), jnp.asarray(valid),
                                  jax.random.PRNGKey(seed), num_hypotheses=H, **kw)
    rt = ransac.essential_ransac(_t(xy_a), _t(xy_b), _t(valid),
                                 _t(_uniforms(seed, H, len(valid))), **kw)
    # The winner comes out of a Gauss-Newton polish from 38 starts, several of
    # which end in the same basin a few 1e-3 apart (2.6e-3 on this host): E to
    # 1e-2 of its unit norm, and a match within that of the threshold may flip.
    assert int((rt.inliers.numpy() != np.asarray(rj.inliers)).sum()) <= 1
    np.testing.assert_allclose(_canonical(rt.F.numpy()), _canonical(rj.F), atol=1e-2)
    # Both recover the true motion: R to 2e-3, the direction of t to 0.05.
    for res_F, res_inl, mod in ((rt.F, rt.inliers, "t"), (rj.F, rj.inliers, "j")):
        if mod == "t":
            rec = geometry.recover_pose(res_F, _t(xy_a), _t(xy_b), _t(valid) & res_inl)
            Tr = rec.T.numpy()
        else:
            rec = jgeom.recover_pose(res_F, jnp.asarray(xy_a), jnp.asarray(xy_b),
                                     jnp.asarray(valid) & res_inl)
            Tr = np.asarray(rec.T)
        np.testing.assert_allclose(Tr[:3, :3], T[:3, :3], atol=5e-3)
        t_true = T[:3, 3] / np.linalg.norm(T[:3, 3])
        assert float(Tr[:3, 3] @ t_true) > 0.99


def test_recover_pose_matches_jax():
    T, uv_a, uv_b, valid = _scene(4, outliers=0, noise=0.0)
    xy_a, xy_b = (uv_a - C) / F_PX, (uv_b - C) / F_PX
    t = T[:3, 3] / np.linalg.norm(T[:3, 3])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = (tx @ T[:3, :3]).astype(np.float32)
    rj = jgeom.recover_pose(jnp.asarray(E), jnp.asarray(xy_a), jnp.asarray(xy_b), jnp.asarray(valid))
    rt = geometry.recover_pose(_t(E), _t(xy_a), _t(xy_b), _t(valid))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    np.testing.assert_allclose(rt.T.numpy()[:3, :3], T[:3, :3], atol=1e-4)
    assert np.array_equal(rt.cheirality.numpy(), np.asarray(rj.cheirality))
    assert int(rt.num_good) == int(rj.num_good) == int(valid.sum())
    np.testing.assert_allclose(rt.points.numpy()[valid], np.asarray(rj.points)[valid], rtol=2e-3,
                               atol=1e-4)    # a lateral coordinate may be ~0 at 30 m depth


def test_recover_pose_ignores_the_sign_of_e():
    T, uv_a, uv_b, valid = _scene(5, outliers=0, noise=0.0)
    xy_a, xy_b = (uv_a - C) / F_PX, (uv_b - C) / F_PX
    t = T[:3, 3] / np.linalg.norm(T[:3, 3])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = _t((tx @ T[:3, :3]).astype(np.float32))
    a = geometry.recover_pose(E, _t(xy_a), _t(xy_b), _t(valid))
    b = geometry.recover_pose(-E, _t(xy_a), _t(xy_b), _t(valid))
    np.testing.assert_allclose(a.T.numpy(), b.T.numpy(), atol=1e-5)


def test_triangulate_linear_matches_jax():
    T, uv_a, uv_b, _ = _scene(6, outliers=0, noise=0.0)
    xy_a, xy_b = (uv_a - C) / F_PX, (uv_b - C) / F_PX
    Xj = jgeom.triangulate_linear(jnp.eye(4), jnp.asarray(T), jnp.asarray(xy_a), jnp.asarray(xy_b))
    Xt = geometry.triangulate_linear(torch.eye(4), _t(T), _t(xy_a), _t(xy_b))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=5e-4, atol=1e-5)


def test_decompose_essential_gives_the_four_candidates():
    T, *_ = _scene(7)
    t = T[:3, 3] / np.linalg.norm(T[:3, 3])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    cands = geometry.decompose_essential(_t((tx @ T[:3, :3]).astype(np.float32)))
    assert len(cands) == 4
    for R, tc in cands:
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-4 and abs(float(tc.norm()) - 1.0) < 1e-5
    assert min(float((R - _t(T[:3, :3])).abs().max()) for R, _ in cands) < 1e-4


# ------------------------------------------------------ the fused forms

def _spd_with_spectrum(rng, n, spectrum, batch=32):
    Q = np.linalg.qr(rng.standard_normal((batch, n, n)))[0]
    A = (Q * np.asarray(spectrum)) @ Q.transpose(0, 2, 1)
    return _t(A.astype(np.float32)), _t(Q[..., 0].astype(np.float32))


@pytest.mark.parametrize("n,spectrum,tol", [
    (9, [0.0] + list(np.linspace(0.5, 4.0, 8)), 1e-3),          # a minimal 8-point system
    # Two tiny eigenvalues: f32 determines the vector to eps |A| / gap ~ 2.4e-3.
    (9, [1e-6, 1e-4] + list(np.linspace(0.5, 4.0, 7)), 1e-2),
    (4, [1e-5, 2e-3, 1.0, 2.0], 1e-3),                          # a low-parallax DLT
], ids=["rank8", "two-small", "dlt4"])
def test_subspace_iteration_matches_eigh(n, spectrum, tol):
    """In the regimes the front end meets: a null vector beside a well
    separated rest, and two tiny eigenvalues (where single-vector inverse
    iteration stalls and the Rayleigh-Ritz step must separate them).
    Against the constructed eigenvector and torch.linalg.eigh."""
    A, v_true = _spd_with_spectrum(np.random.default_rng(n), n, spectrum)
    v = linalg.smallest_eigvec_subspace(A)
    v_lapack = linalg.smallest_eigvec_spd(A)
    for ref in (v_true, v_lapack):
        err = torch.minimum((v - ref).abs().amax(-1), (v + ref).abs().amax(-1))
        assert float(err.max()) < tol
    np.testing.assert_allclose(v.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_subspace_iteration_matches_jax_fused_form():
    """The normal matrix of eight random rows (a minimal 8-point system) and
    a 4x4 low-parallax DLT: the same vector, sign included."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((64, 8, 9)).astype(np.float32)
    A9 = rows.transpose(0, 2, 1) @ rows
    A4, _ = _spd_with_spectrum(rng, 4, [1e-5, 2e-3, 1.0, 2.0], batch=64)
    for A, tol in ((A9, 2e-4), (A4.numpy(), 2e-4)):
        vj = np.asarray(jlinalg.smallest_eigvec_spd(jnp.asarray(A)))
        vt = linalg.smallest_eigvec_subspace(_t(A)).numpy()
        np.testing.assert_allclose(vt, vj, atol=tol)


def test_jacobi_eigh_and_svd_match_jax_fused_forms():
    """Same rotations in the same order: values and vectors to a few ulp,
    signs and the order of the columns included."""
    rng = np.random.default_rng(12)
    F = rng.standard_normal((64, 3, 3)).astype(np.float32)
    F[:8] = F[:8] - (F[:8] @ F[:8, :, :1]) @ F[:8, :, :1].transpose(0, 2, 1) / (
        F[:8, :, :1] ** 2).sum(1, keepdims=True)                # rank 2
    S = F + F.transpose(0, 2, 1)
    wj, Vj = jlinalg.sym3_eigh(jnp.asarray(S))
    wt, Vt = linalg.sym3_eigh_jacobi(_t(S))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=5e-6)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=5e-6)
    Uj, sj, Vtj = jlinalg.svd3(jnp.asarray(F))
    Ut, st, Vtt = linalg.svd3_jacobi(_t(F))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-6)
    np.testing.assert_allclose(Vtt.numpy(), np.asarray(Vtj), atol=2e-5)
    np.testing.assert_allclose(Ut.numpy()[..., :2], np.asarray(Uj)[..., :2], atol=2e-5)
    # U's third column takes its sign from F v_2, which is rounding noise
    # where the rank is 2 (the callers make U proper themselves).
    np.testing.assert_allclose(Ut.numpy()[8:, :, 2], np.asarray(Uj)[8:, :, 2], atol=2e-5)
    np.testing.assert_allclose(np.abs(Ut.numpy()[:8, :, 2]), np.abs(np.asarray(Uj)[:8, :, 2]),
                               atol=2e-5)


def test_jax_package_is_on_its_accelerator_branch(monkeypatch):
    """What this file's parity rests on: under `jax_accelerator_branch` the
    JAX package's eigh, null vector, svd and triangulation never reach
    LAPACK, while every other caller of `jax.default_backend` is told the
    truth."""
    def no_lapack(*args, **kwargs):
        raise AssertionError("the JAX package took its CPU branch")

    monkeypatch.setattr(jnp.linalg, "eigh", no_lapack)
    monkeypatch.setattr(jnp.linalg, "svd", no_lapack)
    assert jax.default_backend() == "cpu" and not jlinalg._on_cpu()
    S = jnp.asarray([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]], jnp.float32)
    jlinalg.sym3_eigh(S)
    jlinalg.svd3(S)
    jlinalg.smallest_eigvec_spd(S)
    T, uv_a, uv_b, valid = _scene(8, n=40, outliers=0, noise=0.0)
    xy_a, xy_b = jnp.asarray((uv_a - C) / F_PX), jnp.asarray((uv_b - C) / F_PX)
    jgeom.triangulate_linear(jnp.eye(4), jnp.asarray(T), xy_a, xy_b)
    # A new number of matches: traced now, not taken from a cache.
    res = jransac.fundamental_ransac(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(valid),
                                     jax.random.PRNGKey(0), num_hypotheses=16)
    assert bool(res.ok)


def test_jacobi_eigh_and_svd_match_torch_linalg():
    rng = np.random.default_rng(11)
    F = _t(rng.standard_normal((64, 3, 3)).astype(np.float32))
    S = F + F.transpose(-1, -2)
    w, V = linalg.sym3_eigh_jacobi(S)
    np.testing.assert_allclose(w.numpy(), torch.linalg.eigvalsh(S).numpy(), atol=2e-5)
    np.testing.assert_allclose((V * w[..., None, :] @ V.transpose(-1, -2)).numpy(), S.numpy(), atol=2e-5)
    U, s, Vt = linalg.svd3_jacobi(F)
    np.testing.assert_allclose(s.numpy(), torch.linalg.svdvals(F).numpy(), atol=2e-5)
    np.testing.assert_allclose((U * s[..., None, :] @ Vt).numpy(), F.numpy(), atol=2e-5)
    # Rank 2 (an essential matrix): U and V stay orthonormal.
    E = F.clone()
    E = E - (E @ Vt[..., 2, :, None]) * Vt[..., 2, None, :]
    U2, s2, Vt2 = linalg.svd3_jacobi(E)
    assert float(s2[:, 2].max()) < 1e-5
    eye = torch.eye(3).expand(64, 3, 3)
    np.testing.assert_allclose((U2.transpose(-1, -2) @ U2).numpy(), eye.numpy(), atol=1e-4)
    np.testing.assert_allclose((U2 * s2[..., None, :] @ Vt2).numpy(), E.numpy(), atol=2e-5)


def test_essential_ransac_recovers_the_motion():
    T, uv_a, uv_b, valid = _scene(3, noise=0.1)
    xy_a, xy_b = _t((uv_a - C) / F_PX), _t((uv_b - C) / F_PX)
    u = ransac.draw_uniforms(len(valid), 64, torch.Generator().manual_seed(3))
    res = ransac.essential_ransac(xy_a, xy_b, _t(valid), u, threshold_norm=2.0 / F_PX)
    rec = geometry.recover_pose(res.F, xy_a, xy_b, _t(valid) & res.inliers)
    assert bool(res.ok) and int(rec.num_good) > 0.9 * int(res.num_inliers)
    np.testing.assert_allclose(rec.T.numpy()[:3, :3], T[:3, :3], atol=5e-3)
    assert float(rec.T.numpy()[:3, 3] @ (T[:3, 3] / np.linalg.norm(T[:3, 3]))) > 0.99
