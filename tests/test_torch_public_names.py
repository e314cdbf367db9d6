"""Parity of the last public names of the JAX package that the port lacked:
`image.pyramid.build_depth_pyramid`, `lie.se3.adjoint` / `interpolate`,
`lie.so3.adjoint` / `interpolate`, `io.native.NativeLoader` and
`io.trajectory.ate_last_dropped`.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Tolerances: the depth pyramid is exact on integral depths (sums of up
to four integers and a division by 1-4 are exact or correctly rounded in
both) and within 1e-6 relative otherwise (the JAX reduction may sum a block
in another order); the Lie closed forms 1e-5 absolute, as
tests/test_torch_lie.py holds `exp` and `log`; the loader's stream and the
dropped count exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from uwslam_tpu.image import pyramid as jpyr  # noqa: E402
from uwslam_tpu.io import native as jnative, trajectory as jtraj  # noqa: E402
from uwslam_tpu.lie import se3 as jse3, so3 as jso3  # noqa: E402
from uwslam_tpu_torch.image import build_depth_pyramid  # noqa: E402
from uwslam_tpu_torch.io import native, trajectory  # noqa: E402
from uwslam_tpu_torch.lie import se3, so3  # noqa: E402


def _depths(integral: bool, seed: int) -> np.ndarray:
    """(48, 64) depths with holes: single zeros, whole 2x2 and 4x4 blocks of
    zeros (a coarse pixel with no valid depth), the rest in (0.3, 8) m or,
    integral, TUM's raw 16-bit units."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 40000, (48, 64)) if integral else rng.uniform(0.3, 8.0, (48, 64))
    d = d.astype(np.float32)
    d[rng.random((48, 64)) < 0.3] = 0.0
    d[8:10, 12:14] = 0.0
    d[16:20, 32:36] = 0.0
    d[:, -1] = 0.0
    return d


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("integral", [True, False])
def test_build_depth_pyramid_matches_jax(integral, levels):
    d = _depths(integral, seed=levels)
    want = jpyr.build_depth_pyramid(jnp.asarray(d), levels=levels)
    got = build_depth_pyramid(torch.from_numpy(d), levels=levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g > 0, w > 0)
        if integral:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    if levels > 1:   # a coarse pixel over a block with no valid depth is 0
        assert float(got[1][4, 6]) == 0.0


def test_build_depth_pyramid_takes_a_batch():
    d = np.stack([_depths(True, 7), _depths(False, 8)])
    batched = build_depth_pyramid(torch.from_numpy(d), levels=3)
    for b in range(2):
        for lvl, one in enumerate(build_depth_pyramid(torch.from_numpy(d[b]), levels=3)):
            assert torch.equal(batched[lvl][b], one)


def _twists(n: int, seed: int, scale: float) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, 6)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.0])
def test_se3_adjoint_matches_jax(scale):
    T = np.array(jse3.exp(jnp.asarray(_twists(32, 1, scale))))
    got = se3.adjoint(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.adjoint(jnp.asarray(T))), atol=1e-5)
    # Ad_T xi satisfies T exp(xi) T^-1 = exp(Ad_T xi).
    xi = torch.from_numpy(_twists(32, 2, 0.1))
    Tt = torch.from_numpy(T)
    lhs = se3.compose(se3.compose(Tt, se3.exp(xi)), se3.inverse(Tt))
    rhs = se3.exp(torch.einsum("nij,nj->ni", torch.from_numpy(got), xi))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4)


def test_so3_adjoint_is_the_rotation():
    R = np.array(jso3.exp(jnp.asarray(_twists(16, 3, 1.0)[:, 3:])))
    got = so3.adjoint(torch.from_numpy(R)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jso3.adjoint(jnp.asarray(R))))


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0, "per_pair"])
def test_se3_interpolate_matches_jax(t):
    Ta = np.array(jse3.exp(jnp.asarray(_twists(32, 4, 0.5))))
    Tb = np.array(jse3.exp(jnp.asarray(_twists(32, 5, 0.5))))
    tt = np.linspace(0.0, 1.0, 32).astype(np.float32) if t == "per_pair" else t
    want = np.asarray(jse3.interpolate(jnp.asarray(Ta), jnp.asarray(Tb), tt))
    got = se3.interpolate(torch.from_numpy(Ta), torch.from_numpy(Tb),
                          torch.from_numpy(tt) if t == "per_pair" else tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0, "per_pair"])
def test_so3_interpolate_matches_jax(t):
    Ra = np.array(jso3.exp(jnp.asarray(_twists(32, 6, 0.8)[:, 3:])))
    Rb = np.array(jso3.exp(jnp.asarray(_twists(32, 7, 0.8)[:, 3:])))
    tt = np.linspace(0.0, 1.0, 32).astype(np.float32) if t == "per_pair" else t
    want = np.asarray(jso3.interpolate(jnp.asarray(Ra), jnp.asarray(Rb), tt))
    got = so3.interpolate(torch.from_numpy(Ra), torch.from_numpy(Rb),
                          torch.from_numpy(tt) if t == "per_pair" else tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture
def native_library():
    if not native.available():
        pytest.skip("native/libuwslam_native.so does not load here (make -C native)")


@pytest.fixture
def png_paths(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        arr = rng.integers(0, 255, (32, 48), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i:04d}.png"))
        Image.fromarray(arr).save(paths[-1])
    return paths


@pytest.mark.parametrize("lookahead,threads,repeat", [(3, 2, 1), (8, 4, 4), (1, 1, 2)])
def test_native_loader_streams_what_decode_gives(native_library, png_paths, lookahead,
                                                 threads, repeat):
    paths = png_paths * repeat
    loader = native.NativeLoader(paths, lookahead=lookahead, threads=threads)
    got = list(loader)
    loader.close()
    assert [i for i, _ in got] == list(range(len(paths)))
    for i, img in got:
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, native.decode(paths[i]))
    if jnative.available():
        jl = jnative.NativeLoader(paths, lookahead=lookahead, threads=threads)
        want = list(jl)
        jl.close()
        assert [i for i, _ in want] == [i for i, _ in got]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_native_loader_reports_a_missing_file(native_library, png_paths):
    loader = native.NativeLoader([png_paths[0], "/nonexistent/frame.png"], lookahead=2)
    it = iter(loader)
    assert next(it)[0] == 0
    with pytest.raises(IOError):
        next(it)
    loader.close()
    loader.close()            # closing twice is harmless


@pytest.mark.parametrize("bad", [0, 3, 7])
def test_ate_last_dropped_counts_like_jax(bad):
    rng = np.random.default_rng(bad)
    gt = rng.normal(size=(20, 3))
    est = gt * 1.5 + rng.normal(size=(20, 3)) * 0.01
    est[rng.choice(20, bad, replace=False)] = np.nan
    ate = trajectory.ate_rmse(est, gt)
    ate_j = jtraj.ate_rmse(est, gt)
    assert trajectory.ate_last_dropped == jtraj.ate_last_dropped == {"dropped": bad, "total": 20}
    assert ate == pytest.approx(ate_j, rel=1e-9)
