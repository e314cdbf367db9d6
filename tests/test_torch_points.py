"""Parity of the port's point selection, robust statistics and synthetic
scene with the JAX package (CPU).

Selection is exact: the same points, in the same order, ties included, with
the same intensity and gradient payloads. Robust statistics agree to f32
rounding of sums (1e-5 relative). The texture coefficients are the
jax.random draws, bit for bit; rendered frames agree to a few ulps of
[0, 255] (1e-3 absolute), since sin and the ray dot products round
differently.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image.pyramid import build_pyramid_batched as jax_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import points as jpoints, robust as jrobust  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch.image.pyramid import build_pyramid_batched  # noqa: E402
from uwslam_tpu_torch.interop import (  # noqa: E402
    camera_from_jax,
    points_from_numpy,
    pyramid_from_numpy,
    texture_from_numpy,
)
from uwslam_tpu_torch.tracking import points, robust  # noqa: E402
from uwslam_tpu_torch.utils import synthetic  # noqa: E402

# The tests run on the CPU, where the wrappers take their plain versions.
points_from_numpy = functools.partial(points_from_numpy, device="cpu")
pyramid_from_numpy = functools.partial(pyramid_from_numpy, device="cpu")

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)


def _frames(kind: str) -> np.ndarray:
    """(3, 120, 160) f32 frames: synthetic views, uniform noise, or a tiled
    patch (many equal block maxima: tie-breaking)."""
    rng = np.random.default_rng(0)
    if kind == "synthetic":
        twists = [[0.02 * i, 0.01 * i, 0.0, 0.0, 0.01 * i, 0.0] for i in range(3)]
        return np.stack([
            np.asarray(jsyn.render_plane_view(JCAM, jse3.exp(jnp.asarray(t, jnp.float32))))
            for t in twists
        ])
    if kind == "noise":
        return rng.uniform(0, 255, (3, 120, 160)).astype(np.float32)
    patch = rng.integers(0, 4, (3, 8, 8)).astype(np.float32) * 40.0
    return np.tile(patch, (1, 15, 20))


def _jax_select(pyr, num_points, mono_z, with_grads=True):
    def sel(i, g, gx, gy):
        return jpoints.topk_gradient_points(
            i, g, JCAM, num_points=num_points, mono_z=mono_z,
            grad_x=gx if with_grads else None, grad_y=gy if with_grads else None,
        )
    return jax.vmap(sel)(pyr.images[0], pyr.grad_mag[0], pyr.grad_x[0], pyr.grad_y[0])


@pytest.mark.parametrize("num_points", [128, 300, 500])
@pytest.mark.parametrize("kind", ["synthetic", "noise", "tiled"])
def test_topk_gradient_points_exact(kind, num_points):
    """300 blocks per frame: 500 points exercise the padding to capacity."""
    frames = _frames(kind)
    jpyr = jax_pyramid(jnp.asarray(frames), levels=2)
    want = points_from_numpy(_jax_select(jpyr, num_points, 2.0))
    pyr = pyramid_from_numpy(jpyr)
    got = points.topk_gradient_points(
        pyr.images[0], pyr.grad_mag[0], CAM, num_points=num_points, mono_z=2.0,
        grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0],
    )
    for field in ("uv", "intensity", "valid", "gx0", "gy0"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    torch.testing.assert_close(got.p3d, want.p3d, atol=1e-6, rtol=1e-6)


def test_selection_from_raw_frames_matches_jax():
    """The port's own pyramid (K1's plain version) selects the same points."""
    frames = _frames("synthetic")
    want = points_from_numpy(
        _jax_select(jax_pyramid(jnp.asarray(frames), levels=3), 256, 1.0, False)
    )
    pyr = build_pyramid_batched(torch.from_numpy(frames), levels=3)
    got = points.topk_gradient_points(pyr.images[0], pyr.grad_mag[0], CAM, num_points=256)
    assert got.gx0 is None
    for field in ("uv", "intensity", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("block", [3, 6, 12])
def test_topk_gradient_points_refuses_a_block_that_is_not_a_power_of_two(block):
    """The packed argmax keeps value and in-block index apart only for a
    power-of-two block (the JAX package's form selects wrongly otherwise)."""
    pyr = build_pyramid_batched(torch.from_numpy(_frames("synthetic")), levels=3)
    with pytest.raises(ValueError, match="power of two"):
        points.topk_gradient_points(pyr.images[0], pyr.grad_mag[0], CAM, num_points=64,
                                    block=block)


@pytest.mark.parametrize("block", [4, 16])
def test_topk_gradient_points_other_power_of_two_blocks_match_jax(block):
    frames = _frames("synthetic")
    jpyr = jax_pyramid(jnp.asarray(frames), levels=3)
    want = points_from_numpy(jax.vmap(
        lambda i, g: jpoints.topk_gradient_points(i, g, JCAM, num_points=64, block=block)
    )(jpyr.images[0], jpyr.grad_mag[0]))
    pyr = build_pyramid_batched(torch.from_numpy(frames), levels=3)
    got = points.topk_gradient_points(pyr.images[0], pyr.grad_mag[0], CAM, num_points=64,
                                      block=block)
    for field in ("uv", "intensity", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def _residuals(seed, n=512, frac_valid=0.8):
    rng = np.random.default_rng(seed)
    r = (rng.standard_t(3, size=(4, n)) * 6.0).astype(np.float32)
    valid = rng.uniform(size=(4, n)) < frac_valid
    valid[3] = False                      # a pair with no valid residual
    valid[2, :3] = True
    valid[2, 3:] = False                  # three valid: odd count
    return r, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_median_and_mad_match_jax(seed):
    r, valid = _residuals(seed)
    med_j = np.stack([np.asarray(jrobust.masked_median(r[b], valid[b])) for b in range(4)])
    mad_j = np.stack([np.asarray(jrobust.mad_sigma(r[b], valid[b])) for b in range(4)])
    rt, vt = torch.from_numpy(r), torch.from_numpy(valid)
    np.testing.assert_array_equal(robust.masked_median(rt, vt).numpy(), med_j)
    np.testing.assert_allclose(robust.mad_sigma(rt, vt).numpy(), mad_j, rtol=1e-6)


@pytest.mark.parametrize("kind", ["HUBER", "TUKEY", "NONE"])
def test_weights_and_cost_match_jax(kind):
    r, valid = _residuals(3)
    rt, vt = torch.from_numpy(r), torch.from_numpy(valid)
    jk, tk = jrobust.WeightKind[kind], robust.WeightKind[kind]
    sig = np.array([0.5, 3.0, 8.0, 2.0], np.float32)
    for sigma in (None, sig):
        st = None if sigma is None else torch.from_numpy(sigma)
        for b in range(4):
            sj = None if sigma is None else jnp.asarray(sigma[b])
            w_j = np.asarray(jrobust.weights(r[b], valid[b], jk, sigma=sj))
            c_j = np.asarray(jrobust.robust_cost(r[b], valid[b], jk, sigma=sj))
            np.testing.assert_allclose(
                robust.weights(rt, vt, tk, sigma=st)[b].numpy(), w_j, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                robust.robust_cost(rt, vt, tk, sigma=st)[b].numpy(), c_j, rtol=1e-5)


def test_texture_literals_are_the_jax_random_draws():
    key = jax.random.PRNGKey(0)
    kf, kp, ka = jax.random.split(key, 3)
    freqs = jax.random.uniform(kf, (12, 2), minval=0.5, maxval=6.0)
    phases = jax.random.uniform(kp, (12,), minval=0.0, maxval=6.28)
    amps = jax.random.uniform(ka, (12,), minval=0.3, maxval=1.0)
    tex = synthetic.TEXTURE_SEED0
    np.testing.assert_array_equal(tex.freqs, np.asarray(freqs))
    np.testing.assert_array_equal(tex.phases, np.asarray(phases))
    np.testing.assert_array_equal(tex.amps, np.asarray(amps))
    assert texture_from_numpy(freqs, phases, amps).amps.dtype == np.float32


def test_smooth_texture_with_other_coefficients_matches_jax():
    key = jax.random.PRNGKey(7)
    kf, kp, ka = jax.random.split(key, 3)
    freqs = jax.random.uniform(kf, (12, 2), minval=1.0, maxval=12.0)
    phases = jax.random.uniform(kp, (12,), minval=0.0, maxval=6.28)
    amps = jax.random.uniform(ka, (12,), minval=0.3, maxval=1.0)
    tex = texture_from_numpy(freqs, phases, amps)
    x = np.linspace(-1, 1, 200, dtype=np.float32)
    y = np.linspace(-0.5, 2, 200, dtype=np.float32)
    got = synthetic.smooth_texture(torch.from_numpy(x), torch.from_numpy(y), tex)
    want = jsyn.smooth_texture(jnp.asarray(x), jnp.asarray(y), seed=7, detail=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("twist", [
    [0.0] * 6, [0.06, 0.024, 0.008, 0.004, -0.006, 0.008], [0.1, -0.2, 0.5, 0.3, 0.2, -0.1],
])
def test_render_plane_view_and_depth_match_jax(twist):
    T = jse3.exp(jnp.asarray(twist, jnp.float32))
    Tt = torch.from_numpy(np.array(T))
    np.testing.assert_allclose(
        synthetic.render_plane_view(CAM, Tt, 2.0).numpy(),
        np.asarray(jsyn.render_plane_view(JCAM, T, 2.0)), atol=1e-3)
    np.testing.assert_allclose(
        synthetic.plane_depth(CAM, Tt, 2.0).numpy(),
        np.asarray(jsyn.plane_depth(JCAM, T, 2.0)), rtol=1e-5)
    batch = synthetic.render_plane_view(CAM, torch.stack([Tt, Tt]), 2.0)
    assert batch.shape == (2, 120, 160)
