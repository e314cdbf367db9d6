"""Parity of the port's broadband texture, the evaluation's `tum` scene and
the photometric degradation (`uwslam_tpu_torch.utils.synthetic`) with the
JAX package's: `fractal_texture`, `make_plane(..., octaves=4)` in
`render_scene_view`, and `apply_photometric`.

The JAX package draws the texture's sinusoids from `jax.random`; the port
carries them as literals (`_scene_textures.FRACTAL_COEFFICIENTS`). They are
held to the JAX draw within 4 ulp (5e-7 relative: jax.random.uniform's
u * (max - min) + min rounds once under a fused multiply-add and twice
without, so the draw itself moves by an ulp between XLA's instruction sets;
measured 1.1e-7 under AVX), the textures to 2e-3 gray levels (f32 sines
of arguments up to ~200 rad, summed in the same order), rendered views to
2e-3 gray levels away from occlusion edges (where a last-bit difference of
the ray parameter flips the plane a pixel sees) and to 1% of the pixels
over all. `apply_photometric` without noise equals the JAX package's gain
and bias to 1e-4 gray levels; its noise is the port's own draw, held to its
standard deviation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.interop import fractal_texture_from_numpy  # noqa: E402
from uwslam_tpu_torch.utils import synthetic as syn  # noqa: E402

TUM_PLANES = [  # eval.py:_scene("tum")
    dict(center=(0.0, 0.0, 5.0), normal=(0.05, -0.02, -1.0), seed=3, detail=0.9),
    dict(center=(-0.9, 0.1, 2.4), normal=(0.35, 0.1, -1.0), extent=(1.1, 1.4), seed=7, detail=1.2),
    dict(center=(0.5, -0.2, 1.4), normal=(-0.1, 0.05, -1.0), extent=(0.5, 0.55), seed=11,
         detail=1.5),
    dict(center=(-0.15, 0.6, 1.8), normal=(0.0, -0.3, -1.0), extent=(0.9, 0.3), seed=5, detail=1.3),
]


def _jax_coefficients(seed, detail, octaves=4):
    """fractal_texture's draws, octave by octave."""
    key, out = jax.random.PRNGKey(seed), []
    for o in range(octaves):
        key, kf, kp, ka = jax.random.split(key, 4)
        base = 0.35 * detail * (2.0 ** o)
        out.append((jax.random.uniform(kf, (4, 2), minval=base, maxval=2.0 * base),
                    jax.random.uniform(kp, (4,), minval=0.0, maxval=6.28),
                    jax.random.uniform(ka, (4,), minval=0.5, maxval=1.0) * (0.55 ** o)))
    return [np.concatenate([np.asarray(o[k]) for o in out]) for k in range(3)]


@pytest.mark.parametrize("plane", TUM_PLANES, ids=lambda p: f"seed{p['seed']}")
def test_fractal_literals_equal_the_jax_draw_and_textures_agree(plane):
    seed, detail = plane["seed"], plane["detail"]
    lit = syn.fractal_scene_texture(seed, detail, 4)
    want = _jax_coefficients(seed, detail)
    for a, b in zip(lit[:3], want):
        np.testing.assert_allclose(a, b, rtol=5e-7, atol=0)
    conv = fractal_texture_from_numpy(*lit[:3], 4)
    assert conv.octaves == lit.octaves == 4
    assert all(np.array_equal(a, b) for a, b in zip(lit[:3], conv[:3]))
    rng = np.random.default_rng(seed)
    x, y = (rng.uniform(-12, 12, (64, 64)).astype(np.float32) for _ in range(2))
    got = syn.fractal_texture(torch.from_numpy(x), torch.from_numpy(y), lit).numpy()
    ref = np.asarray(jsyn.fractal_texture(jnp.asarray(x), jnp.asarray(y), seed=seed,
                                          detail=detail, octaves=4))
    np.testing.assert_allclose(got, ref, atol=2e-3)
    assert 0.0 <= got.min() and got.max() <= 255.0


def test_missing_literals_raise_naming_what_is_known():
    with pytest.raises(KeyError, match="fractal texture literals"):
        syn.fractal_scene_texture(99, 1.0, 4)


@pytest.mark.parametrize("xi", [[0.0] * 6, [0.1, -0.05, 0.08, 0.02, -0.03, 0.015]],
                         ids=["identity", "moved"])
def test_tum_scene_renders_like_jax(xi):
    jcam = JaxCamera(fx=131.25, fy=131.25, cx=79.875, cy=59.875, width=160, height=120)
    cam = PinholeCamera(fx=131.25, fy=131.25, cx=79.875, cy=59.875, width=160, height=120)
    T = jse3.exp(jnp.asarray(xi, jnp.float32))
    ref = np.asarray(jsyn.render_scene_view(
        jcam, T, tuple(jsyn.make_plane(octaves=4, **p) for p in TUM_PLANES)))
    got = syn.render_scene_view(cam, torch.from_numpy(np.asarray(T)),
                                tuple(syn.make_plane(octaves=4, **p) for p in TUM_PLANES)).numpy()
    diff = np.abs(got - ref)
    assert (diff > 2e-3).mean() < 0.01
    interior = np.ones_like(diff, bool)
    edge = diff > 2e-3
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= ~np.roll(np.roll(edge, dy, 0), dx, 1)
    np.testing.assert_allclose(got[interior], ref[interior], atol=2e-3)


def test_apply_photometric_gain_and_bias_match_jax_and_noise_is_seeded():
    img = np.random.default_rng(0).uniform(0, 255, (48, 64)).astype(np.float32)
    for i in (0, 7, 31):
        gain = 1.0 + 0.04 * np.sin(0.11 * i)   # eval.py:176-182
        bias = 3.0 * np.sin(0.07 * i + 1.0)
        ref = np.asarray(jsyn.apply_photometric(jnp.asarray(img), jax.random.PRNGKey(i),
                                                noise_sigma=0.0, gain=gain, bias=bias))
        got = syn.apply_photometric(torch.from_numpy(img), None, noise_sigma=0.0,
                                    gain=float(gain), bias=float(bias)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    flat = torch.full((256, 256), 128.0)
    a = syn.apply_photometric(flat, torch.Generator().manual_seed(4), noise_sigma=1.5)
    b = syn.apply_photometric(flat, torch.Generator().manual_seed(4), noise_sigma=1.5)
    assert torch.equal(a, b)
    assert abs(float((a - 128.0).std()) - 1.5) < 0.05
    assert float(syn.apply_photometric(flat * 2, None, noise_sigma=0.0).max()) == 255.0
