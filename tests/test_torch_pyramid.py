"""Parity of the port's pyramid, sampling and kernel plain versions with the
JAX package.

K1 (Scharr), K2 (warp + sample) and K3 (sample) are CUDA kernels; on the
CPU each wrapper runs its plain PyTorch version, which is held here against
(a) the JAX package's CPU function and (b) the Pallas kernel it replaces in
interpret mode. Tolerances: the plain versions reproduce the JAX CPU
arithmetic (1e-4 absolute on [0, 255] data, except where K2's warp sums in
another order, see that test); the TPU kernel K2 samples in bf16 (1.5
absolute, as tests/test_pallas_ops.py uses). The kernels themselves are
tested on the card by tests/test_torch_kernels.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image import pyramid as jpyr  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking.photometric import _warp_sample as jax_warp_sample  # noqa: E402
from uwslam_tpu_torch import ops  # noqa: E402
from uwslam_tpu_torch.image import pyramid  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax, pyramid_from_numpy  # noqa: E402

# The tests run on the CPU, where the wrappers take their plain versions.
pyramid_from_numpy = functools.partial(pyramid_from_numpy, device="cpu")

# Power-of-two focal lengths: a point at depth 1 projects exactly onto the
# last column/row, so the edge cases below are exact in both packages.
JCAM = JaxCamera(fx=64.0, fy=64.0, cx=31.5, cy=23.5, width=64, height=48)
CAM = camera_from_jax(JCAM)


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _uv(n, H, W, seed):
    """Random points over and past the image, plus the exact edges."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], -1)
    edges = [[W - 1, 3.5], [W - 1, H - 1], [5.25, H - 1], [0, 0], [W - 1, 0],
             [0, H - 1], [W - 1 + 1e-3, 2], [np.nan, 2.0], [3.0, np.inf]]
    uv[: len(edges)] = edges
    return uv.astype(np.float32)


def _edge_p3d(n, seed):
    """Reference points for an identity pose: exact right and bottom edges,
    points behind and at the camera, the rest random in front."""
    rng = np.random.default_rng(seed)
    x = (np.array([JCAM.width - 1.0]) - JCAM.cx) / JCAM.fx
    y = (np.array([JCAM.height - 1.0]) - JCAM.cy) / JCAM.fy
    p = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(0.8, 3.0, n)], -1)
    p[:8] = np.stack([np.full(8, x[0]), np.linspace(-0.3, 0.3, 8), np.ones(8)], -1)
    p[8:16] = np.stack([np.linspace(-0.45, 0.45, 8), np.full(8, y[0]), np.ones(8)], -1)
    p[16] = [x[0], y[0], 1.0]
    p[17:21] = [[0, 0, -1.0], [0, 0, 5e-4], [0, 0, 0.0], [0.1, 0.1, 1e-3]]
    return p.astype(np.float32)


def test_scharr_plain_matches_jax_bit_for_bit():
    imgs = _images((3, 48, 64))
    gx_j, gy_j = jax.vmap(jpyr.scharr_gradients)(jnp.asarray(imgs))
    gx, gy, gm = ops.scharr_plain(_t(imgs))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(gx_j))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(gy_j))
    gm_j = 0.5 * np.abs(np.asarray(gx_j)) + 0.5 * np.abs(np.asarray(gy_j))
    np.testing.assert_array_equal(gm.numpy(), gm_j)


@pytest.mark.parametrize("levels", [1, 3, 5])
def test_build_pyramid_batched_matches_jax(levels):
    imgs = _images((2, 64, 96), seed=levels)
    pj = pyramid_from_numpy(jpyr.build_pyramid_batched(jnp.asarray(imgs), levels=levels))
    pt = pyramid.build_pyramid_batched(_t(imgs), levels=levels)
    assert pt.levels == levels
    for field in ("images", "grad_x", "grad_y", "grad_mag"):
        for lvl in range(levels):
            a, b = getattr(pt, field)[lvl], getattr(pj, field)[lvl]
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_bilinear_sample_matches_jax_gather_with_edges(fill):
    img = _images((48, 64), seed=3)
    uv = _uv(400, 48, 64, seed=4)
    out_j, ok_j = jpyr.bilinear_sample(jnp.asarray(img), jnp.asarray(uv), fill=fill)
    out, ok = pyramid.bilinear_sample(_t(img), _t(uv), fill=fill)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-4)
    # The CPU gather's edge rule: u == W-1 exactly reads column W-2.
    assert float(out[0]) == pytest.approx(float(img[3, 62] * 0.5 + img[4, 62] * 0.5))


@pytest.mark.parametrize("C", [1, 3])
def test_k3_plain_matches_jax_gather(C):
    stack = _images((2, C, 48, 64), seed=5)
    uv = np.stack([_uv(300, 48, 64, seed=6), _uv(300, 48, 64, seed=7)])
    out, ok = ops.bilinear_sample_plain(_t(stack), _t(uv))
    assert out.shape == (2, C, 300) and ok.dtype == torch.bool
    for b in range(2):
        for c in range(C):
            v_j, ok_j = jpyr.bilinear_sample(jnp.asarray(stack[b, c]), jnp.asarray(uv[b]))
            np.testing.assert_array_equal(ok[b].numpy(), np.asarray(ok_j))
            np.testing.assert_allclose(out[b, c].numpy(), np.asarray(v_j), atol=1e-4)


@pytest.mark.parametrize("C", [1, 3])
def test_k2_plain_matches_jax_warp_sample(C):
    B, N = 3, 256
    stack = _images((B, C, 48, 64), seed=8)
    p3d = np.stack([_edge_p3d(N, seed=9 + b) for b in range(B)])
    twists = np.zeros((B, 6), np.float32)
    twists[1:] = np.random.default_rng(10).normal(size=(B - 1, 6)) * 0.05
    T = np.asarray(jse3.exp(jnp.asarray(twists)))
    out, ok = ops.warp_and_sample_plain(_t(stack), _t(p3d), _t(T), CAM)
    assert ok[0, :17].all() and not ok[0, 17:21].any()
    for b in range(B):
        v_j, ok_j = jax_warp_sample(jnp.asarray(stack[b]), jnp.asarray(p3d[b]),
                                    jnp.asarray(T[b]), JCAM)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(ok_j))
        # R p + t is summed in another order than JAX's einsum: the warped
        # uv differ by a few ulps, times the noise image's gradient of up
        # to 255 per pixel.
        np.testing.assert_allclose(out[b].numpy(), np.asarray(v_j), atol=5e-3)


def test_k1_matches_pallas_kernel_in_interpret_mode():
    from uwslam_tpu.ops.pallas_pyramid import _scharr_kernel

    imgs = _images((2, 48, 64), seed=11)
    B, H, W = imgs.shape
    spec = pl.BlockSpec((1, H, W), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    out = jax.ShapeDtypeStruct((B, H, W), jnp.float32)
    ref = pl.pallas_call(
        _scharr_kernel, grid=(B,), in_specs=[spec], out_specs=(spec,) * 3,
        out_shape=(out,) * 3, interpret=True,
    )(jnp.asarray(imgs))
    for a, b in zip(ops.scharr_plain(_t(imgs)), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_k2_matches_pallas_kernel_in_interpret_mode():
    from uwslam_tpu.ops.pallas_track import warp_and_sample as pallas_warp

    jcam = JaxCamera(fx=120.0, fy=120.0, cx=63.5, cy=31.5, width=128, height=64)
    images = _images((3, 64, 128), seed=12)
    rng = np.random.default_rng(13)
    uv = np.stack([rng.uniform(2, 125, 512), rng.uniform(2, 61, 512)], -1)
    z = np.linspace(0.5, 4.0, 512)
    z[::97] = -0.2
    p3d = np.asarray(jcam.unproject(jnp.asarray(uv, jnp.float32), jnp.asarray(z, jnp.float32)))
    T = np.asarray(jse3.exp(jnp.asarray([0.05, -0.02, 0.03, 0.02, -0.01, 0.015])))
    ref, ok_ref = pallas_warp(jnp.asarray(images), jnp.asarray(p3d), jnp.asarray(T),
                              jcam, interpret=True)
    out, ok = ops.warp_and_sample_plain(_t(images)[None], _t(p3d)[None], _t(T)[None],
                                        camera_from_jax(jcam))
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(ok_ref))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1.5)


def test_k3_matches_pallas_kernel_in_interpret_mode():
    from uwslam_tpu.ops.pallas_sample import _sample_kernel

    images = _images((3, 64, 128), seed=14)
    rng = np.random.default_rng(15)
    # The TPU kernel's one-hot rows read column W-1 at u == W-1 exactly,
    # where the CPU gather reads W-2: keep clear of that edge here.
    uv = np.stack([rng.uniform(-3, 126.5, 512), rng.uniform(-3, 62.5, 512)], -1)
    uv = uv.astype(np.float32)
    C, H, W = images.shape
    img_hcw = jnp.transpose(jnp.asarray(images), (1, 0, 2)).reshape(H, C * W)
    spec_uv = pl.BlockSpec((512, 2), lambda i: (i, 0), memory_space=pltpu.VMEM)
    spec_img = pl.BlockSpec((H, C * W), lambda i: (0, 0), memory_space=pltpu.VMEM)
    ref = pl.pallas_call(
        functools.partial(_sample_kernel, C=C, W=W), grid=(1,),
        in_specs=[spec_uv, spec_img],
        out_specs=pl.BlockSpec((C, 512), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((C, 512), jnp.float32), interpret=True,
    )(jnp.asarray(uv), img_hcw)
    out, ok = ops.bilinear_sample_plain(_t(images)[None], _t(uv)[None])
    inside = ok[0].numpy()
    expect_inside = (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1)
    np.testing.assert_array_equal(inside, expect_inside)
    np.testing.assert_allclose(out[0].numpy()[:, inside], np.asarray(ref)[:, inside], atol=1e-3)
