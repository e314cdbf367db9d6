"""Parity of what the port's evaluation renders with the JAX package's:
`render_scene_view_distorted`, `depth_holes`, `orbit_trajectory`
(`uwslam_tpu_torch.utils.synthetic`), the EUROC scenes' texture literals and
the dataset makers of `uwslam_tpu_torch.eval` against eval.py's.

Tolerances, each measured under XLA's default instruction set and under
`XLA_FLAGS=--xla_cpu_max_isa=AVX2`, `AVX` and `SSE4_2`:
- The distorted render at the EUROC camera (752 x 480, the real radtan
  coefficients), both EUROC scenes at two poses: 2e-3 gray levels away from
  plane boundaries (measured 2.1e-4 to 4.7e-4: f32 sines of arguments up to
  ~200 rad, rays from eight fixed-point undistortion passes); at most 0.1%
  of the pixels may hit another plane than in the JAX render (measured: none).
- `depth_holes` from the JAX package's own uniforms: bit for bit.
- `orbit_trajectory` and `eval.py:_trajectory`: 1e-6.
- The makers, two frames without noise of each, read back through the
  port's image decoder: at most one gray level per pixel, on at most 0.1% of
  the pixels (measured 3e-6 to 2.5e-5: the PNGs truncate to 8 bits, so a
  value within an ulp of an integer may land on either side); ground-truth
  rows within 1e-6 beyond their 6 decimals; the calibration files equal.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import eval as jeval  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch import eval as port_eval  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.io.dataset import Sequence, _decode_image, _timestamp  # noqa: E402
from uwslam_tpu_torch.io.trajectory import read_groundtruth_euroc, \
    read_groundtruth_tum  # noqa: E402
from uwslam_tpu_torch.utils import synthetic as syn  # noqa: E402
from test_torch_synthetic_fractal import _jax_coefficients  # noqa: E402

EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
             k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
EUROC_PLANES = {  # eval.py:_scene's EUROC planes: (seed, detail)
    "euroc_mh": [(13, 0.8), (17, 1.1), (19, 1.4), (23, 1.2)],
    "euroc_v1": [(29, 1.0), (31, 1.3), (37, 1.5)],
}
POSES = [[0.0] * 6, [0.21, -0.07, 0.09, 0.02, -0.03, 0.015]]
INTERIOR_ATOL = 2e-3
PLANE_FLIP_SHARE = 1e-3


@pytest.mark.parametrize("seed,detail", [p for ps in EUROC_PLANES.values() for p in ps],
                         ids=lambda v: str(v))
def test_euroc_fractal_literals_equal_the_jax_draw(seed, detail):
    lit = syn.fractal_scene_texture(seed, detail, 4)
    for a, b in zip(lit[:3], _jax_coefficients(seed, detail)):
        np.testing.assert_allclose(a, b, rtol=5e-7, atol=0)


def _jax_rays(jcam):
    v, u = jnp.meshgrid(jnp.arange(jcam.height, dtype=jnp.float32),
                        jnp.arange(jcam.width, dtype=jnp.float32), indexing="ij")
    xy = jcam.undistort_normalized(jnp.stack([(u - jcam.cx) / jcam.fx,
                                              (v - jcam.cy) / jcam.fy], axis=-1))
    return jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)


def _port_rays(cam):
    return syn._unit_z(cam.undistort_normalized(syn._normalized_grid(cam, "cpu", torch.float32)))


@pytest.mark.parametrize("pose", range(len(POSES)), ids=["identity", "moved"])
@pytest.mark.parametrize("kind", sorted(EUROC_PLANES))
def test_distorted_scene_renders_like_jax(kind, pose):
    jcam, cam = JaxCamera(**EUROC), PinholeCamera(**EUROC)
    T = jse3.exp(jnp.asarray(POSES[pose], jnp.float32))
    Tt = torch.from_numpy(np.array(T))
    planes = port_eval.scene(kind)
    ref = np.asarray(jsyn.render_scene_view_distorted(jcam, T, jeval._scene(kind)))
    got = syn.render_scene_view_distorted(cam, Tt, planes).numpy()
    assert got.shape == ref.shape == (480, 752)
    # Where each pixel's ray lands, in both packages.
    idx_ref = np.asarray(jsyn._raycast_scene(jcam, T, jeval._scene(kind),
                                             rays=_jax_rays(jcam))[3])
    idx_got = syn._raycast_scene(cam, Tt, planes, rays=_port_rays(cam))[3].numpy()
    flipped = idx_ref != idx_got
    assert flipped.mean() <= PLANE_FLIP_SHARE
    boundary = np.zeros_like(flipped)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            boundary |= np.roll(np.roll(idx_ref, dy, 0), dx, 1) != idx_ref
    interior = ~(boundary | flipped)
    assert interior.mean() > 0.9 and len(np.unique(idx_ref)) >= 3
    np.testing.assert_allclose(got[interior], ref[interior], atol=INTERIOR_ATOL)


def test_raycast_rays_override_the_pinhole_grid():
    cam = PinholeCamera(**{k: v for k, v in EUROC.items() if k[0] not in "kp"})
    T = torch.eye(4)
    planes = port_eval.scene("euroc_v1")
    rays = syn._unit_z(syn._normalized_grid(cam, "cpu", torch.float32))
    for a, b in zip(syn._raycast_scene(cam, T, planes), syn._raycast_scene(cam, T, planes,
                                                                           rays=rays)):
        assert torch.equal(a, b)
    # Undistorted, the distorted render is the pinhole one.
    assert torch.equal(syn.render_scene_view_distorted(cam, T, planes),
                       syn.render_scene_view(cam, T, planes))


@pytest.mark.parametrize("shape,block,frac", [((480, 640), 16, 0.2), ((120, 150), 7, 0.5)])
def test_depth_holes_match_jax_from_its_uniforms(shape, block, frac):
    rng = np.random.default_rng(block)
    depth = rng.uniform(0.5, 5.0, shape).astype(np.float32)
    key = jax.random.PRNGKey(block)
    ref = np.asarray(jsyn.depth_holes(jnp.asarray(depth), key, hole_frac=frac, block=block))
    Hb, Wb = -(-shape[0] // block), -(-shape[1] // block)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (Hb, Wb))))
    mask = syn.depth_hole_mask(u, shape, frac, block)
    got = torch.where(mask, 0.0, torch.from_numpy(depth)).numpy()
    assert np.array_equal(got, ref)
    assert 0 < (ref == 0).mean() < 1


def test_depth_holes_generator_path_drops_whole_blocks_at_the_expected_rate():
    H, W, block, frac = 480, 640, 16, 0.2
    depth = torch.full((H, W), 2.0)
    a = syn.depth_holes(depth, torch.Generator().manual_seed(3), frac, block)
    b = syn.depth_holes(depth, torch.Generator().manual_seed(3), frac, block)
    assert torch.equal(a, b)
    blocks = (a == 0).reshape(H // block, block, W // block, block)
    per_block = blocks.float().mean(dim=(1, 3))
    assert torch.all((per_block == 0) | (per_block == 1))
    n = per_block.numel()   # 1200 blocks: 4 binomial standard deviations
    assert abs(float(per_block.mean()) - frac) < 4 * (frac * (1 - frac) / n) ** 0.5
    assert torch.equal(a[a != 0], depth[a != 0])


@pytest.mark.parametrize("kw", [{}, {"radius": 0.08, "step": 0.05}], ids=["default", "wide"])
def test_orbit_trajectory_matches_jax(kw):
    ref = np.asarray(jsyn.orbit_trajectory(40, **kw))
    got = syn.orbit_trajectory(40, **kw).numpy()
    assert got.shape == (40, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("loop_period", [None, 56], ids=["smooth", "loop"])
def test_trajectory_matches_eval_py(loop_period):
    ref = np.stack([np.asarray(T) for T in jeval._trajectory(60, loop_period=loop_period)])
    got = port_eval.trajectory(60, loop_period=loop_period).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if loop_period:
        np.testing.assert_allclose(got[loop_period], got[0], atol=1e-6)   # the revisit


def _frames(directory, seconds_per_unit=1.0):
    """The port's reader on a directory of fewer frames than its 15-frame
    minimum: the frames in name order and their timestamps."""
    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory))
    return Sequence(paths, None, np.array([_timestamp(p) * seconds_per_unit for p in paths]))


def _pixels_agree(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_tum_maker_matches_eval_py(tmp_path):
    ref = jeval.make_tum_dataset(str(tmp_path / "jax"), 2, noise_sigma=0.0)
    got = port_eval.make_tum_dataset(str(tmp_path / "port"), 2, noise_sigma=0.0)
    assert got["renderer"] == port_eval.RENDERER
    assert (tmp_path / "port" / "DONE").read_text().strip() == "uwslam_tpu_torch"
    a, b = _frames(got["rgb"]), _frames(ref["rgb"])
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert [os.path.basename(p) for p in a.image_paths] == \
        [os.path.basename(p) for p in b.image_paths]
    for i in range(2):
        _pixels_agree(a.load(i)[0], b.load(i)[0])
    np.testing.assert_allclose(read_groundtruth_tum(got["gt"]), read_groundtruth_tum(ref["gt"]),
                               atol=1.0001e-6, rtol=0)
    assert open(got["calib"]).read() == open(ref["calib"]).read()
    # The port reuses what eval.py rendered, and says so.
    again = port_eval.make_tum_dataset(ref["root"], 2)
    assert again["renderer"] == port_eval.JAX_RENDERER and again["rgb"] == ref["rgb"]


@pytest.mark.parametrize("kind,seed", [("euroc_mh", 1), ("euroc_v1", 2)])
def test_euroc_maker_matches_eval_py(tmp_path, kind, seed):
    ref = jeval.make_euroc_dataset(str(tmp_path / "jax"), 2, kind=kind, seed=seed,
                                   noise_sigma=0.0)
    got = port_eval.make_euroc_dataset(str(tmp_path / "port"), 2, kind=kind, seed=seed,
                                       noise_sigma=0.0)
    a, b = (_frames(os.path.join(d["root"], "cam0", "data"), 1e-9) for d in (got, ref))
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    for i in range(2):
        img = a.load(i)[0]
        assert img.shape == (480, 752)
        _pixels_agree(img, b.load(i)[0])
    np.testing.assert_allclose(read_groundtruth_euroc(got["gt"]),
                               read_groundtruth_euroc(ref["gt"]), atol=1.0001e-6, rtol=0)
    assert open(got["calib"]).read() == open(ref["calib"]).read()
    assert port_eval.renderer_of(ref["root"]) == port_eval.JAX_RENDERER


def test_noise_is_seeded_per_frame_as_eval_py_keys(tmp_path):
    """Frame i's noise comes from a generator seeded seed * 10007 + i: a
    second render repeats bit for bit, a different seed does not."""
    a = port_eval.make_tum_dataset(str(tmp_path / "a"), 2, seed=4)
    b = port_eval.make_tum_dataset(str(tmp_path / "b"), 2, seed=4)
    c = port_eval.make_tum_dataset(str(tmp_path / "c"), 2, seed=5)
    fa, fb, fc = (_decode_image(sorted(_frames(d["rgb"]).image_paths)[1]) for d in (a, b, c))
    assert np.array_equal(fa, fb) and not np.array_equal(fa, fc)
