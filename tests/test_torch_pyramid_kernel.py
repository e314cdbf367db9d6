"""The pyramid kernel's arithmetic on the CPU: its plain version against the
JAX package, and the kernel's tiling (tiles, halos, level offsets) in plain
PyTorch against the plain version.

Against the JAX package the plain version is bit-equal to
`build_pyramid_batched` evaluated op by op (`jax.disable_jit()`) under XLA's
default CPU code. Jitted, XLA contracts the Scharr taps into fused
multiply-adds, and under `--xla_cpu_max_isa=AVX` or `SSE4_2` its reduce sums a
2x2 block in another order: both move the JAX package's own last bits (by up
to 7.6e-6 on [0, 255] data), not the port's; tests/test_torch_pyramid.py
holds the jitted function at 1e-4.

The kernel (`uwslam_tpu_torch/csrc/pyramid.cu`) builds every level of a
frame batch's pyramid in one launch, a block per level-0 tile. It runs only
on the card, where tests/test_torch_kernels.py holds it to the plain version
at limit 0; here `pyramid_tiled` repeats its tiling, so the index
arithmetic is checked without a card. Tolerance everywhere: 0 (bit for
bit). The 2x2 mean and the Scharr taps are single f32 operations in a fixed
order in all three, so nothing may move a last bit, and the point selection
picks pixels by exact gradient magnitudes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.image import pyramid as jpyr  # noqa: E402
from uwslam_tpu_torch.image import pyramid  # noqa: E402
from uwslam_tpu_torch.ops import cuda_pyramid as cp  # noqa: E402


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, size=shape).astype(np.float32)


def _equal(got, want):
    for fa, fb in zip(got, want):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            assert a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_plain_pyramid_equals_jax_bit_for_bit(levels, B):
    imgs = _images((B, 48, 80), seed=10 * levels + B)
    with jax.disable_jit():
        pj = jpyr.build_pyramid_batched(jnp.asarray(imgs), levels=levels)
    frames = torch.from_numpy(imgs)
    pt = pyramid.build_pyramid_batched(frames, levels=levels)
    assert pt.levels == levels and pt.images[0] is frames
    for field in ("images", "grad_x", "grad_y", "grad_mag"):
        for lvl in range(levels):
            np.testing.assert_array_equal(getattr(pt, field)[lvl].numpy(),
                                          np.asarray(getattr(pj, field)[lvl]))


@pytest.mark.parametrize("B,H,W,levels,tile", [
    (2, 48, 80, 5, 16),      # ragged in both axes, 3 x 5 tiles
    (1, 48, 80, 5, 32),      # ragged: a 16-row and a 16-column last tile
    (1, 464, 624, 5, 32),    # the rectified ROI
    (1, 480, 640, 3, 32),    # the live frame
    (1, 480, 736, 5, 32),    # the rectified EUROC frame
    (2, 96, 128, 5, 64),     # the offline chunk's tile, cut to two tiles a frame
    (3, 37, 53, 1, 32),      # K1 alone on an odd frame
])
def test_tiled_pyramid_equals_plain(B, H, W, levels, tile):
    imgs = torch.from_numpy(_images((B, H, W), seed=H + W))
    _equal(cp.pyramid_tiled(imgs, levels, tile), cp.pyramid_plain(imgs, levels))


@pytest.mark.parametrize("H,W,levels,tile", [
    (48, 80, 5, 16), (48, 80, 5, 32), (464, 624, 5, 32), (480, 640, 3, 32),
    (480, 736, 5, 64), (37, 53, 1, 32),
])
def test_every_level_pixel_has_exactly_one_owner_tile(H, W, levels, tile):
    for level, (h, w) in enumerate(cp.pyramid_shapes(H, W, levels)):
        owners = np.zeros((h, w), np.int64)
        for y0 in range(0, H, tile):
            for x0 in range(0, W, tile):
                ys, xs = cp.tile_span(level, y0, tile, H), cp.tile_span(level, x0, tile, W)
                assert len(ys) and len(xs)
                owners[ys.start:ys.stop, xs.start:xs.stop] += 1
        assert (owners == 1).all()


@pytest.mark.parametrize("size,levels,tile", [(48, 5, 16), (480, 5, 64), (464, 5, 32),
                                              (480, 3, 32), (53, 1, 32)])
def test_halos_clamp_at_each_levels_own_border(size, levels, tile):
    for start in range(0, size, tile):
        for level in range(levels):
            n = size >> level
            halo = 1 << (levels - 1 - level)
            span = cp.tile_span(level, start, tile, size)
            region = cp.tile_region(level, start, tile, levels, size)
            assert len(region) == (tile >> level) + 2 * halo
            assert min(region) >= 0 and max(region) <= n - 1
            # Unclamped where the frame has the pixel, the border pixel where not.
            for i, p in enumerate(region):
                want = span.start - halo + i
                assert p == min(max(want, 0), n - 1)
            # The owned pixels sit at the halo's offset, with a pixel of halo
            # (or the replicated border) on each side for the Scharr taps.
            assert region[halo:halo + len(span)] == list(span)
            if level:
                # Each position's 2x2 children lie in the level above's region.
                above = cp.tile_region(level - 1, start, tile, levels, size)
                first_above = (start >> (level - 1)) - 2 * halo
                for p in region:
                    i = 2 * p - first_above
                    assert 0 <= i and i + 1 < len(above)
                    assert above[i] == 2 * p and above[i + 1] == 2 * p + 1


@pytest.mark.parametrize("H,W,levels", [(50, 64, 3), (48, 60, 4), (24, 48, 5), (0, 64, 1)])
def test_sizes_not_divisible_by_the_coarsest_step_raise(H, W, levels):
    with pytest.raises(ValueError):
        cp.pyramid_shapes(H, W, levels)
    if H:
        with pytest.raises(ValueError):
            pyramid.build_pyramid_batched(torch.zeros(1, H, W), levels=levels)
        with pytest.raises(ValueError):
            cp.pyramid_tiled(torch.zeros(1, H, W), levels, 32)


@pytest.mark.parametrize("levels", [0, 6])
def test_level_counts_outside_one_to_five_raise(levels):
    with pytest.raises(ValueError):
        cp.pyramid_shapes(64, 64, levels)


def test_layout_puts_levels_back_to_back():
    shapes, img_off, grad_off, n_img, n_grad = cp.pyramid_layout(96, 480, 640, 5)
    assert shapes == [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40)]
    sizes = [96 * h * w for h, w in shapes]
    assert grad_off == [0, *np.cumsum(sizes)[:-1].tolist()] and n_grad == sum(sizes)
    assert img_off == [0, *np.cumsum(sizes[1:])[:-1].tolist()] and n_img == sum(sizes[1:])
    # Bytes the kernel moves at the offline shape: level 0 read once, gx, gy,
    # gm of every level and the images of levels 1-4 written once.
    assert 4 * (sizes[0] + 3 * n_grad + n_img) == 628_531_200


@pytest.mark.parametrize("B,H,W,levels,tile,blocks", [
    (96, 480, 640, 5, 64, 7680),   # the offline chunk
    (1, 480, 640, 3, 32, 300),     # the live frame
    (1, 480, 736, 5, 32, 345),     # the rectified EUROC frame
    (1, 464, 624, 5, 32, 300),     # the rectified ROI
    (1, 480, 640, 5, 32, 300),     # track_sequence and entry()
])
def test_tile_choice_fills_the_card(B, H, W, levels, tile, blocks):
    assert cp.pyramid_tile(B, H, W, levels) == tile
    assert B * -(-H // tile) * -(-W // tile) == blocks and blocks > cp.SM_COUNT
    assert cp.shared_bytes(levels, tile) <= 64 * 1024
    assert tile % (1 << (levels - 1)) == 0


def test_shared_memory_of_the_largest_block():
    assert cp.shared_bytes(5, 64) == 4 * (96 ** 2 + 48 ** 2 + 24 ** 2 + 12 ** 2 + 6 ** 2)
    assert cp.shared_bytes(3, 32) == 4 * (40 ** 2 + 20 ** 2 + 10 ** 2)
    assert cp.shared_bytes(1, 64) == 4 * 66 ** 2


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    imgs = torch.from_numpy(_images((2, 48, 80), seed=3))
    before = (cp.cuda_build_pyramid.launches, cp.scharr_gradients_batched.launches)
    _equal(cp.cuda_build_pyramid(imgs, 5), cp.pyramid_plain(imgs, 5))
    _equal([cp.scharr_gradients_batched(imgs)], [cp.scharr_plain(imgs)])
    assert (cp.cuda_build_pyramid.launches, cp.scharr_gradients_batched.launches) == before
    with pytest.raises(ValueError):
        cp.cuda_build_pyramid(imgs.to("meta"), 5)
