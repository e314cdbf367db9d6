"""K1 redesigned: a frame batch's whole image pyramid in one launch (CUDA
kernel `csrc/pyramid.cu`).

Replaces the TPU kernel `uwslam_tpu/ops/pallas_pyramid.py:_scharr_kernel`
(launched by `scharr_gradients_batched`, once per level) together with the
2x2 mean downsample between its launches. The kernel is bound by HBM bytes:
it reads the input once and writes the coarser images and every level's gx,
gy and |g| once. A block owns a level-0 tile and builds every level of it in
shared memory from a halo of 2^(levels-1) level-0 pixels (`tile_region`).

`pyramid_plain` is the same function in plain PyTorch (`downsample2x` and
`scharr_plain` level by level); `pyramid_tiled` is the kernel's tiling in
plain PyTorch, tile by tile, for the CPU tests. `cuda_build_pyramid` runs the plain
version for a CPU tensor and launches the kernel for a CUDA tensor;
`scharr_gradients_batched` is the same kernel at `levels=1` (K1 alone).
Each counts its launches in `.launches`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib

MAX_LEVELS = 5
SM_COUNT = 132
# A 64 x 64 tile where the batch gives at least this many blocks per SM
# (several waves of 4 resident blocks), else 32 x 32: a single 480 x 640
# frame then runs 300 blocks instead of 80.
TILE_64_MIN_BLOCKS_PER_SM = 8


def downsample2x(image: torch.Tensor) -> torch.Tensor:
    """2x2 area mean of (..., H, W): the four taps are summed row-major, as
    the JAX package's reduction sums them."""
    *lead, H, W = image.shape
    x = image.reshape(*lead, H // 2, 2, W // 2, 2)
    s = x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]
    return s / 4.0


def scharr_plain(images: torch.Tensor):
    """(..., H, W) f32 -> (gx, gy, gm): edge-replicated 3x3 Scharr / 32 and
    gm = 0.5|gx| + 0.5|gy| (the kernel's exact arithmetic)."""
    shape = images.shape
    H, W = shape[-2:]
    p = F.pad(images.reshape(-1, H, W), (1, 1, 1, 1), mode="replicate")
    a = p[:, :-2, :-2]
    b = p[:, :-2, 1:-1]
    c = p[:, :-2, 2:]
    d = p[:, 1:-1, :-2]
    f = p[:, 1:-1, 2:]
    g = p[:, 2:, :-2]
    h = p[:, 2:, 1:-1]
    i = p[:, 2:, 2:]
    gx = (3.0 * (c - a) + 10.0 * (f - d) + 3.0 * (i - g)) * (1.0 / 32.0)
    gy = (3.0 * (g - a) + 10.0 * (h - b) + 3.0 * (i - c)) * (1.0 / 32.0)
    gm = 0.5 * torch.abs(gx) + 0.5 * torch.abs(gy)
    return gx.reshape(shape), gy.reshape(shape), gm.reshape(shape)


def pyramid_shapes(H: int, W: int, levels: int) -> list[tuple[int, int]]:
    """(H_l, W_l) of levels 0 .. levels-1; raises unless 1 <= levels <= 5 and
    H, W are positive multiples of 2^(levels-1)."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be 1 to {MAX_LEVELS}, got {levels}")
    step = 1 << (levels - 1)
    if H < 1 or W < 1 or H % step or W % step:
        raise ValueError(f"a {levels}-level pyramid needs H and W divisible by {step}, "
                         f"got {H} x {W}")
    return [(H >> l, W >> l) for l in range(levels)]


def pyramid_layout(B: int, H: int, W: int, levels: int):
    """Where each level lies in the kernel's output buffers, as the C entry
    point lays them out -> (shapes, image offsets of levels 1.. (level 0 is
    the input), gradient offsets of levels 0.., image buffer size, gradient
    buffer size), in elements; levels lie back to back, each (B, H_l, W_l)."""
    shapes = pyramid_shapes(H, W, levels)
    img_off, grad_off, n_img, n_grad = [], [], 0, 0
    for l, (h, w) in enumerate(shapes):
        grad_off.append(n_grad)
        n_grad += B * h * w
        if l:
            img_off.append(n_img)
            n_img += B * h * w
    return shapes, img_off, grad_off, n_img, n_grad


def pyramid_tile(B: int, H: int, W: int, levels: int, sm_count: int = SM_COUNT) -> int:
    """The side of a block's level-0 tile: 64 where the batch gives at least
    TILE_64_MIN_BLOCKS_PER_SM blocks per SM, else 32 (both multiples of
    2^(levels-1) for every levels <= 5)."""
    pyramid_shapes(H, W, levels)
    blocks = B * -(-H // 64) * -(-W // 64)
    return 64 if blocks >= TILE_64_MIN_BLOCKS_PER_SM * sm_count else 32


def shared_bytes(levels: int, tile: int) -> int:
    """Shared memory of one block: every level's region, sides
    (tile + 2 * 2^(levels-1)) / 2^l (as `csrc/pyramid.cu` reckons it)."""
    side = tile + 2 * (1 << (levels - 1))
    return 4 * sum((side >> l) ** 2 for l in range(levels))


def tile_span(level: int, start: int, tile: int, size: int) -> range:
    """Along one axis, the level-`level` pixels that the block whose level-0
    tile starts at `start` writes: the tile's tile / 2^level pixels, cut at
    the frame's extent size / 2^level (the last tile may be ragged)."""
    first = start >> level
    return range(first, min(first + (tile >> level), size >> level))


def tile_region(level: int, start: int, tile: int, levels: int, size: int) -> list[int]:
    """Along one axis, the level-`level` positions whose values the block
    whose level-0 tile starts at `start` holds in shared memory: the tile's
    tile / 2^level pixels and a halo of 2^(levels-1-level) on each side,
    each clamped to [0, size / 2^level - 1], the frame's extent AT THAT LEVEL
    (so a halo replicates that level's border). The kernel computes the
    value at an out-of-frame position as the value at its clamped position."""
    h = 1 << (levels - 1 - level)
    first = (start >> level) - h
    last = (size >> level) - 1
    return [min(max(p, 0), last) for p in range(first, first + (tile >> level) + 2 * h)]


def pyramid_tiled(images: torch.Tensor, levels: int, tile: int):
    """The kernel's algorithm in plain PyTorch: for each tile, every level's
    region (`tile_region`) from the one above by the 2x2 mean at clamped
    positions, then the Scharr taps inside the region. Same outputs as
    `pyramid_plain`; slow (a Python loop over tiles), for the CPU tests."""
    B, H, W = images.shape
    shapes = pyramid_shapes(H, W, levels)
    if tile % (1 << (levels - 1)) or tile & (tile - 1):
        raise ValueError(f"the tile must be a power of two and a multiple of "
                         f"{1 << (levels - 1)}, got {tile}")
    outs = [[torch.full((B, h, w), float("nan")) for h, w in shapes] for _ in range(4)]
    for y0 in range(0, H, tile):
        for x0 in range(0, W, tile):
            rows = tile_region(0, y0, tile, levels, H)
            cols = tile_region(0, x0, tile, levels, W)
            region = images[:, rows][:, :, cols]
            for l in range(levels):
                if l:
                    rows = tile_region(l, y0, tile, levels, H)
                    cols = tile_region(l, x0, tile, levels, W)
                    # Children of position c at level l are 2c, 2c+1 of level
                    # l-1, whose region starts at 2 * (first position of l).
                    r0 = 2 * ((y0 >> l) - (1 << (levels - 1 - l)))
                    c0 = 2 * ((x0 >> l) - (1 << (levels - 1 - l)))
                    ri = torch.tensor([2 * r - r0 for r in rows])
                    ci = torch.tensor([2 * c - c0 for c in cols])
                    p00 = region[:, ri][:, :, ci]
                    p01 = region[:, ri][:, :, ci + 1]
                    p10 = region[:, ri + 1][:, :, ci]
                    p11 = region[:, ri + 1][:, :, ci + 1]
                    region = (p00 + p01 + p10 + p11) * 0.25
                halo = 1 << (levels - 1 - l)
                ys, xs = tile_span(l, y0, tile, H), tile_span(l, x0, tile, W)
                gx, gy, gm = scharr_plain(region)
                inner = (slice(None), slice(halo, halo + len(ys)), slice(halo, halo + len(xs)))
                for out, val in zip(outs, (region, gx, gy, gm)):
                    out[l][:, ys.start:ys.stop, xs.start:xs.stop] = val[inner]
    images_out, gx, gy, gm = outs
    return (images, *images_out[1:]), tuple(gx), tuple(gy), tuple(gm)


def pyramid_plain(images: torch.Tensor, levels: int):
    """(B, H, W) f32 -> (images, gx, gy, gm), each a tuple over the levels of
    (B, H_l, W_l) tensors: `downsample2x` and `scharr_plain` level by level;
    images[0] is the input itself."""
    pyramid_shapes(*images.shape[-2:], levels)
    imgs = [images]
    for _ in range(levels - 1):
        imgs.append(downsample2x(imgs[-1]))
    grads = [scharr_plain(im) for im in imgs]
    return tuple(imgs), *(tuple(g[k] for g in grads) for k in range(3))


def _launch(images: torch.Tensor, levels: int):
    """One launch of the kernel -> what `pyramid_plain` returns, as views of
    one buffer per field (levels back to back)."""
    _lib.require(images, "images", (None, None, None), images.device)
    B, H, W = images.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"the batch must hold 1 to 65535 frames, got {B}")
    shapes, img_off, grad_off, n_img, n_grad = pyramid_layout(B, H, W, levels)
    out_img = torch.empty(n_img, device=images.device)
    gx, gy, gm = (torch.empty(n_grad, device=images.device) for _ in range(3))
    tile = pyramid_tile(B, H, W, levels)
    _lib.launch("uws_pyramid", images.device, images.data_ptr(), out_img.data_ptr(),
                gx.data_ptr(), gy.data_ptr(), gm.data_ptr(), B, H, W, levels, tile)

    def views(buf, offsets, shapes_):
        return tuple(buf[o:o + B * h * w].view(B, h, w) for o, (h, w) in zip(offsets, shapes_))

    return ((images, *views(out_img, img_off, shapes[1:])),
            *(views(g, grad_off, shapes) for g in (gx, gy, gm)))


def cuda_build_pyramid(images: torch.Tensor, levels: int):
    """(B, H, W) f32 -> (images, gx, gy, gm), each a tuple of `levels`
    (B, H_l, W_l) tensors: the plain version on a CPU tensor, one launch of
    the kernel on a CUDA tensor (contiguous f32; H and W divisible by
    2^(levels-1))."""
    if images.device.type == "cpu":
        return pyramid_plain(images, levels)
    out = _launch(images, levels)
    cuda_build_pyramid.launches += 1
    return out


cuda_build_pyramid.launches = 0


def scharr_gradients_batched(images: torch.Tensor):
    """(B, H, W) f32 -> (gx, gy, gm), each (B, H, W): K1 alone, the pyramid
    kernel at `levels=1`."""
    if images.device.type == "cpu":
        return scharr_plain(images)
    _, (gx,), (gy,), (gm,) = _launch(images, 1)
    scharr_gradients_batched.launches += 1
    return gx, gy, gm


scharr_gradients_batched.launches = 0
