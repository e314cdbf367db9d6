"""Image pyramids, Scharr gradients and bilinear sampling, in PyTorch.

Counterpart of `uwslam_tpu.image.pyramid` for frame batches: every field
of a `FramePyramid` holds (B, H_l, W_l) f32 tensors in [0, 255], one per
level. The 2x2 mean downsample is plain PyTorch (the JAX package also runs
it outside its kernel); the per-level gradients are kernel K1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_pyramid import scharr_gradients_batched, scharr_plain
from ..ops.cuda_sample import cuda_bilinear_sample

PYRAMID_LEVELS = 5


class FramePyramid(NamedTuple):
    images: tuple[torch.Tensor, ...]     # (B, H_l, W_l) intensity
    grad_x: tuple[torch.Tensor, ...]     # Scharr-x / 32
    grad_y: tuple[torch.Tensor, ...]     # Scharr-y / 32
    grad_mag: tuple[torch.Tensor, ...]   # 0.5|gx| + 0.5|gy|

    @property
    def levels(self) -> int:
        return len(self.images)

    def select(self, index) -> "FramePyramid":
        """The same pyramid restricted to frames `index` (e.g. a slice)."""
        return FramePyramid(*(tuple(x[index] for x in f) for f in self))


def downsample2x(image: torch.Tensor) -> torch.Tensor:
    """2x2 area mean of (..., H, W): the four taps are summed row-major, as
    the JAX package's reduction sums them."""
    *lead, H, W = image.shape
    x = image.reshape(*lead, H // 2, 2, W // 2, 2)
    s = x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]
    return s / 4.0


def scharr_gradients(image: torch.Tensor):
    """Scharr x/y derivatives of (..., H, W), edge-replicated, / 32."""
    gx, gy, _ = scharr_plain(image)
    return gx, gy


def build_pyramid_batched(
    images: torch.Tensor, levels: int = PYRAMID_LEVELS
) -> FramePyramid:
    """(B, H, W) f32 -> FramePyramid with `levels` levels. H and W must be
    divisible by 2^(levels-1)."""
    imgs = [images]
    for _ in range(levels - 1):
        imgs.append(downsample2x(imgs[-1]))
    grads = [scharr_gradients_batched(im) for im in imgs]
    return FramePyramid(
        images=tuple(imgs),
        grad_x=tuple(g[0] for g in grads),
        grad_y=tuple(g[1] for g in grads),
        grad_mag=tuple(g[2] for g in grads),
    )


def build_pyramid(image: torch.Tensor, levels: int = PYRAMID_LEVELS) -> FramePyramid:
    """One frame (H, W) f32 -> FramePyramid whose levels are batches of one,
    (1, H_l, W_l): `build_pyramid_batched` at B = 1, so kernel K1 runs on
    every live frame and the tracker takes the pyramid as it is."""
    return build_pyramid_batched(image[None], levels=levels)


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Bilinear interpolation of image (H, W) at uv (..., 2) -> (values (...),
    valid (...)); `fill` where (u, v) is outside [0, W-1] x [0, H-1]. Kernel
    K3 (C = 1) on a CUDA tensor, its plain version on a CPU one."""
    lead = uv.shape[:-1]
    out, valid = cuda_bilinear_sample(
        image.to(torch.float32)[None, None].contiguous(),
        uv.to(torch.float32).reshape(1, -1, 2).contiguous())
    out, valid = out.reshape(lead), valid.reshape(lead)
    return torch.where(valid, out, fill), valid
