"""Image pyramids, Scharr gradients and bilinear sampling, in PyTorch.

Counterpart of `uwslam_tpu.image.pyramid` for frame batches: every field
of a `FramePyramid` holds (B, H_l, W_l) f32 tensors in [0, 255], one per
level. On a CUDA tensor one launch of the pyramid kernel (K1 redesigned,
`ops/cuda_pyramid.py`) builds every level's image and gradients; on a CPU
tensor its plain version runs the 2x2 mean and the Scharr pass level by
level.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_pyramid import cuda_build_pyramid, downsample2x, scharr_gradients_batched
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


def scharr_gradients(image: torch.Tensor):
    """Scharr x/y derivatives of (..., H, W), edge-replicated, / 32."""
    *lead, H, W = image.shape
    gx, gy, _ = scharr_gradients_batched(image.reshape(-1, H, W).contiguous())
    return gx.reshape(image.shape), gy.reshape(image.shape)


def build_pyramid_batched(
    images: torch.Tensor, levels: int = PYRAMID_LEVELS
) -> FramePyramid:
    """(B, H, W) f32 -> FramePyramid with `levels` levels; one launch of the
    pyramid kernel on a CUDA tensor. H and W must be divisible by
    2^(levels-1). Level 0's image is `images` itself; on the card every
    other field is a view into one buffer per field."""
    imgs, gx, gy, gm = cuda_build_pyramid(images, levels)
    return FramePyramid(images=imgs, grad_x=gx, grad_y=gy, grad_mag=gm)


def build_pyramid(image: torch.Tensor, levels: int = PYRAMID_LEVELS) -> FramePyramid:
    """One frame (H, W) f32 -> FramePyramid whose levels are batches of one,
    (1, H_l, W_l): `build_pyramid_batched` at B = 1, so the pyramid kernel
    runs once on every live frame and the tracker takes the pyramid as it is."""
    return build_pyramid_batched(image[None], levels=levels)


def build_depth_pyramid(depth: torch.Tensor, levels: int = PYRAMID_LEVELS):
    """Depth pyramid of (..., H, W) depths: each level the 2x2 mean over the
    valid (> 0) depths of the block above, 0 where the block has none, so
    missing depth does not bleed into its neighbours -> tuple of `levels`
    tensors (the JAX package's `build_depth_pyramid`)."""
    depths = [depth]
    for _ in range(levels - 1):
        d = depths[-1]
        *lead, H, W = d.shape
        blocks = d.reshape(*lead, H // 2, 2, W // 2, 2)
        valid = (blocks > 0).to(d.dtype)
        num = (blocks * valid).sum(dim=(-3, -1))
        den = valid.sum(dim=(-3, -1))
        depths.append(torch.where(den > 0, num / den.clamp(min=1), 0.0))
    return tuple(depths)


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
