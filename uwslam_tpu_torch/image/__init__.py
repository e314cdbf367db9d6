"""Image pyramids, gradients, sampling."""
from .pyramid import (
    PYRAMID_LEVELS,
    FramePyramid,
    bilinear_sample,
    build_pyramid_batched,
    downsample2x,
    scharr_gradients,
)

__all__ = [
    "PYRAMID_LEVELS",
    "FramePyramid",
    "bilinear_sample",
    "build_pyramid_batched",
    "downsample2x",
    "scharr_gradients",
]
