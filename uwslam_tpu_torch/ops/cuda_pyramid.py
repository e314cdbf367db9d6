"""K1: Scharr gradients of a frame batch (CUDA kernel `csrc/scharr.cu`).

Replaces the TPU kernel `uwslam_tpu/ops/pallas_pyramid.py:_scharr_kernel`
(launched by `scharr_gradients_batched`). The kernel is bound by HBM bytes:
it reads each pixel once and writes gx, gy and |g| (16 B per pixel), one
thread per output pixel, one launch per pyramid level.

`scharr_plain` is the same function in plain PyTorch. `scharr_gradients_batched`
runs it for a CPU tensor and launches the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib


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


def scharr_gradients_batched(images: torch.Tensor):
    """(B, H, W) f32 -> (gx, gy, gm), each (B, H, W)."""
    if images.device.type == "cpu":
        return scharr_plain(images)
    _lib.require(images, "images", (None, None, None), images.device)
    B, H, W = images.shape
    gx = torch.empty_like(images)
    gy = torch.empty_like(images)
    gm = torch.empty_like(images)
    with torch.cuda.device(images.device):
        err = _lib.library().uws_scharr(
            images.data_ptr(), gx.data_ptr(), gy.data_ptr(), gm.data_ptr(),
            B, H, W, _lib.stream(images),
        )
        _lib.check(err, "scharr")
    scharr_gradients_batched.launches += 1
    return gx, gy, gm


scharr_gradients_batched.launches = 0
