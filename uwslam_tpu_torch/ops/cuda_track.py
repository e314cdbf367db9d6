"""K2: warp -> project -> bilinear sample for a batch of frame pairs (CUDA
kernel `csrc/warp_sample.cu:uws_warp_sample`).

Replaces the TPU kernel `uwslam_tpu/ops/pallas_track.py:_kernel` (wrapper
`warp_and_sample`), the work of every inverse-compositional LM iteration.
One pose per pair, one thread per point. The TPU kernel samples through a
bf16 one-hot matmul; this one is four f32 loads per point and channel with
the CPU gather's semantics, bound by those scattered loads, which stay in
L1/L2 (a 640 x 480 f32 level is 1.2 MB).

`warp_and_sample_plain` is the same function in plain PyTorch.
`warp_and_sample` runs it for a CPU tensor and launches the kernel for a
CUDA tensor.
"""
from __future__ import annotations

import torch

from . import _lib
from .cuda_sample import bilinear_sample_plain


def warp_and_sample_plain(images, p3d, T, cam):
    """images (B, C, H, W), p3d (B, N, 3) reference-camera points, T (B, 4, 4)
    (target <- reference) -> ((B, C, N) samples, (B, N) valid).

    p_t = R p + t is written out term by term, in the kernel's order; valid =
    z > 1e-3 and the projection inside [0, W-1] x [0, H-1]; samples are 0
    where invalid."""
    px, py, pz = p3d[..., 0], p3d[..., 1], p3d[..., 2]

    def row(i: int) -> torch.Tensor:
        r = T[:, i, :, None]   # (B, 4, 1): R_i0, R_i1, R_i2, t_i
        return r[:, 0] * px + r[:, 1] * py + r[:, 2] * pz + r[:, 3]

    p_t = torch.stack([row(0), row(1), row(2)], dim=-1)
    vals, in_img = bilinear_sample_plain(images, cam.project(p_t))
    ok = in_img & (p_t[..., 2] > 1e-3)
    return torch.where(ok[:, None, :], vals, 0.0), ok


def warp_and_sample(images, p3d, T, cam):
    """images (B, C, H, W) f32, p3d (B, N, 3) f32, T (B, 4, 4) f32 ->
    ((B, C, N) f32, (B, N) bool). `cam` is the level's PinholeCamera."""
    if images.device.type == "cpu":
        return warp_and_sample_plain(images, p3d, T, cam)
    dev = images.device
    _lib.require(images, "images", (None, None, None, None), dev)
    B, C, H, W = images.shape
    _lib.require(p3d, "p3d", (B, None, 3), dev)
    _lib.require(T, "T", (B, 4, 4), dev)
    N = p3d.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=dev)
    valid = torch.empty((B, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _lib.library().uws_warp_sample(
            images.data_ptr(), p3d.data_ptr(), T.data_ptr(), out.data_ptr(),
            valid.data_ptr(), B, C, H, W, N,
            cam.fx, cam.fy, cam.cx, cam.cy, _lib.stream(images),
        )
        _lib.check(err, "warp_sample")
    warp_and_sample.launches += 1
    return out, valid


warp_and_sample.launches = 0
