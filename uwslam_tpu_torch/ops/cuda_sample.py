"""K3: bilinear sampling of C channels at given (u, v), for a batch of
frames (CUDA kernel `csrc/warp_sample.cu:uws_bilinear_sample`).

Replaces the TPU kernel `uwslam_tpu/ops/pallas_sample.py:_sample_kernel`
(wrapper `pallas_bilinear_sample`), which the IC reference pass uses at
every level above 0. The TPU kernel samples through a one-hot matmul; this
one is four f32 loads per point and channel with the CPU gather's
semantics, bound by those scattered loads, which stay in L1/L2 (a 640 x 480
f32 level is 1.2 MB).

`bilinear_sample_plain` is the same function in plain PyTorch.
`cuda_bilinear_sample` runs it for a CPU tensor and launches the kernel for
a CUDA tensor.
"""
from __future__ import annotations

import torch

from . import _lib


def bilinear_sample_plain(images: torch.Tensor, uv: torch.Tensor):
    """images (B, C, H, W), uv (B, N, 2) -> ((B, C, N) samples, (B, N) valid).

    The gather of `uwslam_tpu.image.pyramid.bilinear_sample`: valid = (u, v)
    inside [0, W-1] x [0, H-1]; the top-left tap is clamped to (W-2, H-2)
    while the weights come from the unclamped floor; samples are 0 where
    invalid."""
    B, C, H, W = images.shape
    u, v = uv[..., 0], uv[..., 1]
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    # Invalid points (NaN included) read pixel (0, 0) and are zeroed below.
    u = torch.where(valid, u, 0.0)
    v = torch.where(valid, v, 0.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[:, None, :]
    dv = (v - v0)[:, None, :]
    u0i = u0.to(torch.int64).clamp(0, W - 2)
    v0i = v0.to(torch.int64).clamp(0, H - 2)
    idx = (v0i * W + u0i)[:, None, :].expand(B, C, -1)
    flat = images.reshape(B, C, H * W)

    def tap(offset: int) -> torch.Tensor:
        return torch.gather(flat, 2, idx + offset)

    out = (
        tap(0) * (1 - du) * (1 - dv)
        + tap(1) * du * (1 - dv)
        + tap(W) * (1 - du) * dv
        + tap(W + 1) * du * dv
    )
    return torch.where(valid[:, None, :], out, 0.0), valid


def cuda_bilinear_sample(images: torch.Tensor, uv: torch.Tensor):
    """images (B, C, H, W) f32, uv (B, N, 2) f32 -> ((B, C, N), (B, N) bool)."""
    if images.device.type == "cpu":
        return bilinear_sample_plain(images, uv)
    dev = images.device
    _lib.require(images, "images", (None, None, None, None), dev)
    B, C, H, W = images.shape
    _lib.require(uv, "uv", (B, None, 2), dev)
    N = uv.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=dev)
    valid = torch.empty((B, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _lib.library().uws_bilinear_sample(
            images.data_ptr(), uv.data_ptr(), out.data_ptr(),
            valid.data_ptr(), B, C, H, W, N, _lib.stream(images),
        )
        _lib.check(err, "bilinear_sample")
    cuda_bilinear_sample.launches += 1
    return out, valid


cuda_bilinear_sample.launches = 0
