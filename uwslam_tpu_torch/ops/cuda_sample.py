"""K3: bilinear sampling of C channels at given (u, v), for a batch of
frames (CUDA kernel `csrc/warp_sample.cu:uws_bilinear_sample`).

Replaces the TPU kernel `uwslam_tpu/ops/pallas_sample.py:_sample_kernel`
(wrapper `pallas_bilinear_sample`), which the IC reference pass uses at
every level above 0. The TPU kernel samples through a one-hot matmul; this
one is a 4-tap f32 gather per point with the CPU gather's semantics, bound
by the bytes of its points, taps and outputs. Two image layouts: planar
(B, C, H, W), four scalar loads per channel; and texels (B, H, W, 4) =
{I, gx, gy, 0} (`pack_texels`), the three channels of the tracking path as
one 128-bit load per tap.

`bilinear_sample_plain` and `bilinear_sample_texels_plain` are the same
functions in plain PyTorch. `cuda_bilinear_sample` runs them for a CPU
tensor and launches the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from . import _lib


def pack_texels(image: torch.Tensor, grad_x: torch.Tensor, grad_y: torch.Tensor):
    """Three (B, H, W) planes -> (B, H, W, 4) texels {I, gx, gy, 0}: 16 bytes
    per pixel, so a tap of all three channels is one aligned 128-bit load."""
    return torch.stack([image, grad_x, grad_y, torch.zeros_like(image)], dim=-1)


def unpack_texels(texels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) texels -> a (B, 3, H, W) view of their three channels."""
    return texels[..., :3].permute(0, 3, 1, 2)


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


def bilinear_sample_texels_plain(texels: torch.Tensor, uv: torch.Tensor):
    """texels (B, H, W, 4), uv (B, N, 2) -> ((B, 3, N), (B, N) valid): the
    planar gather on the texels' three channels."""
    return bilinear_sample_plain(unpack_texels(texels), uv)


def sampled_image_shape(images: torch.Tensor, texels: bool, device) -> tuple:
    """Validate a kernel's image argument; -> (B, C, H, W). Texels must be
    (B, H, W, 4) and 16-byte aligned (C = 3)."""
    if not texels:
        _lib.require(images, "images", (None, None, None, None), device)
        return tuple(images.shape)
    _lib.require(images, "texels", (None, None, None, 4), device)
    if images.data_ptr() % 16:
        raise ValueError("texels must be 16-byte aligned")
    B, H, W, _ = images.shape
    return B, 3, H, W


def cuda_bilinear_sample(images: torch.Tensor, uv: torch.Tensor, texels: bool = False):
    """images (B, C, H, W) f32, or with texels=True (B, H, W, 4) f32 (C = 3);
    uv (B, N, 2) f32 -> ((B, C, N), (B, N) bool)."""
    if images.device.type == "cpu":
        plain = bilinear_sample_texels_plain if texels else bilinear_sample_plain
        return plain(images, uv)
    dev = images.device
    B, C, H, W = sampled_image_shape(images, texels, dev)
    _lib.require(uv, "uv", (B, None, 2), dev)
    if uv.data_ptr() % 8:
        raise ValueError("uv must be 8-byte aligned")
    N = uv.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=dev)
    valid = torch.empty((B, N), dtype=torch.bool, device=dev)
    _lib.launch("uws_bilinear_sample", dev, images.data_ptr(), uv.data_ptr(),
                out.data_ptr(), valid.data_ptr(), B, C, H, W, N, int(texels))
    cuda_bilinear_sample.launches += 1
    return out, valid


cuda_bilinear_sample.launches = 0
