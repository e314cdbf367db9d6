"""Patch descriptors: normalized intensity patches projected to 64 dims.

Counterpart of `uwslam_tpu.features.descriptors.describe` for one frame.
Each keypoint's 8 x 8 patch (2 px spacing) is sampled bilinearly at every
pyramid level with kernel K3 (C = 1, one call per level), kept from its own
detection level, made zero-mean and unit-norm, and projected by a fixed
Gaussian matrix.

The projection is this path's only fixed data: the JAX package draws it
from `jax.random.normal(PRNGKey(1234), (64, 64)) / 8`. The port carries
those values in `descriptor_projection.npy` (package data, written once from
the JAX package; a test holds it equal), so no JAX is needed to run.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda_sample import cuda_bilinear_sample

PATCH = 8            # patch side length (samples)
PATCH_SPACING = 2.0  # sample spacing in pixels at the detection level
DESC_DIM = 64
PROJECTION_FILE = Path(__file__).resolve().parent / "descriptor_projection.npy"


@functools.cache
def _projection_numpy() -> np.ndarray:
    m = np.load(PROJECTION_FILE)
    if m.shape != (PATCH * PATCH, DESC_DIM) or m.dtype != np.float32:
        raise ValueError(f"{PROJECTION_FILE}: expected (64, 64) float32, got "
                         f"{m.shape} {m.dtype}")
    return m


def projection_matrix(device=None) -> torch.Tensor:
    """The (64, 64) f32 descriptor projection on `device`."""
    return torch.from_numpy(_projection_numpy().copy()).to(device)


def describe(
    image_pyr,
    uv: torch.Tensor,
    level: torch.Tensor,
    valid: torch.Tensor,
    proj: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, 64) L2-normalized descriptors, 0 where invalid or the patch
    leaves its level. image_pyr: (H_l, W_l) images; uv (K, 2) level-0
    coords; level (K,) detection levels; proj defaults to the carried
    projection."""
    K = uv.shape[0]
    dev = uv.device
    half = (PATCH - 1) / 2.0
    offs = (torch.arange(PATCH, dtype=torch.float32, device=dev) - half) * PATCH_SPACING
    du, dv = torch.meshgrid(offs, offs, indexing="xy")
    offsets = torch.stack([du.reshape(-1), dv.reshape(-1)], dim=-1)   # (64, 2)

    patches = torch.zeros((K, PATCH * PATCH), dtype=torch.float32, device=dev)
    ok = torch.zeros((K,), dtype=torch.bool, device=dev)
    for lvl, img in enumerate(image_pyr):
        coords = (uv / (1 << lvl))[:, None, :] + offsets[None, :, :]
        vals, inb = cuda_bilinear_sample(img[None, None], coords.reshape(1, -1, 2))
        sel = level == lvl
        patches = torch.where(sel[:, None], vals.reshape(K, -1), patches)
        ok = torch.where(sel, inb.reshape(K, -1).all(-1), ok)

    centered = patches - patches.mean(-1, keepdim=True)
    norm = torch.clamp(torch.linalg.vector_norm(centered, dim=-1, keepdim=True), min=1e-6)
    proj = projection_matrix(dev) if proj is None else proj
    desc = (centered / norm) @ proj
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-6)
    return torch.where((valid & ok)[:, None], desc, 0.0)
