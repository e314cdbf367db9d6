"""Corner detection: Harris response, max-pool NMS, top-K, in PyTorch.

Counterpart of `uwslam_tpu.features.detect` (`_box_blur`, `harris_response`,
`nms_maxpool`, `detect_level`, `detect_multiscale`) for one frame. Runs only
when a keyframe is made or a frame is lost (relocalization).

Two orders are reproduced so that keypoints equal the JAX CPU output:
- the box filter's cumulative sums use XLA's CPU scan (blocks of 16 summed
  in order, block totals scanned the same way, recursively) with every add
  a separate elementwise op, and its mean is a true division, so CPU and
  card round alike (`torch.cumsum` sums in order and moves keypoints by
  whole pixels, tests/test_torch_features.py);
- `lax.top_k` breaks ties toward the lower index; a stable descending sort
  does the same (NMS plateaus and the suppressed -inf entries tie).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_SCAN_BLOCK = 16


class Keypoints(NamedTuple):
    uv: torch.Tensor      # (K, 2) f32 level-0 pixel coords
    score: torch.Tensor   # (K,) f32 corner response (0 where invalid)
    level: torch.Tensor   # (K,) int32 source pyramid level
    valid: torch.Tensor   # (K,) bool


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, one add per step, in order."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's cumulative sum over the last axis: in-order sums within
    blocks of 16, plus the scanned totals of the blocks before."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(x)
    nb = -(-n // _SCAN_BLOCK)
    xp = F.pad(x, (0, nb * _SCAN_BLOCK - n))
    inner = _sequential_cumsum(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    totals = _scan_last(inner[..., -1])
    carry = F.pad(totals[..., :-1], (1, 0))
    return (inner + carry[..., None]).reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _scan_last(x.transpose(dim, -1)).transpose(dim, -1)


def _box_blur(x: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """(2r+1)^2 box mean of (..., H, W) with edge replication, by cumulative
    sums along rows, then columns."""
    k = 2 * radius + 1
    lead = x.shape[:-2]
    pad = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (radius,) * 4, mode="replicate")
    pad = pad.reshape(*lead, *pad.shape[-2:])
    c = _cumsum(pad, -2)
    c = torch.cat([c[..., k - 1:k, :], c[..., k:, :] - c[..., :-k, :]], dim=-2)
    c = _cumsum(c, -1)
    c = torch.cat([c[..., k - 1:k], c[..., k:] - c[..., :-k]], dim=-1)
    # Divide by a device tensor: CUDA turns division by a Python scalar into
    # multiplication by its reciprocal, which rounds unlike true division.
    return c / torch.full((), float(k * k), device=c.device)


def harris_response(
    grad_x: torch.Tensor,
    grad_y: torch.Tensor,
    k: float = 0.04,
    window_radius: int = 2,
    shi_tomasi: bool = False,
) -> torch.Tensor:
    """Harris (det - k tr^2) or Shi-Tomasi (min eigenvalue) response of
    (H, W) gradients. The three structure-tensor products are blurred as
    one stack."""
    prods = torch.stack([grad_x * grad_x, grad_y * grad_y, grad_x * grad_y])
    ixx, iyy, ixy = _box_blur(prods, window_radius)
    if shi_tomasi:
        tr = ixx + iyy
        disc = torch.sqrt(torch.clamp((ixx - iyy) ** 2 + 4 * ixy * ixy, min=0.0))
        return 0.5 * (tr - disc)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def nms_maxpool(response: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Keep pixels equal to the max of their (2r+1)^2 window (-inf padded)."""
    k = 2 * radius + 1
    m = F.max_pool2d(response[None, None], k, stride=1, padding=radius)[0, 0]
    return torch.where(response >= m, response, -torch.inf)


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: ties go to the lower index."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, order), order


def detect_level(
    grad_x: torch.Tensor,
    grad_y: torch.Tensor,
    max_keypoints: int = 512,
    min_response_rel: float = 1e-3,
    border: int = 8,
    shi_tomasi: bool = False,
):
    """Corners of one level (H, W) -> (uv (K, 2), score (K,), valid (K,)).

    Threshold relative to the 87th-percentile top-K response (score[K/8]);
    positions refined to subpixel by 1-D parabolas through the raw (pre-NMS)
    response along u and v."""
    H, W = grad_x.shape
    dev = grad_x.device
    raw = harris_response(grad_x, grad_y, shi_tomasi=shi_tomasi)
    resp = nms_maxpool(raw)
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    interior = (row >= border) & (row < H - border) & (col >= border) & (col < W - border)
    resp = torch.where(interior, resp, -torch.inf)
    score, idx = _top_k(resp.reshape(-1), max_keypoints)
    vi = idx // W
    ui = idx % W
    vc = torch.clamp(vi, 1, H - 2)
    uc = torch.clamp(ui, 1, W - 2)
    c = raw[vc, uc]
    lu, ru = raw[vc, uc - 1], raw[vc, uc + 1]
    lv, rv = raw[vc - 1, uc], raw[vc + 1, uc]
    denom_u = lu - 2.0 * c + ru
    denom_v = lv - 2.0 * c + rv
    du = torch.clamp(torch.where(torch.abs(denom_u) > 1e-9, 0.5 * (lu - ru) / denom_u, 0.0),
                     -0.5, 0.5)
    dv = torch.clamp(torch.where(torch.abs(denom_v) > 1e-9, 0.5 * (lv - rv) / denom_v, 0.0),
                     -0.5, 0.5)
    uv = torch.stack([ui.float() + du, vi.float() + dv], dim=-1)
    anchor = score[max_keypoints // 8]
    thresh = torch.clamp(anchor * min_response_rel, min=1e-9)
    valid = torch.isfinite(score) & (score > thresh)
    return uv, torch.where(valid, score, 0.0), valid


def detect_multiscale(
    grad_x_pyr,
    grad_y_pyr,
    per_level: int = 256,
    levels: int = 3,
    min_response_rel: float = 1e-3,
) -> Keypoints:
    """Detect on the first `levels` pyramid levels ((H_l, W_l) gradients);
    coordinates scaled to level 0. Capacity per_level * levels."""
    uvs, scores, lvls, valids = [], [], [], []
    for lvl in range(levels):
        uv, sc, va = detect_level(
            grad_x_pyr[lvl], grad_y_pyr[lvl],
            max_keypoints=per_level, min_response_rel=min_response_rel,
        )
        uvs.append(uv * (1 << lvl))
        scores.append(sc)
        lvls.append(torch.full((per_level,), lvl, dtype=torch.int32, device=uv.device))
        valids.append(va)
    return Keypoints(
        uv=torch.cat(uvs), score=torch.cat(scores),
        level=torch.cat(lvls), valid=torch.cat(valids),
    )
