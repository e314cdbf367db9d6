"""Robust weighting of photometric residuals, batched over frame pairs.

Counterpart of `uwslam_tpu.tracking.robust`. Residuals are (B, N) with a
(B, N) validity mask; scales and costs are (B,). The median sorts with
invalid entries filled by +inf and reads the middle of the valid prefix.
"""
from __future__ import annotations

import enum

import torch

TUKEY_B = 4.6851
MAD_SCALE = 1.4826


class WeightKind(enum.Enum):
    NONE = "none"
    HUBER = "huber"
    TUKEY = "tukey"


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of x[valid] -> (...,)."""
    n = x.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    s = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    lo = torch.clamp((n_valid - 1) // 2, 0, n - 1)
    hi = torch.clamp(n_valid // 2, 0, n - 1)
    return (0.5 * (s.gather(-1, lo) + s.gather(-1, hi)))[..., 0]


def mad_sigma(residuals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Robust scale 1.4826 * median(|r - median(r)|) + 1e-6."""
    med = masked_median(residuals, valid)
    dev = torch.abs(residuals - med[..., None])
    return MAD_SCALE * masked_median(dev, valid) + 1e-6


def _count(valid: torch.Tensor) -> torch.Tensor:
    return torch.clamp(valid.sum(-1), min=1)


def weights(
    residuals: torch.Tensor,
    valid: torch.Tensor,
    kind: WeightKind = WeightKind.HUBER,
    huber_k: float = 1.345,
    min_sigma: float = 1.0,
    sigma: torch.Tensor | None = None,
) -> torch.Tensor:
    """IRLS weights w(r) (0 where invalid); sigma (...,) defaults to MAD."""
    if kind == WeightKind.NONE:
        return valid.to(residuals.dtype)
    if sigma is None:
        sigma = mad_sigma(residuals, valid)
    x = residuals / torch.clamp(sigma, min=min_sigma)[..., None]
    if kind == WeightKind.HUBER:
        w = torch.clamp(huber_k / torch.clamp(torch.abs(x), min=1e-12), max=1.0)
    elif kind == WeightKind.TUKEY:
        u = x / TUKEY_B
        w = torch.where(torch.abs(u) < 1.0, (1.0 - u * u) ** 2, 0.0)
    else:
        raise ValueError(kind)
    return torch.where(valid, w, 0.0)


def robust_cost(
    residuals: torch.Tensor,
    valid: torch.Tensor,
    kind: WeightKind = WeightKind.HUBER,
    huber_k: float = 1.345,
    min_sigma: float = 1.0,
    sigma: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean rho(r / sigma) * sigma^2 over the valid entries -> (...,): the
    M-estimator objective that the LM accept test compares."""
    if kind == WeightKind.NONE:
        c = 0.5 * residuals * residuals
        return torch.where(valid, c, 0.0).sum(-1) / _count(valid)
    if sigma is None:
        sigma = mad_sigma(residuals, valid)
    sigma = torch.clamp(sigma, min=min_sigma)[..., None]
    x = residuals / sigma
    if kind == WeightKind.HUBER:
        ax = torch.abs(x)
        c = torch.where(
            ax <= huber_k, 0.5 * x * x, huber_k * (ax - 0.5 * huber_k)
        )
    elif kind == WeightKind.TUKEY:
        u = x / TUKEY_B
        b2_6 = TUKEY_B * TUKEY_B / 6.0
        c = torch.where(
            torch.abs(u) < 1.0, b2_6 * (1.0 - (1.0 - u * u) ** 3), b2_6
        )
    else:
        raise ValueError(kind)
    c = c * sigma * sigma
    return torch.where(valid, c, 0.0).sum(-1) / _count(valid)
