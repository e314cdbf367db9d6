"""SE(3) on (..., 4, 4) homogeneous matrices, in PyTorch.

Counterpart of `uwslam_tpu.lie.se3`. Twists are (..., 6) ordered [v, w]
(translation first); exp/log share the Taylor-guarded SO(3) forms.
"""
from __future__ import annotations

import torch

from . import so3


def identity(batch: tuple[int, ...] = (), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(*batch, 4, 4).clone()


def from_rotation_translation(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> transform (..., 4, 4): R = exp(w), t = V(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3.exp(w)
    t = so3.apply(so3.left_jacobian(w), v)
    return from_rotation_translation(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """Transform (..., 4, 4) -> twist (..., 6) [v, w]."""
    w = so3.log(rotation(T))
    v = so3.apply(so3.left_jacobian_inverse(w), translation(T))
    return torch.cat([v, w], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse [R^T, -R^T t]."""
    Rt = rotation(T).transpose(-1, -2)
    return from_rotation_translation(Rt, -so3.apply(Rt, translation(T)))


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return torch.matmul(Ta, Tb)


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return so3.apply(rotation(T), p) + translation(T)


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block after compose chains."""
    return from_rotation_translation(
        so3.normalize(rotation(T)), translation(T)
    )


def right_update(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Update T <- normalize(T * exp(delta))."""
    return normalize(compose(T, exp(delta)))
