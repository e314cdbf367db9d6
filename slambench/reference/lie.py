"""SE(3) for the reference: 4 x 4 matrices, twists [v, w]."""
from __future__ import annotations

import torch


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist (6,) -> (4, 4): R = exp(w) (Rodrigues), t = V(w) v."""
    v, w = xi[:3], xi[3:]
    theta2 = (w * w).sum()
    W = _hat(w)
    W2 = W @ W
    if float(theta2) < 1e-8:
        a, b, c = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0, 1.0 / 6.0 - theta2 / 120.0
    else:
        theta = torch.sqrt(theta2)
        a = torch.sin(theta) / theta
        b = (1.0 - torch.cos(theta)) / theta2
        c = (1.0 - a) / theta2
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = eye + a * W + b * W2
    T[:3, 3] = (eye + b * W + c * W2) @ v
    return T


def normalize_se3(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation: de-scale by the Frobenius norm, then
    two Newton steps R <- R (3 I - R^T R) / 2."""
    R = T[:3, :3]
    R = R / torch.clamp(torch.sqrt((R * R).sum() / 3.0), min=1e-12)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.t() @ R))
    out = T.clone()
    out[:3, :3] = R
    return out


def inverse(T: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    Rt = T[:3, :3].t()
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ T[:3, 3]
    return out


def gap(Ta: torch.Tensor, Tb: torch.Tensor) -> tuple[float, float]:
    """(translation, rotation angle in rad) of Ta^-1 Tb, in float64."""
    D = inverse(Ta.double()) @ Tb.double()
    c = torch.clamp((torch.trace(D[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    # near 0 the arc cosine loses digits: take the angle from the sine
    s = 0.5 * torch.stack([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]).norm()
    return float(D[:3, 3].norm()), float(torch.atan2(s, c))
