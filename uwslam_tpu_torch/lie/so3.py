"""SO(3) on (..., 3, 3) rotation matrices, in PyTorch.

Counterpart of `uwslam_tpu.lie.so3`: the same Taylor-guarded closed forms
(`_EPS = 1e-6`), so small angles and angles near pi stay finite. Every
function broadcasts over leading batch dimensions and works in f32 or f64.
"""
from __future__ import annotations

import math

import torch

# Small-angle threshold below which Taylor expansions are used. f32-safe.
_EPS = 1e-6
_EPS2 = _EPS * _EPS


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_theta(theta2: torch.Tensor) -> torch.Tensor:
    """sqrt clamped away from 0; the Taylor branches cover theta2 < _EPS^2."""
    return torch.sqrt(torch.where(theta2 < _EPS2, 1.0, theta2))


def _sinc2(theta2: torch.Tensor) -> torch.Tensor:
    """sin(t)/t as a function of t^2, Taylor-guarded at 0."""
    t = _safe_theta(theta2)
    return torch.where(theta2 < _EPS2, 1.0 - theta2 / 6.0, torch.sin(t) / t)


def _cosc2(theta2: torch.Tensor) -> torch.Tensor:
    """(1 - cos(t)) / t^2 as a function of t^2, Taylor-guarded at 0."""
    t = _safe_theta(theta2)
    small = theta2 < _EPS2
    return torch.where(
        small,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(t)) / torch.where(small, 1.0, theta2),
    )


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = torch.matmul(W, W)
    a = _sinc2(theta2)[..., None, None]
    b = _cosc2(theta2)[..., None, None]
    return _eye3(w) + a * W + b * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), robust across
    the full angle range (axis from the symmetric part near pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - R.transpose(-1, -2))
    n2 = torch.sum(antisym * antisym, dim=-1)     # (2 sin theta)^2
    small_sin = n2 < _EPS2                        # identity OR near pi
    sin_theta = 0.5 * torch.sqrt(torch.where(small_sin, 1.0, n2))
    theta_g = torch.atan2(sin_theta, cos_theta)
    near_pi = cos_theta < -0.99999
    generic_scale = torch.where(
        small_sin,
        0.5 + n2 / 48.0,
        theta_g / torch.where(small_sin, 1.0, 2.0 * sin_theta),
    )
    w_generic = antisym * generic_scale[..., None]
    theta = torch.where(
        near_pi,
        math.pi - torch.asin(torch.clamp(0.5 * torch.sqrt(n2 + 1e-24), 0.0, 1.0)),
        theta_g,
    )

    # Near pi: axis_i = sqrt((R_ii - cos) / (1 - cos)), signs from the
    # off-diagonal sums R_ij + R_ji = 2 axis_i axis_j (1 - cos).
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    denom = torch.where(
        torch.abs(1.0 - cos_theta) < 1e-12, 1.0, 1.0 - cos_theta
    )
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / denom[..., None], min=0.0
    )
    axis = torch.sqrt(axis_sq + 1e-12)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    one = torch.ones_like(s01)
    imax = torch.argmax(axis_sq, dim=-1)
    sx = torch.where(imax == 0, one, torch.where(imax == 1, s01, s02))
    sy = torch.where(imax == 0, s01, torch.where(imax == 1, one, s12))
    sz = torch.where(imax == 0, s02, torch.where(imax == 1, s12, one))
    signs = torch.stack([sx, sy, sz], dim=-1)
    signs = torch.where(signs == 0.0, 1.0, signs)
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def inverse(R: torch.Tensor) -> torch.Tensor:
    """Inverse rotation = transpose."""
    return R.transpose(-1, -2)


def compose(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    return torch.matmul(Ra, Rb)


def apply(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points: (..., 3, 3) x (..., 3) -> (..., 3)."""
    return torch.matmul(R, p[..., None])[..., 0]


def adjoint(R: torch.Tensor) -> torch.Tensor:
    """The adjoint of SO(3) is the rotation matrix itself."""
    return R


def interpolate(Ra: torch.Tensor, Rb: torch.Tensor, t) -> torch.Tensor:
    """Geodesic interpolation Ra exp(t log(Ra^-1 Rb)); `t` a number or a
    tensor of the batch shape."""
    rel = log(compose(inverse(Ra), Rb))
    return compose(Ra, exp(rel * torch.as_tensor(t, dtype=rel.dtype, device=rel.device)[..., None]))


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a drifting rotation: de-scale by the Frobenius
    estimate (the Newton step diverges for singular values > sqrt(3)), then
    two Newton steps of R <- R (3I - R^T R) / 2."""
    fro = torch.sqrt(torch.sum(R * R, dim=(-2, -1), keepdim=True) / 3.0)
    R = R / torch.clamp(fro, min=1e-12)
    eye = _eye3(R)
    for _ in range(2):
        RtR = torch.matmul(R.transpose(-1, -2), R)
        R = torch.matmul(R, 1.5 * eye - 0.5 * RtR)
    return R


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l = I + cosc(t) W + (1 - sinc(t))/t^2 W^2."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = torch.matmul(W, W)
    b = _cosc2(theta2)
    small = theta2 < _EPS2
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (1.0 - _sinc2(theta2)) / torch.where(small, 1.0, theta2),
    )
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inverse(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the left Jacobian; coefficient (1 - t/2 cot(t/2)) / t^2
    in half-angle form, Taylor 1/12 + t^2/720 at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = _safe_theta(theta2)
    W = hat(w)
    W2 = torch.matmul(W, W)
    small = theta2 < _EPS2
    half = 0.5 * theta
    cot_num = 1.0 - half * torch.cos(half) / torch.where(
        small, 1.0, torch.sin(half)
    )
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        cot_num / torch.where(small, 1.0, theta2),
    )
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * W2


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                dim=-1,
            ),
        ],
        dim=-2,
    )


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion [w, x, y, z] (..., 4),
    w >= 0: the four Shepperd candidates, the one of the largest pivot kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        inv = 0.5 / torch.sqrt(torch.clamp(t, min=1e-12))
        return torch.stack([a * inv, b * inv, c * inv, d * inv], dim=-1)

    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        cand(tw, tw, m21 - m12, m02 - m20, m10 - m01),
        cand(tx, m21 - m12, tx, m01 + m10, m02 + m20),
        cand(ty, m02 - m20, m01 + m10, ty, m12 + m21),
        cand(tz, m10 - m01, m02 + m20, m12 + m21, tz),
    ], dim=-2)                                        # (..., 4 candidates, 4)
    pivot = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q = torch.gather(cands, -2, pivot[..., None, None].expand(*pivot.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
