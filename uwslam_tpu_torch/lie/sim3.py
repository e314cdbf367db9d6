"""Sim(3) similarity transforms (rotation, translation and scale), in PyTorch.

Counterpart of `uwslam_tpu.lie.sim3`: the scale-drift-aware pose graph of
monocular loop closure uses it. A transform is a (..., 4, 4) matrix whose
upper-left block is s R; a twist is (..., 7) ordered [v, w, sigma] with
s = exp(sigma).

`_calc_W`'s closed form divides by theta and sigma. As in the JAX package,
theta comes from the polynomial theta^2 = w.w, and every branch that
`torch.where` discards divides only by a `safe_*` quantity that is 1 there,
so neither the value nor a forward-mode tangent of a discarded branch is
Inf or NaN: `torch.func.jacfwd` through `exp` and `log` stays finite at
theta -> 0 and sigma -> 0.
"""
from __future__ import annotations

import torch

from . import so3

_EPS = 1e-6


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rst(R: torch.Tensor, s, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from a rotation (..., 3, 3), a scale (...) and a
    translation (..., 3)."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1], s.shape)
    sR = (s[..., None, None] * R).expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([sR, t[..., None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def scale(T: torch.Tensor) -> torch.Tensor:
    """s from the sR block: det(sR) = s^3, the determinant in closed form
    (elementwise, so a CUDA graph can hold it)."""
    M = T[..., :3, :3]
    d = (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
         - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
         + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))
    return torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3] / scale(T)[..., None, None]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _calc_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The matrix W with t = W v: W = C I + B Omega + A Omega^2, its
    coefficients by the Sophus case analysis (sigma small or not, theta
    small or not), each guarded branch finite wherever it is discarded."""
    theta2 = torch.sum(w * w, dim=-1)
    small_theta = theta2 < _EPS * _EPS
    safe_theta2 = torch.where(small_theta, 1.0, theta2)
    safe_theta = torch.sqrt(safe_theta2)
    Omega = so3.hat(w)
    Omega2 = torch.matmul(Omega, Omega)
    s = torch.exp(sigma)

    small_sigma = torch.abs(sigma) < _EPS
    safe_sigma = torch.where(small_sigma, 1.0, sigma)
    sigma2 = sigma * sigma
    safe_sigma2 = torch.where(small_sigma, 1.0, sigma2)

    # C = (s - 1) / sigma, Taylor 1 + sigma / 2.
    C = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)

    cos_t = torch.cos(safe_theta)
    sin_t = torch.sin(safe_theta)

    B_s0 = torch.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_theta2)
    A_s0 = torch.where(small_theta, 1.0 / 6.0 - theta2 / 120.0,
                       (safe_theta - sin_t) / (safe_theta2 * safe_theta))

    denom_g = torch.where(small_sigma, 1.0, sigma2 + theta2)
    B_g_t0 = ((sigma - 1.0) * s + 1.0) / safe_sigma2
    A_g_t0 = ((0.5 * sigma2 - sigma + 1.0) * s - 1.0 - 0.5 * sigma2) / (safe_sigma2 * safe_sigma)
    a_gg = s * sin_t
    b_gg = s * cos_t
    B_gg = (a_gg * sigma + (1.0 - b_gg) * safe_theta) / (safe_theta * denom_g)
    A_gg = (C - ((b_gg - 1.0) * sigma + a_gg * safe_theta) / denom_g) / safe_theta2

    B = torch.where(small_sigma, B_s0, torch.where(small_theta, B_g_t0, B_gg))
    A = torch.where(small_sigma, A_s0, torch.where(small_theta, A_g_t0, A_gg))

    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return C[..., None, None] * eye + B[..., None, None] * Omega + A[..., None, None] * Omega2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 7) [v, w, sigma] -> Sim(3) matrix (..., 4, 4)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _calc_W(w, sigma)
    t = torch.matmul(W, v[..., None])[..., 0]
    return from_rst(so3.exp(w), torch.exp(sigma), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """Sim(3) matrix (..., 4, 4) -> twist (..., 7) [v, w, sigma]."""
    s = scale(T)
    sigma = torch.log(s)
    w = so3.log(T[..., :3, :3] / s[..., None, None])
    W = _calc_W(w, sigma)
    # solve_ex leaves `info` on the device (a CUDA graph may hold it).
    v = torch.linalg.solve_ex(W, translation(T)[..., None]).result[..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    s = scale(T)
    Rt = (T[..., :3, :3] / s[..., None, None]).transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * torch.matmul(Rt, translation(T)[..., None])[..., 0]
    return from_rst(Rt, s_inv, t_inv)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return torch.matmul(Ta, Tb)


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return torch.matmul(T[..., :3, :3], p[..., None])[..., 0] + translation(T)
