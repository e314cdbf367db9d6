"""Small-matrix linear algebra of the feature front end, in PyTorch.

Counterpart of `uwslam_tpu.utils.linalg`, whose functions each have two
branches: LAPACK's eigh and svd on the CPU, and fused forms (inverse
subspace iteration, unrolled cyclic Jacobi, an SVD built on it) on the
accelerator. Here the two are separate functions, and each caller names
the one it runs on every device:

- `smallest_eigvec_spd`, `sym3_eigh` and `svd3` are `torch.linalg` (LAPACK
  for a CPU tensor, cuSOLVER for a CUDA tensor). The relocalization path
  (`features.pnp`) uses them.
- `smallest_eigvec_subspace`, `sym3_eigh_jacobi` and `svd3_jacobi` are the
  fused forms: elementwise operations and small products only, no `info`
  read on the host and no library workspace, so a CUDA graph can hold
  them. The two-view geometry (`features.ransac`, `features.geometry`)
  uses them, since the bootstrap frame runs it inside a captured graph;
  the CPU runs the same forms, so a CPU run is the card's reference.

Eigen- and singular vectors come back with whatever sign the method gives;
every caller fixes signs itself or is invariant to them.
"""
from __future__ import annotations

import torch


def cholesky_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the small SPD systems A x = b, A (..., n, n), b (..., n), by an
    unrolled Cholesky whose pivots are clamped at 1e-20 (the JAX package's
    exact operation order; torch.linalg.cholesky would raise where the
    clamp acts)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n                      # forward solve L y = b
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n                      # back solve L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_spd(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    return torch.linalg.eigh(A).eigenvectors[..., :, 0]


def sym3_eigh(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), eigenvectors as columns (..., 3, 3))."""
    return torch.linalg.eigh(A)


def svd3(F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, singular values descending, Vt) of (..., 3, 3)."""
    return torch.linalg.svd(F)


def _parity(n: int, like: torch.Tensor) -> torch.Tensor:
    """(+1, -1, +1, ...) of length n."""
    return 1.0 - 2.0 * (torch.arange(n, device=like.device) % 2).to(like.dtype)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)


def _cholesky_columns(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD (..., n, n), a column at a time (each
    column one vector operation), pivots clamped at 1e-20."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        L[..., j:, j] = s / torch.sqrt(torch.clamp(s[..., :1], min=1e-20))
    return L


def _cholesky_solve_columns(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L L^T X = B for B (..., n, m) by forward and back substitution,
    a row of X at a time."""
    n = L.shape[-1]
    y: list[torch.Tensor] = []
    for i in range(n):
        s = B[..., i, :]
        if i:
            s = s - (L[..., i, :i, None] * torch.stack(y, dim=-2)).sum(-2)
        y.append(s / L[..., i, i, None])
    x: list[torch.Tensor] = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        if i < n - 1:
            s = s - (L[..., i + 1:, i, None] * torch.stack(x[i + 1:], dim=-2)).sum(-2)
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def smallest_eigvec_subspace(A: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a small symmetric PSD
    (..., n, n) by inverse iteration on a 2-dimensional subspace with a
    closed-form Rayleigh-Ritz extraction. Each step solves
    (A + eps tr(A) I) X = X_prev through one Cholesky factor and
    re-orthogonalizes. Tracking two vectors converges like (l2 / l3)^k where
    single-vector iteration stalls: a low-parallax DLT whose two smallest
    eigenvalues are both tiny."""
    n = A.shape[-1]
    dt, dev = A.dtype, A.device
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    L = _cholesky_columns(A + (1e-7 * tr + 1e-30) * torch.eye(n, dtype=dt, device=dev))
    ramp = torch.arange(n, dtype=dt, device=dev)
    sign = _parity(n, A)
    batch = A.shape[:-2]
    x = (1.0 + 1e-2 * ramp).expand(*batch, n)
    y = (sign + 3e-2 * ramp).expand(*batch, n)

    def orth(x, y):
        x = _unit(x)
        y = y - (x * y).sum(-1, keepdim=True) * x
        ny = torch.linalg.norm(y, dim=-1, keepdim=True)
        # Collapse guard: restart y off-axis from x.
        alt = torch.roll(x, 1, dims=-1) * sign
        alt = _unit(alt - (x * alt).sum(-1, keepdim=True) * x)
        return x, torch.where(ny > 1e-12, y / torch.clamp(ny, min=1e-30), alt)

    x, y = orth(x, y)
    for _ in range(iters):
        xy = _cholesky_solve_columns(L, torch.stack([x, y], dim=-1))
        x, y = orth(xy[..., 0], xy[..., 1])
    # Rayleigh-Ritz on span{x, y}: the smallest eigenvector of the projected
    # 2x2 matrix [[a, b], [b, c]] in closed form.
    Ax = torch.matmul(A, x[..., None])[..., 0]
    Ay = torch.matmul(A, y[..., None])[..., 0]
    a = (x * Ax).sum(-1)
    b = (x * Ay).sum(-1)
    c = (y * Ay).sum(-1)
    diff = 0.5 * (a - c)
    lam = 0.5 * (a + c) - torch.sqrt(diff * diff + b * b)
    # (a - lam) alpha + b beta = 0 -> (alpha, beta) ~ (b, lam - a)
    # b alpha + (c - lam) beta = 0 -> (alpha, beta) ~ (lam - c, b)
    use1 = torch.abs(a - lam) >= torch.abs(c - lam)
    alpha = torch.where(use1, b, lam - c)
    beta = torch.where(use1, lam - a, b)
    nrm = torch.sqrt(alpha * alpha + beta * beta)
    # Degenerate 2x2 (b ~ 0, a ~ c): x and y are both eigenvectors; keep x.
    alpha = torch.where(nrm > 1e-20, alpha / torch.clamp(nrm, min=1e-30), 1.0)
    beta = torch.where(nrm > 1e-20, beta / torch.clamp(nrm, min=1e-30), 0.0)
    return _unit(alpha[..., None] * x + beta[..., None] * y)


def sym3_eigh_jacobi(A: torch.Tensor, sweeps: int = 6) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., 3, 3) by unrolled cyclic Jacobi
    -> (eigenvalues ascending, unit eigenvectors as columns). Six sweeps
    reach f32 precision."""
    d = [A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]]
    o = {(0, 1): A[..., 0, 1], (0, 2): A[..., 0, 2], (1, 2): A[..., 1, 2]}
    one, zero = torch.ones_like(d[0]), torch.zeros_like(d[0])
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def rot(p, q, r):
        """Zero o[(p, q)] by a Givens rotation; update row and column r."""
        apq = o[(p, q)]
        tau = (d[q] - d[p]) / (2.0 * torch.where(apq == 0, 1.0, apq))
        # A sign without zero: sign(0) = 0 would stall the 45-degree case.
        sgn = torch.where(tau >= 0, 1.0, -1.0)
        t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(apq == 0, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        d[p], d[q] = d[p] - t * apq, d[q] + t * apq
        o[(p, q)] = torch.zeros_like(apq)
        kp, kq = (min(r, p), max(r, p)), (min(r, q), max(r, q))
        arp, arq = o[kp], o[kq]
        o[kp] = c * arp - s * arq
        o[kq] = s * arp + c * arq
        for i in range(3):
            vip, viq = V[i][p], V[i][q]
            V[i][p] = c * vip - s * viq
            V[i][q] = s * vip + c * viq

    for _ in range(sweeps):
        rot(0, 1, 2)
        rot(0, 2, 1)
        rot(1, 2, 0)

    # Ascending order by an explicit swap network.
    cols = [[V[0][j], V[1][j], V[2][j]] for j in range(3)]

    def swap(j, k):
        lt = d[j] <= d[k]
        d[j], d[k] = torch.where(lt, d[j], d[k]), torch.where(lt, d[k], d[j])
        for r in range(3):
            cj, ck = cols[j][r], cols[k][r]
            cols[j][r] = torch.where(lt, cj, ck)
            cols[k][r] = torch.where(lt, ck, cj)

    swap(0, 1)
    swap(1, 2)
    swap(0, 1)
    w = torch.stack(d, dim=-1)
    Vs = torch.stack(
        [torch.stack([cols[j][r] for j in range(3)], dim=-1) for r in range(3)], dim=-2
    )
    return w, Vs


def svd3_jacobi(F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of (..., 3, 3) -> (U, singular values descending, Vt), built on
    `sym3_eigh_jacobi` of F^T F: U_i = F v_i / s_i for the two leading
    columns, completed by their cross product (exact for the rank-2 matrices
    decomposed here, right for full rank up to the signs any SVD leaves
    free). Singular values are |F v_i|, not square roots of eigenvalues,
    which would lose half the mantissa."""
    _, V = sym3_eigh_jacobi(torch.matmul(F.transpose(-1, -2), F))
    Vd = torch.flip(V, dims=(-1,))          # columns by descending singular value
    FV = torch.matmul(F, Vd)                # columns F v_i
    u0, u1, u2f = FV[..., :, 0], FV[..., :, 1], FV[..., :, 2]
    s = torch.linalg.norm(FV, dim=-2)
    u0 = _unit(u0)
    u1 = _unit(u1 - (u1 * u0).sum(-1, keepdim=True) * u0)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    # Align u2 with F v2 so that full-rank inputs reconstruct.
    u2 = u2 * torch.where((u2 * u2f).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.stack([u0, u1, u2], dim=-1), s, Vd.transpose(-1, -2)
