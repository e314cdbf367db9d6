"""Small-matrix linear algebra of the relocalization path, in PyTorch.

Counterpart of the CPU branch of `uwslam_tpu.utils.linalg` (its `_on_cpu`
dispatch): LAPACK's eigh and svd there, `torch.linalg` here (LAPACK on a CPU
tensor, cuSOLVER on a CUDA tensor). The JAX package's fused TPU forms
(inverse subspace iteration, unrolled Jacobi, `svd3` from `sym3_eigh`) exist
only to avoid the TPU's eigh custom call and are not ported.

Eigen- and singular vectors come back with whatever sign the library picks,
as they do from LAPACK; every caller fixes signs itself.
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
