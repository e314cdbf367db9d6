"""Bundle adjustment: Schur-complement LM over the keyframe window."""
from .schur import (
    BAProblem,
    BAResult,
    build_normal_equations,
    bundle_adjust,
    incidence,
    lm_passes,
    reproject_residuals,
    solve_schur,
)

__all__ = [
    "BAProblem",
    "BAResult",
    "build_normal_equations",
    "bundle_adjust",
    "incidence",
    "lm_passes",
    "reproject_residuals",
    "solve_schur",
]
