"""Bundle adjustment over the keyframe window: reprojection (Schur-complement
LM over poses and landmarks) and photometric (direct alignment over poses
and inverse depths)."""
from .photometric import (
    PhotoBAProblem,
    PhotoBAResult,
    photo_ba_problem_from_keyframes,
    photometric_bundle_adjust,
)
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
    "PhotoBAProblem",
    "PhotoBAResult",
    "build_normal_equations",
    "bundle_adjust",
    "incidence",
    "lm_passes",
    "photo_ba_problem_from_keyframes",
    "photometric_bundle_adjust",
    "reproject_residuals",
    "solve_schur",
]
