"""Bundle adjustment over the keyframe window: reprojection (Schur-complement
LM over poses and landmarks) and photometric (direct alignment over poses
and inverse depths); pose-graph optimization over SE(3) and Sim(3)."""
from .photometric import (
    PhotoBAProblem,
    PhotoBAResult,
    photo_ba_problem_from_keyframes,
    photometric_bundle_adjust,
)
from .pose_graph import (
    PGOResult,
    PoseGraph,
    Sim3PoseGraph,
    add_loop_edge,
    odometry_edges,
    optimize_pose_graph,
    optimize_pose_graph_sim3,
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
    "PGOResult",
    "PoseGraph",
    "Sim3PoseGraph",
    "add_loop_edge",
    "odometry_edges",
    "optimize_pose_graph",
    "optimize_pose_graph_sim3",
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
