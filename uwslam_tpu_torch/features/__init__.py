"""Feature detection, description, matching, two-view geometry and PnP."""
from .descriptors import DESC_DIM, describe, projection_matrix
from .detect import Keypoints, detect_level, detect_multiscale, harris_response
from .geometry import RecoveredPose, decompose_essential, recover_pose, triangulate_linear
from .match import Matches, match_descriptors
from .pnp import PnPResult, pnp_from_pixels, pnp_ransac, sample_hypotheses
from .ransac import (
    RansacResult,
    draw_uniforms,
    essential_ransac,
    fundamental_ransac,
    sample_minimal,
    sampson_distance,
)

__all__ = [
    "DESC_DIM",
    "Keypoints",
    "Matches",
    "PnPResult",
    "RansacResult",
    "RecoveredPose",
    "decompose_essential",
    "draw_uniforms",
    "essential_ransac",
    "fundamental_ransac",
    "recover_pose",
    "sample_minimal",
    "sampson_distance",
    "triangulate_linear",
    "describe",
    "detect_level",
    "detect_multiscale",
    "harris_response",
    "match_descriptors",
    "pnp_from_pixels",
    "pnp_ransac",
    "projection_matrix",
    "sample_hypotheses",
]
