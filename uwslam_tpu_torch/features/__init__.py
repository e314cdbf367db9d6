"""Feature detection, description, matching and PnP (relocalization)."""
from .descriptors import DESC_DIM, describe, projection_matrix
from .detect import Keypoints, detect_level, detect_multiscale, harris_response
from .match import Matches, match_descriptors
from .pnp import PnPResult, pnp_from_pixels, pnp_ransac, sample_hypotheses

__all__ = [
    "DESC_DIM",
    "Keypoints",
    "Matches",
    "PnPResult",
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
