"""Direct photometric tracking over SE(3), batched over frame pairs."""
from .photometric import TrackResult, lm_level_ic, track
from .depth_prior import (
    DepthPrior,
    fill_prior,
    gauge_ratio,
    prior_from_points,
    propagate_prior,
    sample_prior,
    sample_prior_checked,
    triangulate_matches,
)
from .depth_refine import RefinedDepth, refine_inverse_depth, transfer_depths
from .points import TrackPoints, dense_points, patch_points, topk_gradient_points
from .robust import WeightKind, mad_sigma, masked_median, robust_cost, weights
from .sequence import (
    SequenceTracker,
    compose_trajectory,
    track_sequence,
    track_sequence_batched,
)

__all__ = [
    "DepthPrior",
    "RefinedDepth",
    "fill_prior",
    "gauge_ratio",
    "patch_points",
    "prior_from_points",
    "propagate_prior",
    "refine_inverse_depth",
    "sample_prior",
    "sample_prior_checked",
    "transfer_depths",
    "triangulate_matches",
    "SequenceTracker",
    "TrackPoints",
    "TrackResult",
    "WeightKind",
    "compose_trajectory",
    "dense_points",
    "lm_level_ic",
    "mad_sigma",
    "masked_median",
    "robust_cost",
    "topk_gradient_points",
    "track",
    "track_sequence",
    "track_sequence_batched",
    "weights",
]
