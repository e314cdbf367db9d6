"""Direct photometric tracking over SE(3), batched over frame pairs."""
from .photometric import TrackResult, lm_level_ic, track
from .points import TrackPoints, dense_points, topk_gradient_points
from .robust import WeightKind, mad_sigma, masked_median, robust_cost, weights
from .sequence import (
    SequenceTracker,
    compose_trajectory,
    track_sequence,
    track_sequence_batched,
)

__all__ = [
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
