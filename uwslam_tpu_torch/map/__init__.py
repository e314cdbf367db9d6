"""Keyframe window, landmark table and the feature-track graph."""
from .keyframes import Keyframe, KeyframeDecision, KeyframeStore, MapPoints
from .tracks import Track, TrackGraph

__all__ = ["Keyframe", "KeyframeDecision", "KeyframeStore", "MapPoints", "Track", "TrackGraph"]
