"""Keyframe window, landmark table, the feature-track graph and loop closure."""
from .keyframes import Keyframe, KeyframeDecision, KeyframeStore, MapPoints
from .loop_closure import KeyframeRecord, LoopCloser, LoopConfig, LoopEdge
from .tracks import Track, TrackGraph

__all__ = ["Keyframe", "KeyframeDecision", "KeyframeRecord", "KeyframeStore", "LoopCloser",
           "LoopConfig", "LoopEdge", "MapPoints", "Track", "TrackGraph"]
