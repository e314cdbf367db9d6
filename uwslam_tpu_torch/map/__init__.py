"""Keyframe window and landmark table."""
from .keyframes import Keyframe, KeyframeDecision, KeyframeStore, MapPoints

__all__ = ["Keyframe", "KeyframeDecision", "KeyframeStore", "MapPoints"]
