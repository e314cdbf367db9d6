"""Keyframe store and map points, in PyTorch.

Counterpart of `uwslam_tpu.map.keyframes`: `Keyframe` (device-resident
pyramid, tracked points, pose and relocalization features),
`KeyframeDecision` and `KeyframeStore` (the host-side sliding window with
its motion- and inlier-ratio-based insertion policy) and `MapPoints` (the
fixed-capacity landmark table of the BA problem).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..image.pyramid import FramePyramid
from ..lie import se3
from ..tracking.points import TrackPoints


class Keyframe(NamedTuple):
    frame_id: int
    timestamp: float
    T_wc: torch.Tensor                   # (4, 4) world <- camera
    pyramid: FramePyramid                # batch of one: (1, H_l, W_l) levels
    points: TrackPoints                  # tracked selection, (1, N, ...)
    kp_uv: torch.Tensor | None = None    # (K, 2) keypoints, level-0 coords
    kp_desc: torch.Tensor | None = None  # (K, 64)
    kp_valid: torch.Tensor | None = None
    kp_p3d: torch.Tensor | None = None   # (K, 3) in the keyframe's camera frame


@dataclass
class KeyframeDecision:
    """Thresholds for promoting a frame to keyframe."""

    min_inlier_ratio: float = 0.55   # below this, the view changed too much
    max_translation: float = 0.12    # meters (scaled units for mono)
    max_rotation: float = 0.10       # radians
    min_gap: int = 3                 # frames
    max_gap: int = 30


@dataclass
class KeyframeStore:
    """Sliding window of keyframes (host bookkeeping, device data)."""

    capacity: int = 10
    decision: KeyframeDecision = field(default_factory=KeyframeDecision)
    keyframes: list[Keyframe] = field(default_factory=list)
    _last_kf_frame_id: int = -10**9

    def __len__(self):
        return len(self.keyframes)

    @property
    def latest(self) -> Keyframe | None:
        return self.keyframes[-1] if self.keyframes else None

    def should_insert(
        self,
        frame_id: int,
        T_wc: torch.Tensor,
        inlier_ratio: float,
        rel_log: np.ndarray | None = None,
    ) -> bool:
        """rel_log: host copy of log(latest.T_wc^-1 T_wc) when the caller
        already has it (SlamSystem reads it from the frame's one diagnostics
        transfer); otherwise it is computed here at the cost of a transfer."""
        if not self.keyframes:
            return True
        gap = frame_id - self._last_kf_frame_id
        if gap < self.decision.min_gap:
            return False
        if gap >= self.decision.max_gap:
            return True
        if inlier_ratio < self.decision.min_inlier_ratio:
            return True
        if rel_log is None:
            rel_log = se3.log(
                se3.compose(se3.inverse(self.latest.T_wc), T_wc)
            ).cpu().numpy()
        t = float(np.linalg.norm(rel_log[:3]))
        r = float(np.linalg.norm(rel_log[3:]))
        return t > self.decision.max_translation or r > self.decision.max_rotation

    def insert(self, kf: Keyframe) -> Keyframe | None:
        """Insert; returns the evicted (oldest) keyframe, if any."""
        self.keyframes.append(kf)
        self._last_kf_frame_id = kf.frame_id
        if len(self.keyframes) > self.capacity:
            return self.keyframes.pop(0)
        return None

    def window_poses(self) -> torch.Tensor:
        return torch.stack([kf.T_wc for kf in self.keyframes])


@dataclass
class MapPoints:
    """Fixed-capacity landmark table (host allocation)."""

    capacity: int = 4096
    positions: np.ndarray = None    # (capacity, 3) world
    valid: np.ndarray = None
    _next: int = 0

    def __post_init__(self):
        if self.positions is None:
            self.positions = np.zeros((self.capacity, 3), np.float32)
        if self.valid is None:
            self.valid = np.zeros((self.capacity,), bool)

    def allocate(self, pts_world: np.ndarray) -> np.ndarray:
        """Add landmarks; returns their indices (wrapping around when full,
        recycling the oldest slots)."""
        n = len(pts_world)
        idx = (self._next + np.arange(n)) % self.capacity
        self.positions[idx] = pts_world
        self.valid[idx] = True
        self._next = int((self._next + n) % self.capacity)
        return idx

    def prune(self, idx: np.ndarray):
        self.valid[idx] = False
