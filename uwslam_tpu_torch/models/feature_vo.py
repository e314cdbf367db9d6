"""Feature-based essential-matrix visual odometry.

Counterpart of `uwslam_tpu.models.feature_vo` (uw-slam's standalone
feature_detector binary, src/feature_detector.cpp:16-309: features and kNN
matching -> findEssentialMat -> recoverPose -> integrate the translation ->
triangulatePoints): Harris detection, patch descriptors, matching by one
product, batched 8-point essential RANSAC and cheirality pose recovery per
frame pair.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..camera.model import PinholeCamera
from ..features import (
    describe,
    detect_multiscale,
    draw_uniforms,
    essential_ransac,
    match_descriptors,
    recover_pose,
)
from ..features.ransac import NUM_HYPOTHESES
from ..image.pyramid import build_pyramid
from ..lie import se3


@dataclass
class FeatureVOState:
    T_wc: np.ndarray           # integrated pose (world <- camera)
    num_matches: int
    num_inliers: int
    points: np.ndarray | None  # triangulated points (frame of camera a)


@dataclass
class FeatureVO:
    """Frame-to-frame essential-matrix odometry with unit-scale translation
    (`translation_scale` fixes the monocular scale, like uw-slam's raw
    integration at src/feature_detector.cpp:272-273). Runs on the card
    unless `device` names another; the minimal samples of frame i come from
    a generator seeded with i."""

    cam: PinholeCamera
    per_level: int = 256
    detect_levels: int = 2
    ratio: float = 0.65
    translation_scale: float = 1.0
    device: str | torch.device = "cuda"
    _prev: tuple | None = None
    _T_wc: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    _frame_id: int = 0
    trajectory: list = field(default_factory=list)

    def _extract(self, image):
        img = torch.from_numpy(np.array(image, np.float32)).to(self.device)
        pyr = build_pyramid(img, levels=3)
        kps = detect_multiscale(
            [g[0] for g in pyr.grad_x], [g[0] for g in pyr.grad_y],
            per_level=self.per_level, levels=self.detect_levels,
        )
        desc = describe([im[0] for im in pyr.images], kps.uv, kps.level, kps.valid)
        return kps, desc

    def process_frame(self, image) -> FeatureVOState:
        cur = self._extract(image)
        state = FeatureVOState(T_wc=self._T_wc.copy(), num_matches=0, num_inliers=0,
                               points=None)
        if self._prev is not None:
            (kp_a, da), (kp_b, db) = self._prev, cur
            m = match_descriptors(da, db, kp_a.valid, kp_b.valid, self.ratio)
            dev = kp_a.uv.device
            f = torch.tensor([self.cam.fx, self.cam.fy], dtype=torch.float32, device=dev)
            c = torch.tensor([self.cam.cx, self.cam.cy], dtype=torch.float32, device=dev)
            xa = (kp_a.uv[m.idx_a] - c) / f
            xb = (kp_b.uv[m.idx_b] - c) / f
            gen = torch.Generator().manual_seed(self._frame_id)
            # 1 px threshold: keypoints are subpixel-refined, and the tight
            # truncation makes MSAC separate the basins of the planar ambiguity.
            res = essential_ransac(
                xa, xb, m.valid, draw_uniforms(xa.shape[0], NUM_HYPOTHESES, gen),
                threshold_norm=1.0 / float(self.cam.fx),
            )
            n_matches, n_inliers, ok = torch.stack(
                [m.valid.sum(), res.num_inliers, res.ok.long()]
            ).cpu().tolist()
            state.num_matches, state.num_inliers = int(n_matches), int(n_inliers)
            if ok:
                rec = recover_pose(res.F, xa, xb, res.inliers)
                T_rel = rec.T.cpu().numpy().copy()      # b <- a, |t| = 1
                T_rel[:3, 3] *= self.translation_scale
                # Integrate: T_wc_b = T_wc_a inv(T_rel).
                self._T_wc = se3.normalize(
                    torch.from_numpy(self._T_wc) @ se3.inverse(torch.from_numpy(T_rel))
                ).numpy()
                state.T_wc = self._T_wc.copy()
                state.points = rec.points.cpu().numpy()
        self._prev = cur
        self._frame_id += 1
        self.trajectory.append(state)
        return state
