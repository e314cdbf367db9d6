"""SlamSystem: the live per-frame pipeline of configuration 1.

Counterpart of the synchronous path of `uwslam_tpu.system.SlamSystem` with
the switches configuration 1 uses: monocular frames without rectification
(cropped to a multiple of 2^(levels-1)), photometric tracking (FC by
default) with a constant-velocity prior, keyframes, and failure detection
with relocalization (feature detection on every keyframe, descriptor
matching and PnP-RANSAC for a lost frame). Every other switch of
`SlamConfig` raises NotImplementedError naming the ROADMAP item that will
port it, as do a depth image and a calibration that needs rectification.

Per frame the device runs: ingest (upload, crop, pyramid with kernel K1),
tracking (kernels K3 and K2), point selection and, on keyframes, feature
detection and description (K3). The host reads one packed diagnostics
vector per frame (42 floats: inlier count, point capacity, error,
finiteness, the new world pose, the pose relative to the keyframe and its
log); keyframes, lost frames and relocalization read a few more values.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .camera.calibration import Calibration
from .camera.model import PinholeCamera
from .config import SlamConfig, unported
from .features import (
    describe,
    detect_multiscale,
    match_descriptors,
    pnp_from_pixels,
    sample_hypotheses,
)
from .image.pyramid import FramePyramid, build_pyramid
from .io.trajectory import write_trajectory_tum
from .lie import se3
from .map.keyframes import Keyframe, KeyframeDecision, KeyframeStore
from .tracking.photometric import track
from .tracking.points import _depth_at, topk_gradient_points
from .utils.profiling import StageTimer

PNP_HYPOTHESES = 128


@dataclass
class FrameState:
    """Per-frame results. Poses are also kept relative to the frame's
    reference keyframe (`T_kf_frame`), so that the exported trajectory
    follows later corrections of keyframe poses."""

    frame_id: int
    timestamp: float
    T_wc: np.ndarray          # world <- camera, as tracked live
    tracked_inliers: int
    track_error: float
    is_keyframe: bool
    ref_kf_id: int = -1
    T_kf_frame: np.ndarray | None = None   # ref-kf <- frame
    status: str = "ok"        # "ok" | "lost" | "relocalized"


def _refuse_unported(config: SlamConfig, calibration: Calibration) -> None:
    checks = (
        (config.use_features, "use_features (the feature front-end, config 2)",
         "slice 4, item 14"),
        (config.tracker.depth_bootstrap, "tracker.depth_bootstrap (the depth prior)",
         "slice 3, item 11"),
        (config.use_ba, "use_ba (window bundle adjustment)", "slice 6, item 16"),
        (config.use_loop_closure, "use_loop_closure", "slice 7, item 17"),
        (config.global_ba, "global_ba (global distributed BA)", "slice 7, item 17"),
        (config.tracker.point_mode == "dense", "tracker.point_mode='dense'",
         "slice 1, item 5"),
        (calibration.needs_rectification,
         "a calibration with lens distortion (rectification)", "slice 5, item 15"),
    )
    for is_set, what, item in checks:
        if is_set:
            raise unported(what, item)


class SlamSystem:
    """Monocular direct SLAM, configuration 1, on one torch device."""

    def __init__(
        self,
        calibration: Calibration,
        config: SlamConfig | None = None,
        device: str | torch.device = "cpu",
    ):
        self.config = config or SlamConfig()
        _refuse_unported(self.config, calibration)
        self.device = torch.device(device)
        raw = calibration.raw
        # Crop to a multiple of 2^(levels-1) so every pyramid level halves
        # exactly (uw-slam requires even sizes, src/System.cpp:81-89).
        div = 1 << (self.config.tracker.pyramid_levels - 1)
        w = raw.width - raw.width % div
        h = raw.height - raw.height % div
        self._roi = (0, 0, w, h)
        self.cam = PinholeCamera(fx=raw.fx, fy=raw.fy, cx=raw.cx, cy=raw.cy,
                                 width=w, height=h)
        kcfg = self.config.keyframes
        self.keyframes = KeyframeStore(
            capacity=kcfg.window_size,
            decision=KeyframeDecision(
                min_inlier_ratio=kcfg.min_inlier_ratio,
                max_translation=kcfg.max_translation,
                max_rotation=kcfg.max_rotation,
                min_gap=kcfg.min_gap,
                max_gap=kcfg.max_gap,
            ),
        )
        self._prev = None        # (pyramid, points) of the previous frame
        self._kf_poses: dict[int, np.ndarray] = {}   # keyframe poses, host copies
        self._eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._T_wc = self._eye           # world <- current camera
        self._velocity = self._eye       # constant-velocity model, T_prev<-cur
        self._frame_id = 0
        self.trajectory: list[FrameState] = []
        self.timers = StageTimer(sync=self.config.profile)

    # ------------------------------------------------------------ per stage

    def _ingest_pyramid(self, image) -> FramePyramid:
        """Upload (in the input's dtype; 8-bit frames move 4x fewer bytes),
        convert to f32 on the device, crop, build the pyramid (K1)."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.require(image, requirements=("C", "W")))
        img = image.to(self.device).to(torch.float32)
        x0, y0, w, h = self._roi
        img = img[y0:y0 + h, x0:x0 + w].contiguous()
        return build_pyramid(img, levels=self.config.tracker.pyramid_levels)

    def _track_and_diag(self, prev_pyr, pyr, prev_pts, T_init, T_ref_kf):
        """Track the frame against the previous one and pack what the host
        needs into one (42,) vector: inliers, point capacity, error, pose
        finiteness, the new T_wc (16), T_kf_frame (16), log(T_kf_frame) (6)."""
        tcfg = self.config.tracker
        out = track(
            prev_pyr, pyr, prev_pts, self.cam, T_init=T_init[None],
            levels=tcfg.track_levels, max_iters=tcfg.max_iterations,
            weight_kind=tcfg.weight_kind, mode=tcfg.track_mode,
            affine=tcfg.affine_brightness,
        )
        T_rel = out.T[0]                                   # cur <- prev
        T_wc_new = se3.normalize(se3.compose(self._T_wc, se3.inverse(T_rel)))
        T_kf_frame = se3.compose(se3.inverse(T_ref_kf), T_wc_new)
        diag = torch.cat([
            torch.stack([
                out.inliers[0].float(), prev_pts.valid.sum().float(),
                out.error[0].float(), torch.isfinite(T_rel).all().float(),
            ]),
            T_wc_new.reshape(-1), T_kf_frame.reshape(-1), se3.log(T_kf_frame),
        ])
        return T_rel, T_wc_new, diag

    def _select_points(self, pyr):
        cfg = self.config.tracker
        return topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], self.cam, num_points=cfg.num_points,
            mono_z=cfg.mono_depth, block=cfg.point_block,
        )

    def _detect_features(self, pyr):
        """Multi-scale corners and their descriptors (K3 per level)."""
        fcfg = self.config.features
        n_lvls = min(fcfg.detect_levels, self.config.tracker.pyramid_levels)
        kps = detect_multiscale(
            [g[0] for g in pyr.grad_x], [g[0] for g in pyr.grad_y],
            per_level=fcfg.per_level, levels=n_lvls,
        )
        desc = describe([im[0] for im in pyr.images], kps.uv, kps.level, kps.valid)
        return kps, desc

    def _make_keyframe(self, ts, pyr, pts, cur_feats) -> Keyframe:
        """A keyframe; with relocalization on, it carries feature keypoints
        and their camera-frame 3D points (monocular depth) for PnP."""
        kf = Keyframe(self._frame_id, ts, self._T_wc, pyr, pts)
        if cur_feats is None and self.config.use_reloc:
            cur_feats = self._detect_features(pyr)
        if cur_feats is not None:
            kps, desc = cur_feats
            depth, depth_ok = _depth_at(kps.uv, self.config.tracker.mono_depth)
            kf = kf._replace(
                kp_uv=kps.uv, kp_desc=desc, kp_valid=kps.valid & depth_ok,
                kp_p3d=self.cam.unproject(kps.uv, depth),
            )
        return kf

    def _on_new_keyframe(self, kf) -> None:
        """Keyframe hook of loop closure and global BA; neither is on in
        configuration 1 (`__init__` refuses them), so nothing happens."""

    def _relocalize(self, pyr):
        """PnP against the newest keyframes, newest first. Returns
        (T_wc, kf_id, features) on success, else None; the detected
        features come back so a new keyframe can reuse them. Minimal
        samples come from a generator seeded with the frame id."""
        rcfg = self.config.reloc
        cur_feats = self._detect_features(pyr)
        kps, desc = cur_feats
        for kf in reversed(self.keyframes.keyframes[-rcfg.max_candidates:]):
            if kf.kp_desc is None or kf.kp_p3d is None:
                continue
            m = match_descriptors(kf.kp_desc, desc, kf.kp_valid, kps.valid,
                                  ratio=self.config.features.ratio)
            gen = torch.Generator().manual_seed(self._frame_id)
            res = pnp_from_pixels(
                self.cam, kf.kp_p3d[m.idx_a], kps.uv[m.idx_b], m.valid,
                sample_hypotheses(m.valid, PNP_HYPOTHESES, gen),
                threshold_px=rcfg.pnp_threshold_px, min_inliers=rcfg.pnp_min_inliers,
            )
            T_wc = se3.normalize(se3.compose(kf.T_wc, se3.inverse(res.T)))
            ok, finite = torch.stack(
                [res.ok.float(), torch.isfinite(T_wc).all().float()]
            ).cpu().tolist()
            if ok and finite:
                return T_wc, kf.frame_id, cur_feats
        return None

    # ------------------------------------------------------------ the frame

    def process_frame(self, image, depth=None, timestamp: float | None = None) -> FrameState:
        """Run one frame (an (H, W) array or tensor of intensities in
        [0, 255]) through the pipeline; returns its state."""
        if depth is not None:
            raise unported("a depth image", "slice 1, item 3")
        ts = float(timestamp) if timestamp is not None else float(self._frame_id)
        with self.timers.stage("ingest"):
            pyr = self._ingest_pyramid(image)

        if self._prev is None:
            pts = self._select_points(pyr)
            kf = self._make_keyframe(ts, pyr, pts, None)
            self.keyframes.insert(kf)
            T_wc_host = self._T_wc.cpu().numpy()
            self._kf_poses[kf.frame_id] = T_wc_host
            self._on_new_keyframe(kf)
            state = FrameState(
                frame_id=self._frame_id, timestamp=ts, T_wc=T_wc_host,
                tracked_inliers=int(pts.valid.sum()), track_error=0.0,
                is_keyframe=True, ref_kf_id=self._frame_id,
                T_kf_frame=np.eye(4, dtype=np.float32),
            )
            self._prev = (pyr, pts)
        else:
            state = self._track_frame(pyr, ts)
        self.trajectory.append(state)
        self._frame_id += 1
        return state

    def _track_frame(self, pyr, ts: float) -> FrameState:
        cfg = self.config
        prev_pyr, prev_pts = self._prev
        with self.timers.stage("track"):
            T_rel, T_wc_new, diag = self._track_and_diag(
                prev_pyr, pyr, prev_pts, self._velocity, self.keyframes.latest.T_wc,
            )
            diag = diag.cpu().numpy()              # the frame's one transfer
        inliers = int(diag[0])
        capacity = int(diag[1])
        track_error = float(diag[2])
        pose_finite = bool(diag[3])
        T_wc_np = diag[4:20].reshape(4, 4).copy()
        T_kf_frame_np = diag[20:36].reshape(4, 4).copy()
        rel_kf_log = diag[36:42]
        ratio = inliers / max(capacity, 1)

        # A frame is lost when inliers collapse (an absolute floor, relaxed
        # to half the budget for small budgets), the error explodes, or the
        # pose is not finite.
        rcfg = cfg.reloc
        inlier_floor = min(rcfg.min_inliers, int(0.5 * capacity))
        lost = cfg.use_reloc and (
            inliers < inlier_floor
            or ratio < rcfg.min_inlier_ratio
            or not np.isfinite(track_error)
            or track_error > rcfg.max_error
            or not pose_finite
            or not np.isfinite(T_wc_np).all()
        )
        status = "ok"
        cur_feats = None
        if lost:
            with self.timers.stage("reloc"):
                reloc = self._relocalize(pyr)
            if reloc is not None:
                self._T_wc, _, cur_feats = reloc
                self._velocity = self._eye
                status = "relocalized"
            else:           # coast on the constant-velocity model
                self._T_wc = se3.normalize(
                    se3.compose(self._T_wc, se3.inverse(self._velocity))
                )
                status = "lost"
        else:
            self._velocity = T_rel
            self._T_wc = T_wc_new
        with self.timers.stage("select"):
            pts = self._select_points(pyr)
        is_kf = status != "lost" and (
            status == "relocalized"
            or self.keyframes.should_insert(self._frame_id, self._T_wc, ratio,
                                            rel_log=rel_kf_log)
        )
        if is_kf:
            with self.timers.stage("keyframe"):
                kf = self._make_keyframe(ts, pyr, pts, cur_feats)
                self.keyframes.insert(kf)
                self._on_new_keyframe(kf)
        ref_kf = self.keyframes.latest
        if status == "ok" and not is_kf:
            T_wc_host, T_kf_frame = T_wc_np, T_kf_frame_np
        else:
            # The pose moved (lost, relocalized) or a keyframe was made: read
            # the live pose and the pose relative to the keyframe together.
            both = torch.stack([
                self._T_wc, se3.compose(se3.inverse(ref_kf.T_wc), self._T_wc)
            ]).cpu().numpy()
            T_wc_host, T_kf_frame = both[0], both[1]
            if is_kf:
                self._kf_poses[ref_kf.frame_id] = T_wc_host
        self._prev = (pyr, pts)
        return FrameState(
            frame_id=self._frame_id, timestamp=ts, T_wc=T_wc_host,
            tracked_inliers=inliers, track_error=track_error, is_keyframe=is_kf,
            ref_kf_id=ref_kf.frame_id, T_kf_frame=T_kf_frame, status=status,
        )

    # ------------------------------------------------------------ export

    def export_trajectory(self, path: str | None = None):
        """Per-frame poses recomposed against their reference keyframe's
        latest pose -> (timestamps (N,), poses (N, 4, 4)); written in TUM
        format to `path` (default config.trajectory_csv) when given. A
        recomposition that is not finite falls back to the live pose."""
        path = path or self.config.trajectory_csv
        ts = [s.timestamp for s in self.trajectory]
        poses = []
        bad_kf = bad_rel = bad_live = 0
        for s in self.trajectory:
            kf_pose = self._kf_poses.get(s.ref_kf_id)
            if kf_pose is not None and s.T_kf_frame is not None:
                p = np.asarray(kf_pose @ s.T_kf_frame, np.float32)
                if not np.isfinite(p).all():
                    if not np.isfinite(kf_pose).all():
                        bad_kf += 1
                    else:
                        bad_rel += 1
                    p = np.asarray(s.T_wc, np.float32)
                poses.append(p)
            else:
                poses.append(s.T_wc)
            if not np.isfinite(poses[-1]).all():
                bad_live += 1
        if bad_kf or bad_rel or bad_live:
            import sys

            print(
                f"WARNING: export_trajectory non-finite poses: {bad_kf} bad "
                f"keyframe poses, {bad_rel} bad relative poses, {bad_live} bad "
                "live fallbacks",
                file=sys.stderr,
            )
        poses = np.stack(poses)
        if path:
            write_trajectory_tum(path, ts, poses)
        return np.asarray(ts), poses
