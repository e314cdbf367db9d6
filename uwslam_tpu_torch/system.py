"""SlamSystem: the live per-frame pipeline of the direct-tracking system.

Counterpart of `uwslam_tpu.system.SlamSystem` with the switches of the
direct-tracking configurations (README configs 1 and 3): monocular or RGB-D
frames, rectified when the calibration has lens distortion (else cropped to
a multiple of 2^(levels-1)), photometric tracking (FC by default) with a
constant-velocity prior on semi-dense or dense points, keyframes, and
failure detection with relocalization (feature detection on every
keyframe, descriptor matching and PnP-RANSAC for a lost frame). The other
switches of `SlamConfig` (feature front end, depth bootstrap, bundle
adjustment, loop closure) raise NotImplementedError naming the ROADMAP item
that will port them.

Two entry points run the same stages. `process_frame` is synchronous: ingest
(upload, rectify, crop, pyramid with kernel K1), tracking (kernels K3 and
K2), point selection (K3 on a depth image) and, on keyframes, feature
detection and description (K3); the host reads one packed diagnostics
vector per frame (42 floats). `process_frame_async` is the pipelined loop:
the whole steady-state frame is one function (`_build_step_plain`), on a
CUDA device captured once into a CUDA graph and replayed per frame; its
26-float diagnostics are read back four frames at a time through pinned
memory, one call after they were staged, so a frame's state (and the
keyframe it may become) lands 5 to 9 frames after its dispatch. Call
`flush()` after the last frame.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .camera.calibration import Calibration
from .camera.model import (
    PinholeCamera,
    compute_roi,
    optimal_new_camera,
    remap_bilinear,
    undistort_map,
)
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
from .ops.graph import CapturedStep, tree_clone
from .tracking.photometric import track
from .tracking.points import _depth_at, dense_points, topk_gradient_points
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


def _refuse_unported(config: SlamConfig) -> None:
    checks = (
        (config.use_features, "use_features (the feature front-end, config 2)",
         "slice 4, item 14"),
        (config.tracker.depth_bootstrap, "tracker.depth_bootstrap (the depth prior)",
         "slice 3, item 11"),
        (config.use_ba, "use_ba (window bundle adjustment)", "slice 6, item 16"),
        (config.use_loop_closure, "use_loop_closure", "slice 7, item 17"),
        (config.global_ba, "global_ba (global distributed BA)", "slice 7, item 17"),
    )
    for is_set, what, item in checks:
        if is_set:
            raise unported(what, item)


class SlamSystem:
    """Monocular (optionally RGB-D) direct SLAM on one torch device: the
    card unless the caller names another (`device="cpu"` for the plain
    versions of the kernels)."""

    def __init__(
        self,
        calibration: Calibration,
        config: SlamConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or SlamConfig()
        _refuse_unported(self.config)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SlamSystem runs on a CUDA card and none is visible; pass "
                    "device='cpu' to run on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.calib = calibration
        raw = calibration.raw
        if calibration.needs_rectification:
            rect = optimal_new_camera(raw, calibration.out_width, calibration.out_height)
            # The map is computed on the host whatever the device, so the
            # region of interest below does not depend on the device.
            rect_map = undistort_map(raw, rect)
            m = rect_map.numpy()
            valid = (
                (m[..., 0] >= 0) & (m[..., 0] <= raw.width - 1)
                & (m[..., 1] >= 0) & (m[..., 1] <= raw.height - 1)
            )
            # Valid pixels of the rectified image (uw-slam's CalculateROI,
            # src/System.cpp:148-191).
            x0, y0, w, h = compute_roi(valid)
            self._rect_map = rect_map.to(self.device)
            self.cam = PinholeCamera(fx=rect.fx, fy=rect.fy, cx=rect.cx - x0,
                                     cy=rect.cy - y0, width=w, height=h)
        else:
            self._rect_map = None
            # Crop to a multiple of 2^(levels-1) so every pyramid level halves
            # exactly (uw-slam requires even sizes, src/System.cpp:81-89).
            div = 1 << (self.config.tracker.pyramid_levels - 1)
            w = raw.width - raw.width % div
            h = raw.height - raw.height % div
            x0 = y0 = 0
            self.cam = PinholeCamera(fx=raw.fx, fy=raw.fy, cx=raw.cx, cy=raw.cy,
                                     width=w, height=h)
        self._roi = (x0, y0, w, h)
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
        self._prev = None        # (pyramid, points, depth) of the previous frame
        self._kf_poses: dict[int, np.ndarray] = {}   # keyframe poses, host copies
        self._eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._T_wc = self._eye           # world <- current camera
        self._velocity = self._eye       # constant-velocity model, T_prev<-cur
        self._frame_id = 0
        self.trajectory: list[FrameState] = []
        self.timers = StageTimer(sync=self.config.profile)
        # The pipelined loop: frames in flight, oldest first.
        self._steps: dict[tuple, CapturedStep] = {}   # (dtype, shape) -> graph
        self._pipe_queue: list[dict] = []
        self._pipe_batch = 4         # frames retired per diagnostics transfer
        self._pipe_ready = None      # (rows, event, records): a batch in transfer
        self._pipe_broken = False    # a lost frame found late: drain, resynchronize
        self._pipelined = False      # True while inside the pipelined loop
        # Left-multiplied pose corrections (bundle adjustment, loop closure)
        # that must reach the device-side pose chain at the next dispatch.
        self._corr_pending = np.eye(4, dtype=np.float32)
        self._corr_accum = np.eye(4, dtype=np.float32)

    # ------------------------------------------------------------ per stage

    def _to_device(self, image) -> torch.Tensor:
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.require(image, requirements=("C", "W")))
        return image.to(self.device)

    def _rectify(self, img: torch.Tensor) -> torch.Tensor:
        """Rectify one f32 frame by the exact 4-tap gather."""
        return remap_bilinear(img, self._rect_map)

    def _crop(self, img: torch.Tensor) -> torch.Tensor:
        """The region of interest, in memory of its own."""
        x0, y0, w, h = self._roi
        return img[y0:y0 + h, x0:x0 + w].clone(memory_format=torch.contiguous_format)

    def _ingest(self, image) -> torch.Tensor:
        """A frame (uploaded in its own dtype: 8-bit frames move 4x fewer
        bytes) as f32 on the device, rectified and cropped."""
        img = self._to_device(image).to(torch.float32)
        if self._rect_map is not None:
            img = self._rectify(img)
        return self._crop(img)

    def _ingest_depth(self, depth) -> torch.Tensor:
        """A depth image in raw sensor units as f32 on the device, cropped
        like the frame (16-bit values are exact in f32)."""
        return self._crop(self._to_device(depth).to(torch.float32))

    def _ingest_pyramid(self, image) -> FramePyramid:
        """Upload, rectify, crop, build the pyramid (K1)."""
        return build_pyramid(self._ingest(image), levels=self.config.tracker.pyramid_levels)

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

    def _select_points(self, pyr, depth_image=None):
        cfg = self.config.tracker
        depth = None if depth_image is None else depth_image[None]
        if cfg.point_mode == "dense":
            return dense_points(pyr.images[0], self.cam, depth_image=depth,
                                mono_z=cfg.mono_depth, stride=cfg.dense_stride)
        return topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], self.cam, depth_image=depth,
            num_points=cfg.num_points, mono_z=cfg.mono_depth, block=cfg.point_block,
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

    def _make_keyframe(self, ts, pyr, pts, cur_feats, depth_dev=None) -> Keyframe:
        """A keyframe; with relocalization on, it carries feature keypoints
        and their camera-frame 3D points (from the depth image, else the
        monocular depth) for PnP. Keypoints over depth holes or edges are
        masked out: they would carry the fallback depth."""
        kf = Keyframe(self._frame_id, ts, self._T_wc, pyr, pts)
        if cur_feats is None and self.config.use_reloc:
            cur_feats = self._detect_features(pyr)
        if cur_feats is not None:
            kps, desc = cur_feats
            depth, depth_ok = _depth_at(depth_dev, kps.uv, self.config.tracker.mono_depth)
            kf = kf._replace(
                kp_uv=kps.uv, kp_desc=desc, kp_valid=kps.valid & depth_ok,
                kp_p3d=self.cam.unproject(kps.uv, depth),
            )
        return kf

    def _on_new_keyframe(self, kf) -> None:
        """Keyframe hook of loop closure and global BA; `__init__` refuses
        both, so nothing happens. A pose correction they compute goes
        through `_apply_live_correction`."""

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
        [0, 255]; `depth` an (H, W) depth image in raw sensor units, TUM's
        5000 per metre) through the pipeline; returns its state."""
        ts = float(timestamp) if timestamp is not None else float(self._frame_id)
        with self.timers.stage("ingest"):
            pyr = self._ingest_pyramid(image)
        depth_dev = None if depth is None else self._ingest_depth(depth)

        if self._prev is None:
            pts = self._select_points(pyr, depth_dev)
            kf = self._make_keyframe(ts, pyr, pts, None, depth_dev)
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
            self._prev = (pyr, pts, depth_dev)
        else:
            state = self._track_frame(pyr, ts, depth_dev)
        self.trajectory.append(state)
        self._frame_id += 1
        return state

    def _is_lost(self, inliers, capacity, track_error, pose_finite, T_wc_np) -> bool:
        """A frame is lost when inliers collapse (an absolute floor, relaxed
        to half the budget for small budgets), the error explodes, or the
        pose (the relative one or the composed chain) is not finite."""
        rcfg = self.config.reloc
        inlier_floor = min(rcfg.min_inliers, int(0.5 * capacity))
        return self.config.use_reloc and (
            inliers < inlier_floor
            or inliers / max(capacity, 1) < rcfg.min_inlier_ratio
            or not np.isfinite(track_error)
            or track_error > rcfg.max_error
            or not pose_finite
            or not np.isfinite(T_wc_np).all()
        )

    def _track_frame(self, pyr, ts: float, depth_dev) -> FrameState:
        prev_pyr, prev_pts, _ = self._prev
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
        status = "ok"
        cur_feats = None
        if self._is_lost(inliers, capacity, track_error, pose_finite, T_wc_np):
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
            pts = self._select_points(pyr, depth_dev)
        is_kf = status != "lost" and (
            status == "relocalized"
            or self.keyframes.should_insert(self._frame_id, self._T_wc, ratio,
                                            rel_log=rel_kf_log)
        )
        if is_kf:
            with self.timers.stage("keyframe"):
                kf = self._make_keyframe(ts, pyr, pts, cur_feats, depth_dev)
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
        self._prev = (pyr, pts, depth_dev)
        return FrameState(
            frame_id=self._frame_id, timestamp=ts, T_wc=T_wc_host,
            tracked_inliers=inliers, track_error=track_error, is_keyframe=is_kf,
            ref_kf_id=ref_kf.frame_id, T_kf_frame=T_kf_frame, status=status,
        )

    # ------------------------------------------------- the pipelined loop

    def _push_correction(self, C: np.ndarray) -> None:
        """Register a left-multiplied pose correction for the pipelined
        chain: it reaches the device-side pose at the next dispatch, and the
        retirement of frames dispatched before it applies it to their
        diagnostics poses on the host. A hook only, for now: window bundle
        adjustment and loop closure are its producers and `__init__` refuses
        both, so the pending correction stays the identity; the megastep
        keeps its `corr` input so that its signature need not change."""
        C = np.asarray(C, np.float32)
        self._corr_pending = C @ self._corr_pending
        self._corr_accum = C @ self._corr_accum

    def _apply_live_correction(self, correction) -> None:
        """Route a correction of the live pose: directly on the synchronous
        path; through the pending correction while frames are in flight (the
        chain head is already past the frame being retired, and touching
        `_T_wc` too would apply it twice). Either way `_corr_accum` records it."""
        C = np.array(correction, np.float32)
        if self._pipelined:
            self._push_correction(C)
        else:
            self._corr_accum = C @ self._corr_accum
            self._T_wc = se3.normalize(
                se3.compose(torch.from_numpy(C).to(self.device), self._T_wc)
            )

    @staticmethod
    def _np_inv_se3(T: np.ndarray) -> np.ndarray:
        R = T[:3, :3]
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ T[:3, 3]
        return out

    @staticmethod
    def _np_rel_log(T_ref: np.ndarray, T_wc: np.ndarray) -> np.ndarray:
        """Host-side stand-in for log(T_ref^-1 T_wc) carrying the two norms
        the keyframe policy reads (|t| and the rotation angle), so that
        retirement starts no device work."""
        D = SlamSystem._np_inv_se3(np.asarray(T_ref, np.float32)) @ np.asarray(
            T_wc, np.float32
        )
        t = D[:3, 3]
        c = np.clip((np.trace(D[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        return np.asarray([t[0], t[1], t[2], float(np.arccos(c)), 0.0, 0.0], np.float32)

    def _build_step_plain(self):
        """The whole steady-state frame as one function of tensors, `step(img,
        prev_pyr, prev_pts, T_init, T_wc, T_ref, corr) -> (pyr, pts, T_rel,
        T_wc_new, diag)`: convert, rectify, crop, pyramid (K1), coarse-to-fine
        LM tracking (K3, K2, lm_evaluate), the speculative pose chain, the
        26-float diagnostics (inliers, point capacity, error, finiteness,
        T_wc_new, log(T_ref^-1 T_wc_new)) and the next frame's top-K points.
        Nothing in it reads the device, so a CUDA graph can hold it."""
        cam = self.cam
        tcfg = self.config.tracker

        def step(img, prev_pyr, prev_pts, T_init, T_wc, T_ref, corr):
            pyr = self._ingest_pyramid(img)
            out = track(
                prev_pyr, pyr, prev_pts, cam, T_init=T_init[None],
                levels=tcfg.track_levels, max_iters=tcfg.max_iterations,
                weight_kind=tcfg.weight_kind, mode=tcfg.track_mode,
                affine=tcfg.affine_brightness,
            )
            T_rel = out.T[0]
            T_wc_in = se3.compose(corr, T_wc)
            T_wc_new = se3.normalize(se3.compose(T_wc_in, se3.inverse(T_rel)))
            diag = torch.cat([
                torch.stack([
                    out.inliers[0].float(), prev_pts.valid.sum().float(),
                    out.error[0].float(), torch.isfinite(T_rel).all().float(),
                ]),
                T_wc_new.reshape(-1),
                se3.log(se3.compose(se3.inverse(T_ref), T_wc_new)),
            ])
            pts = topk_gradient_points(
                pyr.images[0], pyr.grad_mag[0], cam, num_points=tcfg.num_points,
                mono_z=tcfg.mono_depth, block=tcfg.point_block,
            )
            return pyr, pts, T_rel, T_wc_new, diag

        return step

    def _run_step(self, *inputs):
        """One megastep: eagerly on a CPU device; on a CUDA device one replay
        of the graph captured for this frame dtype and shape at its first
        use. The replay's outputs are cloned: the next replay overwrites the
        graph's own, while a frame's pyramid and points live on until its
        retirement (and as the next frame's inputs)."""
        if self.device.type == "cpu":
            return self._build_step_plain()(*inputs)
        key = (inputs[0].dtype, tuple(inputs[0].shape))
        if key not in self._steps:
            self._steps[key] = CapturedStep(self._build_step_plain(), inputs)
        return tree_clone(self._steps[key](*inputs))

    @property
    def graph_replays(self) -> int:
        """Frames that went through a CUDA graph replay so far."""
        return sum(step.replays for step in self._steps.values())

    def _can_pipeline(self, depth) -> bool:
        """The megastep covers steady-state plain direct tracking. The first
        frame, a frame with a depth image, dense points, profiling (stage
        timers need fenced stages) and the recovery from a lost frame take
        the synchronous path; so will the feature front end until its
        bootstrap megastep is ported."""
        if depth is not None or self._prev is None or self._pipe_broken:
            return False
        cfg = self.config
        if cfg.tracker.point_mode == "dense" or cfg.profile:
            return False
        return not cfg.use_features

    def process_frame_async(self, image, depth=None,
                            timestamp: float | None = None) -> FrameState | None:
        """Pipelined frame processing: dispatch this frame's megastep, then
        retire earlier frames whose batched diagnostics transfer has been
        overlapping the dispatches. Returns the newest retired state or None.

        Diagnostics are read `_pipe_batch` (4) frames at a time and a batch
        is staged one call ahead, so a frame's FrameState, and the keyframe
        decision with it, lands 5 to 9 frames after its dispatch. Use
        `process_frame` when keyframe latency matters more than throughput.
        Call `flush()` after the last frame."""
        if not self._can_pipeline(depth):
            self.flush()   # retired states land in self.trajectory
            self._pipe_broken = False
            return self.process_frame(image, depth, timestamp)
        ts = float(timestamp) if timestamp is not None else float(self._frame_id)
        self._pipelined = True
        try:
            self._pipe_queue.append(self._dispatch_pipelined(image, ts))
            state = self._retire_ready()
            if self._pipe_ready is None and len(self._pipe_queue) > self._pipe_batch:
                recs = self._pipe_queue[: self._pipe_batch]
                del self._pipe_queue[: self._pipe_batch]
                self._pipe_ready = (*self._stage_diags(recs), recs)
            return state
        finally:
            self._pipelined = False

    def _stage_diags(self, recs):
        """Stack the records' diagnostics and start their transfer to pinned
        host memory -> (rows, event): retirement waits on the event, not on
        the device."""
        stacked = torch.stack([r["diag"] for r in recs])
        if self.device.type == "cpu":
            return stacked, None
        rows = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
        rows.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return rows, event

    def _retire_ready(self) -> FrameState | None:
        """Retire the batch staged by an earlier call, if there is one."""
        if self._pipe_ready is None:
            return None
        rows, event, recs = self._pipe_ready
        self._pipe_ready = None
        if event is not None:
            event.synchronize()
        rows = rows.numpy()
        state = None
        for k, rec in enumerate(recs):
            state = self._retire_pipelined(rec, rows[k])
        return state

    def _dispatch_pipelined(self, image, ts: float) -> dict:
        if np.allclose(self._corr_pending, np.eye(4)):
            corr = self._eye
        else:
            corr = torch.from_numpy(self._corr_pending).to(self.device)
        self._corr_pending = np.eye(4, dtype=np.float32)
        prev_pyr, prev_pts, _ = self._prev
        pyr, pts, T_rel, T_wc_new, diag = self._run_step(
            self._to_device(image), prev_pyr, prev_pts, self._velocity, self._T_wc,
            self.keyframes.latest.T_wc, corr,
        )
        # Advance the device-side chain speculatively (status "ok").
        self._velocity = T_rel
        self._T_wc = T_wc_new
        self._prev = (pyr, pts, None)
        rec = {
            "frame_id": self._frame_id, "ts": ts, "diag": diag, "pyr": pyr, "pts": pts,
            "corr_at_dispatch": self._corr_accum.copy(),
            "ref_kf_id": self.keyframes.latest.frame_id,
        }
        self._frame_id += 1
        return rec

    def _retire_pipelined(self, rec=None, diag_row=None) -> FrameState:
        """Host bookkeeping for one in-flight frame: failure gate, keyframe
        policy (a few frames late by construction), trajectory append."""
        if rec is None:
            rec = self._pipe_queue.pop(0)
        ref_kf = self.keyframes.latest
        kf_pose = np.asarray(self._kf_poses[ref_kf.frame_id], np.float32)
        if self._pipe_broken:
            # Dispatched on a chain that later proved lost: coast on the
            # recovered pose, ignore the diagnostics.
            T_wc_np = self._T_wc.cpu().numpy()
            state = FrameState(
                frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
                tracked_inliers=0, track_error=float("nan"), is_keyframe=False,
                ref_kf_id=ref_kf.frame_id,
                T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status="lost",
            )
            self.trajectory.append(state)
            return state
        diag = diag_row if diag_row is not None else rec["diag"].cpu().numpy()
        inliers = int(diag[0])
        capacity = int(diag[1])
        track_error = float(diag[2])
        pose_finite = bool(diag[3])
        T_wc_np = diag[4:20].reshape(4, 4).copy()
        rel_kf_log = diag[20:26]
        # Corrections registered after this frame's dispatch apply to its
        # pose retroactively (they reached the device chain later).
        delta = rec["corr_at_dispatch"]
        if not np.allclose(self._corr_accum, delta):
            T_wc_np = self._corr_accum @ self._np_inv_se3(delta) @ T_wc_np
        ratio = inliers / max(capacity, 1)

        if self._is_lost(inliers, capacity, track_error, pose_finite, T_wc_np):
            # Found late: the frames dispatched after this one ran on a
            # garbage chain. Drain them and resynchronize.
            self._pipe_broken = True
            status = "lost"
            reloc = self._relocalize(rec["pyr"])
            if reloc is not None:
                T_wc_np = reloc[0].cpu().numpy()
                status = "relocalized"
            else:
                # Coast on the last retired pose: the chain head and this
                # frame's diagnostics pose are both poisoned.
                T_wc_np = (
                    np.array(self.trajectory[-1].T_wc, np.float32)
                    if self.trajectory else np.eye(4, dtype=np.float32)
                )
            self._T_wc = torch.from_numpy(T_wc_np).to(self.device)
            self._velocity = self._eye
            state = FrameState(
                frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
                tracked_inliers=inliers, track_error=track_error, is_keyframe=False,
                ref_kf_id=ref_kf.frame_id,
                T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status=status,
            )
            self.trajectory.append(state)
            return state

        # If a keyframe landed while this frame was in flight, the
        # diagnostics' motion relative to the keyframe is stale.
        if rec["ref_kf_id"] != ref_kf.frame_id:
            rel_kf_log = self._np_rel_log(kf_pose, T_wc_np)
        is_kf = self.keyframes.should_insert(rec["frame_id"], T_wc_np, ratio,
                                             rel_log=rel_kf_log)
        if is_kf:
            # Keyframe creation must see THIS frame, not the chain head.
            T_wc_saved, fid_saved = self._T_wc, self._frame_id
            self._T_wc = torch.from_numpy(T_wc_np).to(self.device)
            self._frame_id = rec["frame_id"]
            kf = self._make_keyframe(rec["ts"], rec["pyr"], rec["pts"], None)
            self._T_wc, self._frame_id = T_wc_saved, fid_saved
            self.keyframes.insert(kf)
            self._kf_poses[kf.frame_id] = T_wc_np.copy()
            self._on_new_keyframe(kf)
            ref_kf = self.keyframes.latest
            kf_pose = self._kf_poses[ref_kf.frame_id]
        state = FrameState(
            frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
            tracked_inliers=inliers, track_error=track_error, is_keyframe=is_kf,
            ref_kf_id=ref_kf.frame_id,
            T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status="ok",
        )
        self.trajectory.append(state)
        return state

    def flush(self) -> FrameState | None:
        """Retire every in-flight frame (after the last frame, or before a
        frame that takes the synchronous path)."""
        if not self._pipe_queue and self._pipe_ready is None:
            self._drain_pending_correction()
            return None
        self._pipelined = True
        try:
            state = self._retire_ready()
            while self._pipe_queue:
                state = self._retire_pipelined()
            return state
        finally:
            self._pipelined = False
            self._drain_pending_correction()

    def _drain_pending_correction(self) -> None:
        if not np.allclose(self._corr_pending, np.eye(4)):
            self._T_wc = se3.normalize(se3.compose(
                torch.from_numpy(self._corr_pending).to(self.device), self._T_wc
            ))
            self._corr_pending = np.eye(4, dtype=np.float32)

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
