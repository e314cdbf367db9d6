"""SlamSystem: the live per-frame pipeline.

Counterpart of `uwslam_tpu.system.SlamSystem` for README configs 1 to 7:
monocular or RGB-D frames, rectified when the calibration has lens
distortion (else cropped to a multiple of 2^(levels-1)), photometric
tracking (FC by default) with a constant-velocity prior on semi-dense or
dense points, keyframes, and failure detection with relocalization
(descriptor matching and PnP-RANSAC for a lost frame); with `use_features`
the feature front end (detection, description, matching, F-RANSAC) on
every frame, tracking either on patch points around the matched keypoints
(uw-slam's active pipeline) or, with `tracker.depth_bootstrap`, on the
top-K selection at depths read from a coarse inverse-depth prior that is
bootstrapped from an essential matrix and refreshed every frame; with
`use_ba` bundle adjustment over the keyframe window: reprojection BA on
feature tracks, the keyframes' match and the solve dispatched at a keyframe
and retired a few frames later, or with `ba.photometric` photometric BA on
the keyframes' pyramids, solved at the keyframe; with `use_loop_closure`
loop detection at every keyframe and a pose-graph correction of the whole
keyframe history (`map.loop_closure`); with `global_ba` a record of every
keyframe for `run_global_distributed_ba`, the landmark-sharded bundle
adjustment of the whole map at the end of a run (`parallel.dist_ba`).

Two entry points run the same stages. `process_frame` is synchronous: ingest
(upload, rectify, crop, pyramid with kernel K1), tracking (kernels K3 and
K2), point selection (K3 on a depth image) and, on keyframes, feature
detection and description (K3); the host reads one packed diagnostics
vector per frame (42 floats). `process_frame_async` is the pipelined loop:
the whole steady-state frame is one function (`_build_step_plain`, or
`_build_step_boot` once the depth prior is installed), on a CUDA device
captured once into a CUDA graph and replayed per frame; its
26-float diagnostics (28 in the bootstrap megastep, which adds its match
and F-RANSAC inlier counts; on a CUDA device then the device ms of each of
its stages, stamped inside the graph) are read back four frames at a time
through pinned memory, one call after they were staged, so a frame's state
(and the keyframe it may become) lands 2 to 5 calls after its dispatch.
Call `flush()` after the last frame.

`self.tracer` (`utils.profiling.Tracer`) times the pipelined loop's parts as
host spans into `retire_host_s` and counts its frames, keyframes and graph
captures, and under the depth bootstrap its boot replays, prior installs and
drops and the matches and inliers of the frames it retires as tracked;
the synchronous path's stages are its spans `sync_<stage>`.
"""
from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass
from functools import partial

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
from .config import SlamConfig
from .ba.photometric import (
    PhotoBAProblem,
    photo_ba_problem_from_keyframes,
    photometric_bundle_adjust,
)
from .ba.schur import BAProblem, bundle_adjust
from .features import (
    describe,
    detect_multiscale,
    draw_uniforms,
    essential_ransac,
    fundamental_ransac,
    match_descriptors,
    pnp_from_pixels,
    projection_matrix,
    recover_pose,
    sample_hypotheses,
)
from .image.pyramid import FramePyramid, build_pyramid
from .io.trajectory import write_trajectory_tum
from .lie import se3
from .map.keyframes import Keyframe, KeyframeDecision, KeyframeStore
from .map.loop_closure import LoopCloser, LoopConfig
from .map.tracks import TrackGraph
from .ops.graph import CapturedStep, tree_clone
from .ops.stamp import StageClock
from .tracking.depth_prior import (
    DepthPrior,
    fill_prior,
    gauge_ratio,
    prior_from_points,
    propagate_prior,
    sample_prior,
    sample_prior_checked,
    triangulate_matches,
)
from .tracking.depth_refine import refine_inverse_depth, transfer_depths
from .tracking.photometric import LM_LEVELS, track
from .tracking.points import _depth_at, dense_points, patch_points, topk_gradient_points
from .tracking.robust import masked_median
from .utils.profiling import StageTimer, Tracer

PNP_HYPOTHESES = 128
# A host-side pose whose R^T R is farther than this from I is re-orthonormalized
# (`SlamSystem._np_normalize_se3`); f32 products of rigid motions stay within it.
HOST_DRIFT_ATOL = 1e-6
# The megastep's diagnostics row: 26 floats (inliers, point capacity, error,
# finiteness, T_wc_new, log(T_ref^-1 T_wc_new)), then on a CUDA device the
# device milliseconds of each stage, stamped inside the step.
PIPE_DIAG = 26
# The bootstrap megastep's row adds two floats after those 26, before the
# stage times: the frame's mutual descriptor matches and their F-RANSAC inliers.
BOOT_DIAG = PIPE_DIAG + 2
PLAIN_STAGES = ("ingest", "track", "pose", "select")
BOOT_STAGES = ("ingest", "features", "match", "track", "pose", "prior", "select")
# A keyframe's retirement with window BA, by part (host seconds).
KEYFRAME_PARTS = ("make_keyframe", "match_dispatch", "match_wait", "add_keyframe_matches",
                  "build_problem")
# Host spans of the pipelined loop (`Tracer`), in the seconds table from the start.
LOOP_SPANS = ("frame", "flush", "dispatch", "replay", "capture", "retire_wait", "retire",
              "keyframe", "relocalize", "stage_diags", "ransac_uniforms")


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
    # Pipelined frames only: frames dispatched and not yet retired when this
    # one retired, itself included.
    in_flight: int | None = None
    # Device ms of each megastep stage (PLAIN_STAGES or BOOT_STAGES) for this
    # frame: pipelined frames on a CUDA device only.
    step_ms: dict[str, float] | None = None


def _gated(grid: DepthPrior, support: torch.Tensor, min_support: int) -> DepthPrior:
    """The grid, emptied on the device where its support count is too thin
    (no host read per source)."""
    keep = support >= min_support
    return grid._replace(weight=torch.where(keep, grid.weight, 0.0),
                         inv_depth=torch.where(keep, grid.inv_depth, 0.0))


def _fuse_grids(grids, block: int):
    """Support-weighted mean of inverse-depth grids -> (DepthPrior, weights)."""
    wsum = sum(g.weight for g in grids)
    inv = torch.where(
        wsum > 0,
        sum(g.inv_depth * g.weight for g in grids) / torch.clamp(wsum, min=1e-6),
        0.0,
    )
    return DepthPrior(inv_depth=inv, weight=wsum, block=block), wsum


def _keypoint_depths(cap: int, idx_b, depth, good) -> torch.Tensor:
    """(cap,) table of triangulated depth per current keypoint slot, 0 where
    there is none (consumers read depth <= 1e-6 as "no depth"). Several
    rows of the match table may name one slot, at most one of them a good
    (mutual) match: the maximum keeps that one's depth whatever the order
    of the writes."""
    table = torch.zeros(cap, dtype=torch.float32, device=depth.device)
    return table.scatter_reduce(0, idx_b, torch.where(good, depth, 0.0), reduce="amax")


def _fused_prior_update(prior, T_rel, ab, prev_pts, img0, gx0, gy0,
                        uv_a, uv_b, good, idx_b, *, cam, blk, cap):
    """Steady-state refresh of the depth prior onto the current frame, with
    nothing read on the host (the synchronous path calls it as it is, the
    bootstrap megastep holds it in its graph): photometric refinement of
    the tracked points' depths (kernel K3, 5 launches) and their transfer,
    triangulation of the matches, each grid anchored to the gauge of the
    propagated prior and gated on its support, fusion, and the table of
    depths per keypoint. The sources 1 to 3 of `SlamSystem._update_prior`;
    its wide-baseline anchor lives only in the first frames and stays
    there."""
    H, W = cam.height, cam.width
    prop = propagate_prior(prior, T_rel, cam)

    # Uniform votes and an uncompensated residual: slope^2 weights amplify
    # the bias of occlusion-edge points, where photometric depth is biased
    # toward the near surface (the JAX package's measurement).
    ref = refine_inverse_depth(prev_pts, T_rel, img0, gx0, gy0, cam, ab=ab)
    uv_t, z_t, ok = transfer_depths(prev_pts, ref.inv_depth, ref.good, T_rel, cam)
    g1 = prior_from_points(uv_t[0], z_t[0], ok[0], H, W, block=blk)
    g1 = g1._replace(inv_depth=g1.inv_depth / gauge_ratio(g1, prop))
    g1 = _gated(g1, ref.good.sum(), 50)

    tri = triangulate_matches(cam, T_rel, uv_a, uv_b, good)
    n_tri = tri.good.sum()
    g2 = prior_from_points(uv_b, tri.depth_b, tri.good, H, W, block=blk)
    s2 = gauge_ratio(g2, prop)
    g2 = g2._replace(inv_depth=g2.inv_depth / s2)
    g2 = _gated(g2, n_tri, 20)
    kp_depth = _keypoint_depths(cap, idx_b, tri.depth_b * s2, tri.good & (n_tri >= 20))

    fused, _ = _fuse_grids([g1, g2, prop], blk)
    # Anchor the fused grid to the propagated one once more: each median
    # ratio above leaks a few percent of gauge noise per frame, which would
    # compound into a random walk of the monocular scale.
    fused = fused._replace(inv_depth=fused.inv_depth / gauge_ratio(fused, prop))
    return fill_prior(fused), kp_depth


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
        self._prev_feats = None     # (Keypoints, descriptors) under use_features
        self._depth_prior = None    # coarse inverse-depth grid (mono bootstrap)
        self._boot_anchor = None    # (feats, T_wc, frames left): the first
        #                             frame, for wide-baseline triangulation
        #                             during the init window
        self._last_matches = None   # (uv_a, uv_b, good, idx_a, idx_b, mutual) of the last pair
        self._kp_depth = None       # triangulated depth per keypoint slot
        self._desc_proj = None      # descriptor projection on the device
        self._tracks = TrackGraph() # feature tracks across keyframes (BA)
        self._loops = None          # LoopCloser, with use_loop_closure
        if self.config.use_loop_closure:
            self._loops = LoopCloser(cam=self.cam, config=LoopConfig(**asdict(self.config.loop)),
                                     device=self.device)
        # Loop closure: keyframes it saw and pose-graph solves (their host
        # seconds are the spans loop_detect and loop_pgo).
        self.loop_stats = {"keyframes": 0, "pgo_runs": 0}
        # Every keyframe's features, for the global BA at the end of a run
        # (global_ba): (frame_id, kp_uv, kp_desc, kp_valid, kp_p3d), on the
        # device; the sliding window forgets them.
        self._kf_history: list[tuple] = []
        self._kf_since_ba = 0
        # Window BA: LM iterations, the host's time (dispatch and any wait)
        # and the solves retired.
        self.ba_stats = {"iters": 0, "time": 0.0, "runs": 0}
        # Host seconds by part: a keyframe's retirement with window BA, and
        # every span of the tracer (the pipelined loop's from the start).
        self.retire_host_s = dict.fromkeys((*KEYFRAME_PARTS, *LOOP_SPANS), 0.0)
        self.tracer = Tracer(self.retire_host_s)
        self._match_inflight = None # a dispatched keyframe match: table, event, window
        self._ba_inflight = None    # a dispatched solve: packed result, event
        self._ba_stream = None      # the side stream reprojection BA runs on
        self._ba_warmed = False     # window BA's graphs captured (frame 0)
        self._kf_poses: dict[int, np.ndarray] = {}   # keyframe poses, host copies
        self._eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._T_wc = self._eye           # world <- current camera
        self._velocity = self._eye       # constant-velocity model, T_prev<-cur
        self._frame_id = 0
        self.trajectory: list[FrameState] = []
        self.timers = StageTimer(self.tracer, sync=self.config.profile)
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
        if depth_image is None and self._depth_prior is not None:
            return self._select_boot(pyr)
        return topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], self.cam, depth_image=depth,
            num_points=cfg.num_points, mono_z=cfg.mono_depth, block=cfg.point_block,
        )

    def _detect_features(self, pyr):
        """Multi-scale corners and their descriptors (K3 per level)."""
        fcfg = self.config.features
        n_lvls = min(fcfg.detect_levels, self.config.tracker.pyramid_levels)
        if self._desc_proj is None:
            # Uploaded once: a captured step may not copy from the host.
            self._desc_proj = projection_matrix(self.device)
        kps = detect_multiscale(
            [g[0] for g in pyr.grad_x], [g[0] for g in pyr.grad_y],
            per_level=fcfg.per_level, levels=n_lvls,
        )
        desc = describe([im[0] for im in pyr.images], kps.uv, kps.level, kps.valid,
                        proj=self._desc_proj)
        return kps, desc

    # ------------------------------------------------ the feature front end

    def _ransac_uniforms(self, num_matches: int, seed: int) -> torch.Tensor:
        """The frame's (hypotheses, matches) table of uniforms behind the
        RANSAC samples, drawn on the host from a generator seeded with the
        frame id and uploaded (through pinned memory on a CUDA device).
        Span `ransac_uniforms`: the draw and the start of the upload."""
        with self.tracer.span("ransac_uniforms"):
            gen = torch.Generator().manual_seed(seed)
            u = draw_uniforms(num_matches, self.config.features.ransac_hypotheses, gen)
            if self.device.type == "cuda":
                return u.pin_memory().to(self.device, non_blocking=True)
            return u

    def _match_features(self, kp_a_uv, desc_a, valid_a, kp_b_uv, desc_b, valid_b, uniforms,
                        ratio: float | None = None):
        """Ratio-tested mutual matches of two keypoint sets (the configured
        ratio unless `ratio` is given), verified by F-RANSAC -> (uv_a, uv_b,
        good, idx_a, idx_b, mutual), all of capacity K_a; `mutual` is the
        matches before F-RANSAC. Nothing is read on the host."""
        fcfg = self.config.features
        m = match_descriptors(desc_a, desc_b, valid_a, valid_b,
                              ratio=fcfg.ratio if ratio is None else ratio)
        uv_a, uv_b = kp_a_uv[m.idx_a], kp_b_uv[m.idx_b]
        res = fundamental_ransac(uv_a, uv_b, m.valid, uniforms,
                                 threshold=fcfg.ransac_threshold_px,
                                 min_inliers=fcfg.min_matches)
        return uv_a, uv_b, m.valid & res.inliers, m.idx_a, m.idx_b, m.valid

    def _match_only(self, prev, cur):
        """Previous -> current matches without patch points: under the depth
        bootstrap the tracker runs on the top-K selection and the matches
        serve triangulation and the table of depths per keypoint."""
        (kp_a, desc_a), (kp_b, desc_b) = prev, cur
        return self._match_features(
            kp_a.uv, desc_a, kp_a.valid, kp_b.uv, desc_b, kp_b.valid,
            self._ransac_uniforms(desc_a.shape[0], self._frame_id),
        )

    def _feature_points(self, prev, cur, depth_image):
        """Match previous -> current features and build patch points around
        the matched PREVIOUS keypoints: uw-slam's active pipeline
        (DetectAndTrackFeatures -> ObtainPatchesPoints, src/System.cpp:211-213)
        -> (TrackPoints, number of matches on the device)."""
        fcfg = self.config.features
        matches = self._match_only(prev, cur)
        uv_a, _, good, idx_a, _, _ = matches
        self._last_matches = matches
        pts = patch_points(
            self._prev[0].images[0], uv_a[None], good[None], self.cam,
            depth_image=None if depth_image is None else depth_image[None],
            mono_z=self.config.tracker.mono_depth,
            patch_size=fcfg.patch_size, max_keypoints=fcfg.max_keypoints,
        )
        if depth_image is None:
            # The triangulated depth of the keypoint itself (a patch lies on
            # its keypoint's surface) beats the coarse grid, which covers
            # the keypoints without one.
            pts = self._apply_prior(pts)
            if self._kp_depth is not None:
                P = fcfg.patch_size * fcfg.patch_size
                K = min(uv_a.shape[0], fcfg.max_keypoints)
                d_pts = self._kp_depth[idx_a][:K].repeat_interleave(P)[None]   # (1, K*P)
                z = torch.where(d_pts > 1e-6, d_pts, pts.p3d[..., 2])
                pts = pts._replace(p3d=self.cam.unproject(pts.uv, z))
        return pts, good.sum()

    # --------------------------------------------------- the depth bootstrap

    def _bootstrap_enabled(self, depth_dev) -> bool:
        return (self.config.tracker.depth_bootstrap and self.config.use_features
                and depth_dev is None)

    def _prior_depths(self, prior: DepthPrior, pts):
        """Points with their depths read from the prior; with
        `bootstrap_edge_ratio`, a point whose read straddles a depth edge is
        dropped."""
        cfg = self.config.tracker
        if cfg.bootstrap_edge_ratio > 0:
            depth, ok = sample_prior_checked(
                prior, pts.uv, cfg.mono_depth,
                max_edge_ratio=cfg.bootstrap_edge_ratio, shrink=cfg.bootstrap_shrink,
            )
            return pts._replace(p3d=self.cam.unproject(pts.uv, depth), valid=pts.valid & ok)
        depth = sample_prior(prior, pts.uv, cfg.mono_depth, shrink=cfg.bootstrap_shrink)
        return pts._replace(p3d=self.cam.unproject(pts.uv, depth))

    def _apply_prior(self, pts):
        """Replace constant-z depths by the bootstrapped prior's, if there is one."""
        return pts if self._depth_prior is None else self._prior_depths(self._depth_prior, pts)

    def _select_boot(self, pyr):
        """The top-K selection at the prior's depths."""
        cfg = self.config.tracker
        pts = topk_gradient_points(
            pyr.images[0], pyr.grad_mag[0], self.cam, num_points=cfg.num_points,
            mono_z=cfg.mono_depth, block=cfg.point_block,
        )
        return self._prior_depths(self._depth_prior, pts)

    def _bootstrap_init(self, matches):
        """Monocular initialization from the first pair: essential-matrix
        RANSAC on the matches gives the direction of the relative pose and
        triangulated structure; the scale is fixed so that the median depth
        equals `mono_depth` (the free monocular gauge). -> (T_init cur <-
        prev, the prior on prev) or None. The classic two-view bootstrap in
        place of uw-slam's z = 1 (its prototype: src/feature_detector.cpp:262-281)."""
        uv_a, uv_b, good = matches[:3]
        if int(good.sum()) < 30:
            return None
        ones = torch.ones(uv_a.shape[0], dtype=torch.float32, device=self.device)
        xy_a = self.cam.unproject(uv_a, ones)[:, :2]
        xy_b = self.cam.unproject(uv_b, ones)[:, :2]
        res = essential_ransac(
            xy_a, xy_b, good, self._ransac_uniforms(uv_a.shape[0], self._frame_id),
            threshold_norm=2.0 / float(self.cam.fx),
        )
        rec = recover_pose(res.F, xy_a, xy_b, good & res.inliers)
        z = rec.points[:, 2]
        med = torch.nanmedian(torch.where(rec.cheirality, z, torch.nan))
        ok, num_good, num_inliers, med = torch.stack(
            [res.ok.float(), rec.num_good.float(), res.num_inliers.float(), med]
        ).cpu().tolist()
        # Cheirality consensus: a sound E puts nearly every inlier in front
        # of both cameras; a degenerate one splits the vote.
        if not ok or num_good < 20 or num_good < 0.7 * num_inliers:
            return None
        if not math.isfinite(med) or med <= 1e-6:
            return None
        scale = self.config.tracker.mono_depth / med
        T_init = rec.T.clone()
        T_init[:3, 3] *= scale
        prior = fill_prior(prior_from_points(
            uv_a, z * scale, rec.cheirality, self.cam.height, self.cam.width,
            block=self.config.tracker.bootstrap_block,
        ))
        return T_init, prior

    def _update_prior(self, T_rel, prev_pts, cur_pyr, cur_feats=None, ab=None):
        """Refresh the inverse-depth prior onto the CURRENT frame, in the
        bootstrap window and after a recovery. Depth sources, fused in
        inverse depth by their support: (1) photometric refinement of the
        tracked points' depths at the fixed tracked pose (the dense source);
        (2) triangulated feature matches; (2b) while the anchor lives, the
        first frame's features matched against the current ones and
        triangulated over the composed, wide baseline (two-view depth noise
        falls as 1 / baseline); (3) the previous prior warped forward, which
        is also the gauge every measurement grid is rescaled to, so that the
        monocular scale is fixed once at the bootstrap."""
        blk = self.config.tracker.bootstrap_block
        H, W = self.cam.height, self.cam.width
        prop = (propagate_prior(self._depth_prior, T_rel, self.cam)
                if self._depth_prior is not None else None)
        grids = []

        def anchored(grid):
            if prop is None:
                return grid, 1.0
            s = gauge_ratio(grid, prop)
            return grid._replace(inv_depth=grid.inv_depth / s), s

        ref = refine_inverse_depth(
            prev_pts, T_rel, cur_pyr.images[0], cur_pyr.grad_x[0], cur_pyr.grad_y[0],
            self.cam, ab=ab,
        )
        uv_t, z_t, ok = transfer_depths(prev_pts, ref.inv_depth, ref.good, T_rel, self.cam)
        g, _ = anchored(prior_from_points(uv_t[0], z_t[0], ok[0], H, W, block=blk))
        grids.append(_gated(g, ref.good.sum(), 50))

        self._kp_depth = None
        if self._last_matches is not None:
            uv_a, uv_b, good, _, idx_b, _ = self._last_matches
            tri = triangulate_matches(self.cam, T_rel, uv_a, uv_b, good)
            n_tri = tri.good.sum()
            g, s_tri = anchored(prior_from_points(uv_b, tri.depth_b, tri.good, H, W, block=blk))
            grids.append(_gated(g, n_tri, 20))
            fcfg = self.config.features
            self._kp_depth = _keypoint_depths(
                fcfg.per_level * fcfg.detect_levels, idx_b, tri.depth_b * s_tri,
                tri.good & (n_tri >= 20),
            )

        if self._boot_anchor is not None and cur_feats is not None:
            (kp_a, desc_a), T_wc_a, frames_left = self._boot_anchor
            kp_b, desc_b = cur_feats
            m = match_descriptors(desc_a, desc_b, kp_a.valid, kp_b.valid,
                                  ratio=self.config.features.ratio)
            # One host read per frame while the anchor lives.
            n_anchor = int(m.valid.sum())
            if n_anchor >= 30:
                T_rel0 = se3.compose(se3.inverse(self._T_wc), T_wc_a)
                uv_b0 = kp_b.uv[m.idx_b]
                tri0 = triangulate_matches(self.cam, T_rel0, kp_a.uv[m.idx_a], uv_b0, m.valid)
                g = prior_from_points(uv_b0, tri0.depth_b, tri0.good, H, W, block=blk)
                # The most accurate source while it lasts: three votes.
                g, _ = anchored(g._replace(weight=g.weight * 3.0))
                grids.append(_gated(g, tri0.good.sum(), 20))
            frames_left -= 1
            self._boot_anchor = (
                None if frames_left <= 0 or n_anchor < 30
                else ((kp_a, desc_a), T_wc_a, frames_left)
            )

        if prop is not None:
            grids.append(prop)
        fused, wsum = _fuse_grids(grids, blk)
        if prop is not None:
            fused = fused._replace(inv_depth=fused.inv_depth / gauge_ratio(fused, prop))
        fused = fill_prior(fused)
        # Before the bootstrap: install only once a source has fired (one
        # scalar read, paid until the prior exists).
        if self._depth_prior is None:
            if float(wsum.sum()) <= 0.0:
                return
            self.tracer.count("boot_inits")
        self._depth_prior = fused

    def _drop_prior(self) -> None:
        """Forget the depth prior and what goes with it after a loss (counter
        `boot_resets`: a prior that was there dropped)."""
        if self._depth_prior is not None:
            self.tracer.count("boot_resets")
        self._depth_prior = self._kp_depth = self._boot_anchor = None

    def _prior_core(self, T_rel, ab, prev_pts, cur_pyr, matches):
        """The steady-state refresh (`_fused_prior_update`) -> (prior, depths
        per keypoint)."""
        fcfg = self.config.features
        uv_a, uv_b, good, _, idx_b, _ = matches
        return _fused_prior_update(
            self._depth_prior, T_rel, ab, prev_pts,
            cur_pyr.images[0], cur_pyr.grad_x[0], cur_pyr.grad_y[0],
            uv_a, uv_b, good, idx_b,
            cam=self.cam, blk=self.config.tracker.bootstrap_block,
            cap=fcfg.per_level * fcfg.detect_levels,
        )

    def _refine_selected(self, pts, T_rel, prev_pyr):
        """Refine freshly selected points' inverse depths photometrically
        against the previous frame (pose prev <- cur known from tracking).
        The refined depths are anchored to the prior's gauge (the median
        ratio against the prior-sampled depths pinned to 1), or they would
        walk the monocular scale; a point that fails the refinement's gates
        keeps its prior-sampled depth."""
        ref = refine_inverse_depth(
            pts, se3.inverse(T_rel), prev_pyr.images[0], prev_pyr.grad_x[0],
            prev_pyr.grad_y[0], self.cam,
        )
        z_prior = pts.p3d[..., 2]
        rho_prior = 1.0 / torch.clamp(z_prior, min=1e-6)
        s = masked_median(ref.inv_depth / torch.clamp(rho_prior, min=1e-6), ref.good)
        s = torch.where((ref.good.sum(-1) >= 32) & (s > 1e-3), s, 1.0)
        z = torch.where(ref.good, s[..., None] / torch.clamp(ref.inv_depth, min=1e-6), z_prior)
        return pts._replace(p3d=self.cam.unproject(pts.uv, z))

    def _make_keyframe(self, ts, pyr, pts, cur_feats, depth_dev=None) -> Keyframe:
        """A keyframe; with relocalization or the feature front end on, it
        carries feature keypoints and their camera-frame 3D points for PnP:
        from the depth image, else the depth prior, else the monocular
        depth, and where a keypoint has a triangulated depth of its own
        (`_kp_depth`), that one (the coarse grid quantizes depth across
        cells). Keypoints over depth holes or edges are masked out: they
        would carry the fallback depth."""
        kf = Keyframe(self._frame_id, ts, self._T_wc, pyr, pts)
        if cur_feats is None and self.config.use_reloc:
            cur_feats = self._detect_features(pyr)
        if cur_feats is not None:
            kps, desc = cur_feats
            tcfg = self.config.tracker
            depth, depth_ok = _depth_at(depth_dev, kps.uv, tcfg.mono_depth)
            if depth_dev is None and self._depth_prior is not None:
                depth = sample_prior(self._depth_prior, kps.uv, tcfg.mono_depth,
                                     shrink=tcfg.bootstrap_shrink)
            if depth_dev is None and self._kp_depth is not None:
                d_kp = self._kp_depth[: kps.uv.shape[0]]
                depth = torch.where(d_kp > 1e-6, d_kp, depth)
            kf = kf._replace(
                kp_uv=kps.uv, kp_desc=desc, kp_valid=kps.valid & depth_ok,
                kp_p3d=self.cam.unproject(kps.uv, depth),
            )
        return kf

    def _on_new_keyframe(self, kf) -> None:
        """A new keyframe's hooks, by the JAX package's rule. With `global_ba`
        its features are kept for the end-of-run global BA. With loop
        closure: window BA in flight is retired first (a keyframe match, the
        solve it dispatches and a solve in flight: the pose graph must see
        the refined poses, or their write-back would rightly be skipped), the
        keyframe is recorded, a loop is sought for it, and on success the
        pose graph's correction is written to the keyframe poses and the
        window, and the newest keyframe's correction reaches the live pose
        through `_apply_live_correction` (in the pipelined loop: the chain
        head at the next dispatch, the frames in flight at their retirement,
        each once)."""
        if self.config.global_ba and kf.kp_desc is not None:
            self._kf_history.append((kf.frame_id, kf.kp_uv, kf.kp_desc, kf.kp_valid, kf.kp_p3d))
        if self._loops is None or kf.kp_desc is None:
            return
        self._retire_window_ba(wait=True)
        with self.tracer.span("loop_detect"):
            self._loops.add_keyframe(kf)
            edge = self._loops.detect()
        self.loop_stats["keyframes"] += 1
        if edge is None:
            return
        with self.tracer.span("loop_pgo"):
            corrected = self._loops.optimize()
        self.loop_stats["pgo_runs"] += 1
        if not corrected or not all(np.isfinite(T).all() for T in corrected.values()):
            return
        self._kf_poses.update((fid, np.array(T, np.float32)) for fid, T in corrected.items())
        kfs = self.keyframes.keyframes
        last_old = kfs[-1].T_wc.cpu().numpy()
        for i, k in enumerate(kfs):
            Tn = corrected.get(k.frame_id)
            if Tn is not None:
                kfs[i] = k._replace(T_wc=torch.from_numpy(np.array(Tn, np.float32)).to(self.device))
        last_new = corrected.get(kfs[-1].frame_id)
        if last_new is not None:
            self._apply_live_correction(last_new @ self._np_inv_se3(last_old))

    def _relocalize(self, pyr, cur_feats=None):
        """PnP against the newest keyframes, newest first. Returns
        (T_wc, kf_id, features) on success, else None; the features
        (detected here unless the front end already has them) come back so
        a new keyframe can reuse them. Minimal samples come from a
        generator seeded with the frame id."""
        rcfg = self.config.reloc
        if cur_feats is None:
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
        self.tracer.count("sync")
        with self.timers.stage("ingest"):
            pyr = self._ingest_pyramid(image)
        depth_dev = None if depth is None else self._ingest_depth(depth)
        with self.timers.stage("features"):
            cur_feats = self._detect_features(pyr) if self.config.use_features else None

        if self._prev is None:
            pts = self._select_points(pyr, depth_dev)
            kf = self._make_keyframe(ts, pyr, pts, cur_feats, depth_dev)
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
            self._prev_feats = cur_feats
            if self.config.use_ba and self.device.type == "cuda" and not self._ba_warmed:
                self._warm_window_ba(kf)
            if self._bootstrap_enabled(depth_dev) and cur_feats is not None:
                self._boot_anchor = (cur_feats, self._T_wc,
                                     self.config.tracker.bootstrap_anchor_frames)
        else:
            state = self._track_frame(pyr, ts, depth_dev, cur_feats)
        self._record(state)
        self._frame_id += 1
        self._retire_window_ba()   # nothing happens until a dispatched solve is ready
        return state

    def _record(self, state: FrameState) -> FrameState:
        """Append a frame's state to the trajectory and count it (lost,
        relocalized, keyframes)."""
        self.trajectory.append(state)
        if state.status != "ok":
            self.tracer.count(state.status)
        if state.is_keyframe:
            self.tracer.count("keyframes")
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

    def _track_frame(self, pyr, ts: float, depth_dev, cur_feats=None) -> FrameState:
        cfg = self.config
        prev_pyr, prev_pts, prev_depth = self._prev
        self._last_matches = None
        if cfg.use_features and self._prev_feats is not None:
            if self._bootstrap_enabled(prev_depth):
                # Under the depth bootstrap the tracker runs on the spread
                # top-K selection: patch points sit on corners, the very
                # occlusion boundaries where depth is bimodal. The features
                # serve matching and triangulation only.
                self._last_matches = self._match_only(self._prev_feats, cur_feats)
            else:
                feat_pts, n_matches = self._feature_points(
                    self._prev_feats, cur_feats, prev_depth
                )
                if int(n_matches) >= cfg.features.min_matches:
                    prev_pts = feat_pts
        T_init = self._velocity      # constant velocity: T_cur<-prev ~ the last motion
        if (self._bootstrap_enabled(prev_depth) and self._depth_prior is None
                and self._last_matches is not None):
            boot = self._bootstrap_init(self._last_matches)
            if boot is not None:
                T_init, self._depth_prior = boot
                self.tracer.count("boot_inits")
                prev_pts = self._apply_prior(prev_pts)
        with self.timers.stage("track"):
            T_rel, T_wc_new, diag = self._track_and_diag(
                prev_pyr, pyr, prev_pts, T_init, self.keyframes.latest.T_wc,
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
        if self._is_lost(inliers, capacity, track_error, pose_finite, T_wc_np):
            # A pose jump breaks the prior's association with its frame.
            self._drop_prior()
            with self.timers.stage("reloc"):
                reloc = self._relocalize(pyr, cur_feats)
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
            if self._bootstrap_enabled(depth_dev):
                if (self._depth_prior is not None and self._boot_anchor is None
                        and self._last_matches is not None):
                    # Steady state: nothing read on the host.
                    self._depth_prior, self._kp_depth = self._prior_core(
                        T_rel, None, prev_pts, pyr, self._last_matches
                    )
                else:
                    # Bootstrap window or recovery: all sources, the
                    # wide-baseline anchor and the install gate.
                    self._update_prior(T_rel, prev_pts, pyr, cur_feats)
        with self.timers.stage("select"):
            pts = self._select_points(pyr, depth_dev)
            if (status == "ok" and cfg.tracker.bootstrap_refine_points
                    and self._bootstrap_enabled(depth_dev) and self._depth_prior is not None):
                # The coarse grid quantizes depth across the discontinuities
                # that high-gradient points sit on; one refinement pass
                # against the previous frame gives each point its own depth.
                pts = self._refine_selected(pts, T_rel, prev_pyr)
        is_kf = status != "lost" and (
            status == "relocalized"
            or self.keyframes.should_insert(self._frame_id, self._T_wc, ratio,
                                            rel_log=rel_kf_log)
        )
        if is_kf:
            with self.timers.stage("keyframe"):
                kf = self._make_keyframe(ts, pyr, pts, cur_feats, depth_dev)
                prev_kf = self.keyframes.latest
                self.keyframes.insert(kf)
                self._kf_poses[kf.frame_id] = (
                    T_wc_np if status == "ok" else self._T_wc.cpu().numpy()
                )
                self._on_new_keyframe(kf)
            with self.timers.stage("ba"):
                self._window_ba_on_keyframe(prev_kf, kf)
        ref_kf = self.keyframes.latest
        if status == "ok" and not is_kf:
            T_wc_host, T_kf_frame = T_wc_np, T_kf_frame_np
        else:
            # The pose moved (lost, relocalized) or a keyframe was made (and
            # a window solve may have corrected the live pose): read the
            # live pose and the pose relative to the keyframe together.
            both = torch.stack([
                self._T_wc, se3.compose(se3.inverse(ref_kf.T_wc), self._T_wc)
            ]).cpu().numpy()
            T_wc_host, T_kf_frame = both[0], both[1]
        self._prev = (pyr, pts, depth_dev)
        self._prev_feats = cur_feats
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
        diagnostics poses on the host. Window bundle adjustment and loop
        closure produce such corrections."""
        C = self._np_normalize_se3(C)
        self._corr_pending = self._np_normalize_se3(C @ self._corr_pending)
        self._corr_accum = self._np_normalize_se3(C @ self._corr_accum)

    def _apply_live_correction(self, correction) -> None:
        """Route a correction of the live pose: directly on the synchronous
        path; through the pending correction while frames are in flight (the
        chain head is already past the frame being retired, and touching
        `_T_wc` too would apply it twice). Either way `_corr_accum` records it."""
        C = self._np_normalize_se3(correction)
        if self._pipelined:
            self._push_correction(C)
        else:
            self._corr_accum = self._np_normalize_se3(C @ self._corr_accum)
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
    def _np_normalize_se3(T) -> np.ndarray:
        """Host-side `se3.normalize` for a pose whose rotation block has
        drifted more than HOST_DRIFT_ATOL (the largest entry of R^T R - I)
        off SO(3): the same Frobenius de-scaling and two Newton steps. A pose
        within it passes unchanged, bit for bit as the JAX package composes
        it. Corrections and the poses they move are composed on the host in
        f32; unnormalized, their rotations drift, a keyframe pose that
        drifted makes the next correction (refined pose times the transposed
        rotation of the old one) drift further, and within a few hundred
        frames a pose is singular."""
        T = np.asarray(T, np.float32)
        R = T[:3, :3]
        R64 = R.astype(np.float64)
        if np.abs(R64.T @ R64 - np.eye(3)).max() <= HOST_DRIFT_ATOL:
            return T
        R = R / np.float32(max(float(np.sqrt(np.sum(R * R) / 3.0)), 1e-12))
        eye = np.eye(3, dtype=np.float32)
        for _ in range(2):
            R = R @ (np.float32(1.5) * eye - np.float32(0.5) * (R.T @ R))
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = R
        out[:3, 3] = T[:3, 3]
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

    @staticmethod
    def _pose_and_diag(out, prev_pts, T_wc, T_ref, corr, clock: StageClock, extra=()):
        """The speculative pose chain and the diagnostics row (PIPE_DIAG
        floats, the floats of `extra`, then room for the stage times that
        `clock`'s last stamp writes) of a megastep -> (T_rel, T_wc_new, diag)."""
        T_rel = out.T[0]
        T_wc_in = se3.compose(corr, T_wc)
        T_wc_new = se3.normalize(se3.compose(T_wc_in, se3.inverse(T_rel)))
        tail = clock.tail()
        diag = torch.cat([
            torch.stack([
                out.inliers[0].float(), prev_pts.valid.sum().float(),
                out.error[0].float(), torch.isfinite(T_rel).all().float(),
            ]),
            T_wc_new.reshape(-1),
            se3.log(se3.compose(se3.inverse(T_ref), T_wc_new)),
            *((torch.stack([x.float() for x in extra]),) if extra else ()),
            *(() if tail is None else (tail,)),
        ])
        return T_rel, T_wc_new, diag

    def _build_step_plain(self):
        """The whole steady-state frame as one function of tensors, `step(img,
        prev_pyr, prev_pts, T_init, T_wc, T_ref, corr) -> (pyr, pts, T_rel,
        T_wc_new, diag)`: convert, rectify, crop, pyramid (K1), coarse-to-fine
        LM tracking (K3, K2, lm_evaluate), the speculative pose chain, the
        diagnostics (`_pose_and_diag`) and the next frame's top-K points, with
        a device clock stamp (`ops.stamp`) before and after each of those
        stages (PLAIN_STAGES) on a CUDA device. Nothing in it reads the
        device, so a CUDA graph can hold it."""
        cam = self.cam
        tcfg = self.config.tracker

        def step(img, prev_pyr, prev_pts, T_init, T_wc, T_ref, corr):
            clock = StageClock(PLAIN_STAGES, img.device)
            clock.mark()
            pyr = self._ingest_pyramid(img)
            clock.mark()
            out = track(
                prev_pyr, pyr, prev_pts, cam, T_init=T_init[None],
                levels=tcfg.track_levels, max_iters=tcfg.max_iterations,
                weight_kind=tcfg.weight_kind, mode=tcfg.track_mode,
                affine=tcfg.affine_brightness,
            )
            clock.mark()
            T_rel, T_wc_new, diag = self._pose_and_diag(out, prev_pts, T_wc, T_ref, corr, clock)
            clock.mark()
            pts = topk_gradient_points(
                pyr.images[0], pyr.grad_mag[0], cam, num_points=tcfg.num_points,
                mono_z=tcfg.mono_depth, block=tcfg.point_block,
            )
            clock.mark(diag[PIPE_DIAG:])
            return pyr, pts, T_rel, T_wc_new, diag

        return step

    def _build_step_boot(self):
        """The steady-state frame under the depth bootstrap as one function
        of tensors: the stages of the plain step plus feature detection and
        description (K3), previous -> current matching with F-RANSAC, the
        fused refresh of the depth prior (K3 on the frame's texels) and the
        next frame's points at the new prior's depths, stamped at each stage
        boundary (BOOT_STAGES) on a CUDA device. `step(img, prev_pyr,
        prev_pts, prev_kp_uv, prev_desc, prev_kp_valid, prior, T_init, T_wc,
        T_ref, corr, uniforms) -> (pyr, kps, desc, T_rel, T_wc_new, prior_new,
        kp_depth, pts, diag)`, the row BOOT_DIAG floats (the plain step's,
        then the mutual matches and their F-RANSAC inliers) before the stage
        times. The RANSAC samples come from `uniforms`, drawn on the host per
        frame; nothing in the step reads the device."""
        cam = self.cam
        tcfg = self.config.tracker
        fcfg = self.config.features
        cap = fcfg.per_level * fcfg.detect_levels

        def step(img, prev_pyr, prev_pts, prev_kp_uv, prev_desc, prev_kp_valid, prior,
                 T_init, T_wc, T_ref, corr, uniforms):
            clock = StageClock(BOOT_STAGES, img.device)
            clock.mark()
            pyr = self._ingest_pyramid(img)
            clock.mark()
            kps, desc = self._detect_features(pyr)
            clock.mark()
            uv_a, uv_b, good, _, idx_b, mutual = self._match_features(
                prev_kp_uv, prev_desc, prev_kp_valid, kps.uv, desc, kps.valid, uniforms
            )
            clock.mark()
            out = track(
                prev_pyr, pyr, prev_pts, cam, T_init=T_init[None],
                levels=tcfg.track_levels, max_iters=tcfg.max_iterations,
                weight_kind=tcfg.weight_kind, mode=tcfg.track_mode,
                affine=tcfg.affine_brightness,
            )
            clock.mark()
            T_rel, T_wc_new, diag = self._pose_and_diag(
                out, prev_pts, T_wc, T_ref, corr, clock, extra=(mutual.sum(), good.sum()))
            clock.mark()
            prior_new, kp_depth = _fused_prior_update(
                prior, T_rel, None, prev_pts, pyr.images[0], pyr.grad_x[0], pyr.grad_y[0],
                uv_a, uv_b, good, idx_b, cam=cam, blk=tcfg.bootstrap_block, cap=cap,
            )
            clock.mark()
            pts = topk_gradient_points(
                pyr.images[0], pyr.grad_mag[0], cam, num_points=tcfg.num_points,
                mono_z=tcfg.mono_depth, block=tcfg.point_block,
            )
            pts = self._prior_depths(prior_new, pts)
            clock.mark(diag[BOOT_DIAG:])
            return pyr, kps, desc, T_rel, T_wc_new, prior_new, kp_depth, pts, diag

        return step

    def _graph(self, key: tuple, fn, inputs) -> CapturedStep:
        """The CUDA graph of `fn` kept under `key`, captured on `inputs` at
        its first use (span `capture`, counter `captures`; counters
        `lm_kernel_levels` and `lm_plain_levels` add the LM levels that
        each replay of it runs, by path: those of the call captured, the
        last call of `fn`)."""
        step = self._steps.get(key)
        if step is None:
            levels = {}

            def counted(*args):
                before = dict(LM_LEVELS)
                out = fn(*args)
                levels.update((name, n - before[name]) for name, n in LM_LEVELS.items())
                return out

            with self.tracer.span("capture"):
                step = self._steps[key] = CapturedStep(counted, inputs)
            self.tracer.count("captures")
            for name, n in levels.items():
                self.tracer.count(name, n)
        return step

    def _run_step(self, kind: str, *inputs):
        """One megastep (`kind` "plain" or "boot"): eagerly on a CPU device;
        on a CUDA device one replay of the graph captured for this kind,
        frame dtype and shape at its first use. The replay's outputs are
        cloned: the next replay overwrites the graph's own, while a frame's
        pyramid and points live on until its retirement (and as the next
        frame's inputs). Span `replay`: the step (the inputs' copy-in, the
        replay and the clones)."""
        build = self._build_step_boot if kind == "boot" else self._build_step_plain
        if self.device.type == "cpu":
            with self.tracer.span("replay"):
                return build()(*inputs)
        step = self._graph((kind, inputs[0].dtype, tuple(inputs[0].shape)), build(), inputs)
        with self.tracer.span("replay"):
            return tree_clone(step(*inputs))

    @property
    def graph_replays(self) -> int:
        """Frames that went through a CUDA graph replay so far."""
        return sum(step.replays for key, step in self._steps.items()
                   if key[0] in ("plain", "boot"))

    def _can_pipeline(self, depth) -> bool:
        """The megastep covers the two steady states: plain direct tracking,
        and bootstrap tracking with an installed prior. The first frame, a
        frame with a depth image, dense points, profiling (stage timers need
        fenced stages), the bootstrap's init window, the feature front end
        without the bootstrap (patch points) and the recovery from a lost
        frame take the synchronous path."""
        if depth is not None or self._prev is None or self._pipe_broken:
            return False
        cfg = self.config
        if cfg.tracker.point_mode == "dense" or cfg.profile:
            return False
        if not cfg.use_features:
            return True
        return (cfg.tracker.depth_bootstrap and self._depth_prior is not None
                and self._boot_anchor is None and not cfg.tracker.bootstrap_refine_points)

    def process_frame_async(self, image, depth=None,
                            timestamp: float | None = None) -> FrameState | None:
        """Pipelined frame processing: dispatch this frame's megastep, then
        retire earlier frames whose batched diagnostics transfer has been
        overlapping the dispatches. Returns the newest retired state or None.

        Diagnostics are read `_pipe_batch` (4) frames at a time and a batch
        is staged one call ahead, so a frame's FrameState, and the keyframe
        decision with it, lands 2 to 5 calls after its dispatch, with 6, 5, 4
        and 3 frames in flight (itself included) as a batch retires. Use
        `process_frame` when keyframe latency matters more than throughput.
        Call `flush()` after the last frame.

        Host spans (`self.tracer`): `frame` (the call), and inside it
        `dispatch` (with `capture` and `replay`), `retire_wait` (the wait on
        the batch's event), `retire` per frame retired (with `keyframe` and
        `relocalize`) and `stage_diags`."""
        with self.tracer.span("frame"):
            if not self._can_pipeline(depth):
                self.flush()   # retired states land in self.trajectory
                self._pipe_broken = False
                return self.process_frame(image, depth, timestamp)
            ts = float(timestamp) if timestamp is not None else float(self._frame_id)
            self._pipelined = True
            try:
                self._pipe_queue.append(self._dispatch_pipelined(image, ts))
                state = self._retire_ready()
                # A window solve that has finished lands here; one that has
                # not is left alone: the loop never waits for it.
                self._retire_window_ba()
                if self._pipe_ready is None and len(self._pipe_queue) > self._pipe_batch:
                    recs = self._pipe_queue[: self._pipe_batch]
                    del self._pipe_queue[: self._pipe_batch]
                    with self.tracer.span("stage_diags"):
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
        with self.tracer.span("retire_wait"):
            if event is not None:
                event.synchronize()
        rows = rows.numpy()
        state = None
        for k, rec in enumerate(recs):
            state = self._retire_pipelined(rec, rows[k])
        return state

    def _dispatch_pipelined(self, image, ts: float) -> dict:
        with self.tracer.span("dispatch"):
            if np.allclose(self._corr_pending, np.eye(4)):
                corr = self._eye
            else:
                corr = torch.from_numpy(self._corr_pending).to(self.device)
            self._corr_pending = np.eye(4, dtype=np.float32)
            prev_pyr, prev_pts, _ = self._prev
            T_ref = self.keyframes.latest.T_wc
            feats = kp_depth = prior_new = uniforms = None
            if not self.config.use_features:
                pyr, pts, T_rel, T_wc_new, diag = self._run_step(
                    "plain", self._to_device(image), prev_pyr, prev_pts, self._velocity,
                    self._T_wc, T_ref, corr,
                )
            else:
                kp_prev, desc_prev = self._prev_feats
                uniforms = self._ransac_uniforms(desc_prev.shape[0], self._frame_id)
                (pyr, kps, desc, T_rel, T_wc_new, prior_new, kp_depth, pts,
                 diag) = self._run_step(
                    "boot", self._to_device(image), prev_pyr, prev_pts,
                    kp_prev.uv, desc_prev, kp_prev.valid, self._depth_prior,
                    self._velocity, self._T_wc, T_ref, corr, uniforms,
                )
                feats = (kps, desc)
                self.tracer.count("boot_replays")
                self._depth_prior = prior_new
                self._kp_depth = kp_depth
            # Advance the device-side chain speculatively (status "ok").
            self._velocity = T_rel
            self._T_wc = T_wc_new
            self._prev = (pyr, pts, None)
            self._prev_feats = feats
            rec = {
                "frame_id": self._frame_id, "ts": ts, "diag": diag, "pyr": pyr, "pts": pts,
                "feats": feats, "kp_depth": kp_depth, "prior": prior_new,
                "T_rel": T_rel, "uniforms": uniforms,
                "corr_at_dispatch": self._corr_accum.copy(),
                "ref_kf_id": self.keyframes.latest.frame_id,
            }
            self._frame_id += 1
            self.tracer.count("dispatched")
            return rec

    def _retire_pipelined(self, rec=None, diag_row=None) -> FrameState:
        """Host bookkeeping for one in-flight frame (span `retire`): failure
        gate, keyframe policy (a few frames late by construction), trajectory
        append. The state carries the frames in flight and, on a CUDA device,
        its megastep's stage times."""
        if rec is None:
            rec = self._pipe_queue.pop(0)
        in_flight = self.tracer.counts["dispatched"] - self.tracer.counts["retired"]
        self.tracer.count("retired")
        with self.tracer.span("retire"):
            state = self._retire_frame(rec, diag_row)
            state.in_flight = in_flight
            if state.step_ms is not None:
                self.tracer.add_step_ms(state.step_ms)
            return self._record(state)

    def _step_ms(self, diag) -> dict[str, float] | None:
        """The stage times that a megastep's last stamp wrote after its
        diagnostics, by stage; None where the row has none (a CPU device)."""
        boot = self.config.use_features
        width = BOOT_DIAG if boot else PIPE_DIAG
        if len(diag) <= width:
            return None
        return dict(zip(BOOT_STAGES if boot else PLAIN_STAGES, diag[width:].tolist()))

    def _retire_frame(self, rec, diag_row) -> FrameState:
        ref_kf = self.keyframes.latest
        kf_pose = np.asarray(self._kf_poses[ref_kf.frame_id], np.float32)
        if self._pipe_broken:
            # Dispatched on a chain that later proved lost: coast on the
            # recovered pose, ignore the diagnostics.
            T_wc_np = self._T_wc.cpu().numpy()
            return FrameState(
                frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
                tracked_inliers=0, track_error=float("nan"), is_keyframe=False,
                ref_kf_id=ref_kf.frame_id,
                T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status="lost",
                step_ms=None if diag_row is None else self._step_ms(diag_row),
            )
        diag = diag_row if diag_row is not None else rec["diag"].cpu().numpy()
        step_ms = self._step_ms(diag)
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
            T_wc_np = self._np_normalize_se3(self._corr_accum @ self._np_inv_se3(delta) @ T_wc_np)
        ratio = inliers / max(capacity, 1)

        if self._is_lost(inliers, capacity, track_error, pose_finite, T_wc_np):
            # Found late: the frames dispatched after this one ran on a
            # garbage chain. Drain them and resynchronize.
            self._pipe_broken = True
            self._drop_prior()
            status = "lost"
            with self.tracer.span("relocalize"):
                reloc = self._relocalize(rec["pyr"], rec["feats"])
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
            return FrameState(
                frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
                tracked_inliers=inliers, track_error=track_error, is_keyframe=False,
                ref_kf_id=ref_kf.frame_id,
                T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status=status,
                step_ms=step_ms,
            )

        if rec["feats"] is not None:
            self.tracer.count("boot_matches", int(diag[PIPE_DIAG]))
            self.tracer.count("boot_inliers", int(diag[PIPE_DIAG + 1]))
        # If a keyframe landed while this frame was in flight, the
        # diagnostics' motion relative to the keyframe is stale.
        if rec["ref_kf_id"] != ref_kf.frame_id:
            rel_kf_log = self._np_rel_log(kf_pose, T_wc_np)
        is_kf = self.keyframes.should_insert(rec["frame_id"], T_wc_np, ratio,
                                             rel_log=rel_kf_log)
        if is_kf:
            with self.tracer.span("keyframe"):
                # Keyframe creation (and its depth reads) must see THIS
                # frame, not the chain head.
                saved = (self._T_wc, self._frame_id, self._kp_depth, self._depth_prior)
                self._T_wc = torch.from_numpy(T_wc_np).to(self.device)
                self._frame_id = rec["frame_id"]
                if rec["kp_depth"] is not None:
                    self._kp_depth = rec["kp_depth"]
                if rec["prior"] is not None:
                    self._depth_prior = rec["prior"]
                with self.tracer.span("make_keyframe"):
                    kf = self._make_keyframe(rec["ts"], rec["pyr"], rec["pts"], rec["feats"])
                self._T_wc, self._frame_id, self._kp_depth, self._depth_prior = saved
                prev_kf = self.keyframes.latest
                self.keyframes.insert(kf)
                self._kf_poses[kf.frame_id] = T_wc_np.copy()
                self._on_new_keyframe(kf)
                self._window_ba_on_keyframe(prev_kf, kf)
            ref_kf = self.keyframes.latest
            kf_pose = self._kf_poses[ref_kf.frame_id]
        return FrameState(
            frame_id=rec["frame_id"], timestamp=rec["ts"], T_wc=T_wc_np,
            tracked_inliers=inliers, track_error=track_error, is_keyframe=is_kf,
            ref_kf_id=ref_kf.frame_id,
            T_kf_frame=self._np_inv_se3(kf_pose) @ T_wc_np, status="ok", step_ms=step_ms,
        )

    def flush(self) -> FrameState | None:
        """Retire every in-flight frame (after the last frame, or before a
        frame that takes the synchronous path). Span `flush`."""
        with self.tracer.span("flush"):
            if not self._pipe_queue and self._pipe_ready is None:
                self._retire_window_ba(wait=True)
                self._drain_pending_correction()
                return None
            self._pipelined = True
            try:
                state = self._retire_ready()
                while self._pipe_queue:
                    state = self._retire_pipelined()
                self._retire_window_ba(wait=True)
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

    # --------------------------------------------------------- window BA

    def _window_ba_on_keyframe(self, prev_kf, kf) -> None:
        """A new keyframe's bundle-adjustment hooks, by the JAX package's rule
        (photometric BA needs no feature tracks). Photometric: every
        `run_every_n_keyframes`, a window solve, synchronous. Reprojection:
        the two keyframes' feature match is dispatched (`_dispatch_keyframe_
        match`) and applied to the track graph when it has arrived, with the
        window solve it makes due, over the window of this keyframe
        (`_retire_keyframe_match`); in the pipelined loop that is a few frames
        later, in the synchronous loop and with `ba.asynchronous` off at once.
        At most one match is in flight, so the track graph grows in keyframe
        order."""
        cfg = self.config
        if not (cfg.use_ba and prev_kf is not None):
            return
        if not cfg.ba.photometric and (prev_kf.kp_desc is None or kf.kp_desc is None):
            return
        self._retire_keyframe_match(wait=True)
        self._kf_since_ba += 1
        due = self._kf_since_ba >= cfg.ba.run_every_n_keyframes
        if due:
            self._kf_since_ba = 0
        if cfg.ba.photometric:
            if due:
                self._run_window_ba()
            return
        self._match_inflight = self._dispatch_keyframe_match(
            prev_kf, kf, self._window_snapshot() if due else None)
        if not (self._pipelined and cfg.ba.asynchronous):
            self._retire_keyframe_match(wait=True)

    def _keyframe_match_table(self, kp_uv_a, desc_a, valid_a, kp_uv_b, desc_b, valid_b,
                              uniforms, ratio: float | None = None) -> torch.Tensor:
        """Two keyframes' verified matches as one (K_a, 7) table: idx_a,
        idx_b, uv_a, uv_b, good."""
        uv_a, uv_b, good, idx_a, idx_b, _ = self._match_features(
            kp_uv_a, desc_a, valid_a, kp_uv_b, desc_b, valid_b, uniforms, ratio)
        return torch.cat([idx_a[:, None].float(), idx_b[:, None].float(), uv_a, uv_b,
                          good[:, None].float()], dim=-1)

    def _match_step(self, inputs) -> CapturedStep:
        """The keyframe match captured for these keypoint capacities (the
        caller is on the solves' stream)."""
        return self._graph(("match", inputs[1].shape[0], inputs[4].shape[0]),
                           self._keyframe_match_table, inputs)

    def _dispatch_keyframe_match(self, prev_kf, kf, window) -> dict:
        """Start the match of two keyframes' features. On a CUDA device it is
        one graph replay on the solves' stream, behind an event of the frame
        stream (the keyframes' descriptors are written there), and the table
        goes to pinned memory with an event behind it; on the CPU it is
        computed here. `window` is the window a solve due at `kf` works on."""
        with self.tracer.span("match_dispatch"):
            feats = (prev_kf.kp_uv, prev_kf.kp_desc, prev_kf.kp_valid,
                     kf.kp_uv, kf.kp_desc, kf.kp_valid)
            event = None
            if self.device.type == "cpu":
                table = self._keyframe_match_table(
                    *feats, self._ransac_uniforms(prev_kf.kp_desc.shape[0], kf.frame_id))
            else:
                ready = torch.cuda.Event()
                ready.record()
                with torch.cuda.stream(self._ba_stream):
                    self._ba_stream.wait_event(ready)
                    for t in feats:
                        t.record_stream(self._ba_stream)
                    inputs = (*feats,
                              self._ransac_uniforms(prev_kf.kp_desc.shape[0], kf.frame_id))
                    on_card = self._match_step(inputs)(*inputs)
                    table = torch.empty(on_card.shape, dtype=on_card.dtype, pin_memory=True)
                    table.copy_(on_card, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
        return {"ids": (prev_kf.frame_id, kf.frame_id), "table": table, "event": event,
                "window": window}

    def _retire_keyframe_match(self, wait: bool = False) -> None:
        """Apply a dispatched keyframe match to the track graph and dispatch
        the window solve it made due. Without `wait` nothing happens until
        the table has arrived."""
        rec = self._match_inflight
        if rec is None:
            return
        if rec["event"] is not None:
            if not wait and not rec["event"].query():
                return
            with self.tracer.span("match_wait"):
                rec["event"].synchronize()
        self._match_inflight = None
        with self.tracer.span("add_keyframe_matches"):
            table = rec["table"].numpy()
            self._tracks.add_keyframe_matches(
                *rec["ids"], table[:, 0].astype(np.int64), table[:, 1].astype(np.int64),
                table[:, 2:4], table[:, 4:6], table[:, 6] > 0.5,
            )
        if rec["window"] is not None:
            self._run_window_ba(rec["window"])

    def _window_snapshot(self):
        """The window a solve due now works on -> (keyframe ids, their poses)
        or None under three keyframes; the solve before it is retired first
        (at most one in flight: by now it has long finished)."""
        self._retire_solve(wait=True)
        kfs = self.keyframes.keyframes
        if len(kfs) < 3:
            return None
        kf_ids = [k.frame_id for k in kfs]
        return kf_ids, {fid: np.asarray(self._kf_poses[fid], np.float32).copy()
                        for fid in kf_ids}

    @staticmethod
    def _packed(out) -> torch.Tensor:
        """What the host needs of a window solve's result, as one vector:
        iterations, initial and final cost, the refined poses as world <-
        camera."""
        return torch.cat([
            torch.stack([out.iterations.float(), out.initial_cost, out.cost]),
            se3.inverse(out.T_cw).reshape(-1),
        ])

    def _solve_window(self, *problem):
        """Bundle-adjust the window problem (its six tensors), packed."""
        bcfg = self.config.ba
        return self._packed(bundle_adjust(
            BAProblem(*problem), self.cam, max_iters=bcfg.max_iterations,
            huber_delta=bcfg.huber_delta_px,
            num_fixed_poses=2,     # monocular: anchor the frame gauge AND the scale
            pose_prior_weight=bcfg.pose_prior_weight,
        ))

    def _window_step(self, problem: BAProblem) -> CapturedStep:
        """The window solve captured for this problem's shape (the caller is
        on the solves' stream)."""
        return self._graph(("ba", tuple(problem.obs_uv.shape), tuple(problem.points.shape)),
                           self._solve_window, tuple(problem))

    def _warm_window_ba(self, kf) -> None:
        """Capture what the window BA runs before the loop needs it, on inputs
        of its one shape, and replay each graph once: the first frame pays
        the captures' seconds and the first launch of each graph (which
        uploads its thousands of nodes), not a keyframe in the middle of the
        pipelined loop. Photometric: the solve on the first keyframe alone
        (padded, so no observation is valid). Reprojection: the solve on an
        empty problem (every observation invalid) and the keyframe match on
        the first keyframe's features matched with themselves."""
        bcfg = self.config.ba
        self._ba_warmed = True
        if bcfg.photometric:
            problem, active = self._photo_window([kf])
            self._photo_step(problem, active)(*problem, active)
            torch.cuda.current_stream(self.device).synchronize()
            return
        self._ba_stream = torch.cuda.Stream(self.device)
        M = self.keyframes.capacity
        L, O = min(bcfg.landmark_capacity, 1024), min(bcfg.obs_capacity, 8192)
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self._ba_stream):
            self._ba_stream.wait_event(ready)
            dev = self.device
            points = torch.zeros((L, 3), dtype=torch.float32, device=dev)
            points[:, 2].fill_(1.0)
            empty = BAProblem(
                T_cw=self._eye.expand(M, 4, 4).clone(), points=points,
                obs_kf=torch.zeros(O, dtype=torch.int32, device=dev),
                obs_lm=torch.zeros(O, dtype=torch.int32, device=dev),
                obs_uv=torch.zeros((O, 2), dtype=torch.float32, device=dev),
                obs_valid=torch.zeros(O, dtype=torch.bool, device=dev),
            )
            self._window_step(empty)(*empty)
            if kf.kp_desc is not None:
                feats = (kf.kp_uv, kf.kp_desc, kf.kp_valid) * 2
                inputs = (*feats, self._ransac_uniforms(kf.kp_desc.shape[0], 0))
                self._match_step(inputs)(*inputs)
        self._ba_stream.synchronize()

    def _run_window_ba(self, window=None) -> None:
        """Reprojection bundle adjustment over the keyframe window (README
        config 4; what uw-slam's commented-out Ceres scaffolding intended,
        include/Tracker.h:295-505); with `ba.photometric`, the photometric
        solve instead. `window` is (keyframe ids, their poses) as
        `_window_snapshot` took them, by default now.

        This only DISPATCHES the solve. On a CUDA device it runs on a side
        stream, as one replay of a graph captured at the first frame (the
        problem is padded to one shape), and its packed result goes to
        pinned memory with an event behind it; `_retire_solve` writes the
        poses back once the event has passed, through the pending
        correction, so the live loop never waits for the solve. With
        `ba.asynchronous` off the result is retired at once."""
        if self.config.ba.photometric:
            self._run_window_photo_ba()
            return
        window = self._window_snapshot() if window is None else window
        if window is None:
            return
        kf_ids, poses = window
        t0 = time.perf_counter()
        bcfg = self.config.ba
        with self.tracer.span("build_problem"):
            self._tracks.prune_outside_window(set(kf_ids))
            T_cw = np.stack([self._np_inv_se3(poses[fid]) for fid in kf_ids])
            built = self._tracks.build_problem(
                kf_ids, T_cw, self.cam,
                max_landmarks=min(bcfg.landmark_capacity, 1024),
                max_obs=min(bcfg.obs_capacity, 8192),
                # One pose count for every window size: the padding poses
                # carry no observations and the pose prior pins them.
                max_poses=self.keyframes.capacity,
            )
        if built is None:
            return
        problem = built[0]
        event = None
        if self.device.type == "cpu":
            pack = self._solve_window(*problem)
        else:
            # The solve reads only what the host just built: nothing of the
            # frames in flight, so the side stream (made with the capture at
            # the first frame) need not wait for them.
            with torch.cuda.stream(self._ba_stream):
                problem = BAProblem(*(t.to(self.device, non_blocking=True) for t in problem))
                packed = self._window_step(problem)(*problem)
                pack = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                pack.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
        # Retirement writes back only the keyframes whose pose nothing else
        # touched while the solve was in flight.
        self._ba_inflight = {"pack": pack, "event": event, "kf_ids": kf_ids,
                             "poses_at_dispatch": poses}
        self.ba_stats["time"] += time.perf_counter() - t0
        if not bcfg.asynchronous:
            self._retire_solve(wait=True)

    def _retire_window_ba(self, wait: bool = False) -> None:
        """Retire what window BA has in flight: a keyframe match that has
        arrived (which may dispatch a solve), then a solve that has finished.
        With `wait`, wait for both."""
        self._retire_keyframe_match(wait)
        self._retire_solve(wait)

    def _retire_solve(self, wait: bool = False) -> None:
        """Retire a dispatched window solve: write back the refined keyframe
        poses and pass the newest keyframe's correction on to the live pose.
        Without `wait` nothing happens until the result has arrived."""
        rec = self._ba_inflight
        if rec is None:
            return
        event = rec["event"]
        if event is not None:
            if not wait and not event.query():
                return
            t0 = time.perf_counter()
            event.synchronize()
            # What the live loop pays is the dispatch and any wait here; the
            # solve itself overlaps the tracking.
            self.ba_stats["time"] += time.perf_counter() - t0
        self._ba_inflight = None
        row = rec["pack"].numpy()
        iters, c0, c = int(row[0]), float(row[1]), float(row[2])
        self.ba_stats["iters"] += iters
        self.ba_stats["runs"] += 1
        if not np.isfinite(c) or c > c0:
            return
        kf_ids, snap = rec["kf_ids"], rec["poses_at_dispatch"]
        T_wc_new = row[3:].reshape(-1, 4, 4)[: len(kf_ids)]
        updated: dict[int, np.ndarray] = {}
        for i, fid in enumerate(kf_ids):
            cur = self._kf_poses.get(fid)
            if cur is None or not np.allclose(cur, snap[fid]):
                continue   # corrected meanwhile: the stale refinement yields
            if not np.isfinite(T_wc_new[i]).all():
                continue
            self._kf_poses[fid] = T_wc_new[i].copy()
            updated[fid] = T_wc_new[i]
        kfs = self.keyframes.keyframes
        for i, k in enumerate(kfs):
            Tn = updated.get(k.frame_id)
            if Tn is not None:
                kfs[i] = k._replace(T_wc=torch.from_numpy(Tn.copy()).to(self.device))
        if self._loops is not None and updated:
            # The loop closer's history takes the refinement, or its next
            # pose graph would revert it.
            self._loops.update_poses(updated)
        last_fid = kf_ids[-1]
        if last_fid in updated:
            self._apply_live_correction(updated[last_fid] @ self._np_inv_se3(snap[last_fid]))

    # ---------------------------------------------- photometric window BA

    def _photo_window(self, kfs):
        """The keyframes' photometric problem at `ba.photometric_level`, padded
        to the keyframe capacity (one shape on every device: a padding
        keyframe has an identity pose, no valid point and takes no part) ->
        (problem, active (capacity,) bool)."""
        lvl = self.config.ba.photometric_level
        prob = photo_ba_problem_from_keyframes(
            [k.pyramid for k in kfs], [se3.inverse(k.T_wc) for k in kfs],
            [k.points for k in kfs], level=lvl,
        )
        pad = self.keyframes.capacity - len(kfs)
        active = torch.arange(self.keyframes.capacity, device=self.device) < len(kfs)
        if pad <= 0:
            return prob, active

        def padded(x, value):
            fill = torch.full((pad, *x.shape[1:]), value, dtype=x.dtype, device=x.device)
            return torch.cat([x, fill])

        return PhotoBAProblem(
            images=padded(prob.images, 0.0), grad_x=padded(prob.grad_x, 0.0),
            grad_y=padded(prob.grad_y, 0.0),
            T_cw=torch.cat([prob.T_cw, self._eye.expand(pad, 4, 4)]),
            uv=padded(prob.uv, 0.0), inv_depth=padded(prob.inv_depth, 1.0),
            intensity=padded(prob.intensity, 0.0), valid=padded(prob.valid, False),
        ), active

    def _solve_photo_window(self, *args):
        """Photometric BA of the padded window (the problem's eight tensors,
        then `active`), packed."""
        bcfg = self.config.ba
        return self._packed(photometric_bundle_adjust(
            PhotoBAProblem(*args[:-1]), self.cam.scaled(bcfg.photometric_level),
            max_iters=bcfg.max_iterations, huber_delta=bcfg.photometric_huber,
            active=args[-1],
        ))

    def _photo_step(self, problem: PhotoBAProblem, active) -> CapturedStep:
        """The photometric solve captured for this window's shape."""
        return self._graph(("photo", *problem.images.shape, problem.uv.shape[1]),
                           self._solve_photo_window, (*problem, active))

    def _run_window_photo_ba(self) -> None:
        """Direct photometric window BA over the keyframe pyramids (the cost
        uw-slam's ResidualIntensity Ceres scaffolding intended,
        include/Tracker.h:295-505): joint LM over the keyframe poses and the
        points' inverse depths. Synchronous, as in the JAX package: on a CUDA
        device one replay of the graph captured at the first frame and one
        read of the packed result. The refined poses are written back and the
        newest keyframe's correction reaches the live pose."""
        kfs = self.keyframes.keyframes
        if len(kfs) < 3:
            return
        t0 = time.perf_counter()
        problem, active = self._photo_window(kfs)
        if self.device.type == "cpu":
            row = self._solve_photo_window(*problem, active).numpy()
        else:
            row = self._photo_step(problem, active)(*problem, active).cpu().numpy()
        self.ba_stats["iters"] += int(row[0])
        self.ba_stats["time"] += time.perf_counter() - t0
        self.ba_stats["runs"] += 1
        c0, c = float(row[1]), float(row[2])
        if not np.isfinite(c) or c > c0:
            return
        T_new_wc = row[3:].reshape(-1, 4, 4)[: len(kfs)]
        last_old = kfs[-1].T_wc.cpu().numpy()
        for i, k in enumerate(kfs):
            kfs[i] = k._replace(T_wc=torch.from_numpy(T_new_wc[i].copy()).to(self.device))
            self._kf_poses[k.frame_id] = T_new_wc[i].copy()
        if self._loops is not None:
            self._loops.update_poses({k.frame_id: T_new_wc[i] for i, k in enumerate(kfs)})
        self._apply_live_correction(T_new_wc[-1] @ self._np_inv_se3(last_old))

    # ------------------------------------------------- global distributed BA

    @staticmethod
    def _np_inv_se3_batch(Ts: np.ndarray) -> np.ndarray:
        """(N, 4, 4) SE(3) inverses on the host."""
        Ts = np.asarray(Ts, np.float32)
        R = Ts[:, :3, :3]
        out = np.tile(np.eye(4, dtype=np.float32), (Ts.shape[0], 1, 1))
        out[:, :3, :3] = R.transpose(0, 2, 1)
        out[:, :3, 3] = -np.einsum("nji,nj->ni", R, Ts[:, :3, 3])
        return out

    def _global_pairs(self) -> list[tuple[int, int]]:
        """The keyframe pairs (history indices) the global map is matched
        on, in the JAX package's order: each keyframe against its five
        predecessors (skip pairs extend tracks where a keypoint was missed
        and add wide-baseline views), then each accepted loop edge's pair
        and its neighbours (tracks joining the two passes of a revisit)."""
        hist = self._kf_history
        pairs = [(ia, ib) for ib in range(1, len(hist)) for ia in range(max(0, ib - 5), ib)]
        if self._loops is not None and self._loops.loop_edges:
            by_fid = {int(h[0]): i for i, h in enumerate(hist)}
            lh = self._loops.history
            for e in self._loops.loop_edges:
                ia, ib = by_fid.get(int(lh[e.i].frame_id)), by_fid.get(int(lh[e.j].frame_id))
                if ia is None or ib is None:
                    continue
                pairs += [(ia + da, ib + db) for da in (0, 1) for db in (-1, 0)
                          if 0 <= ia + da < ib + db < len(hist)]
        return pairs

    def _global_match_tables(self, pairs) -> np.ndarray:
        """Every pair's match table (`_keyframe_match_table`) -> (P, K_a, 7)
        on the host. On a CUDA device each pair is one replay of a captured
        graph (a pair issued eagerly is thousands of launches), its table
        copied into one device buffer, which is read once at the end.
        RANSAC's uniforms per pair are seeded with fa * 100003 + fb, the
        frame ids of the pair."""
        hist = self._kf_history
        # Keyframes lie 5 to 20 frames apart, where the consecutive-frame
        # ratio test starves the pairs: the ratio is 0.15 wider (at most
        # 0.8); F-RANSAC right after keeps the precision.
        match = partial(self._keyframe_match_table,
                        ratio=min(0.8, self.config.features.ratio + 0.15))
        tables = None
        for p, (ia, ib) in enumerate(pairs):
            a, b = hist[ia], hist[ib]
            inputs = (a[1], a[2], a[3], b[1], b[2], b[3],
                      self._ransac_uniforms(a[2].shape[0], int(a[0]) * 100003 + int(b[0])))
            if self.device.type == "cpu":
                table = match(*inputs)
            else:
                key = ("global-match", a[2].shape[0], b[2].shape[0])
                if key not in self._steps:
                    self._steps[key] = CapturedStep(match, inputs)
                table = self._steps[key](*inputs)
            if tables is None:
                tables = torch.empty((len(pairs), *table.shape), dtype=table.dtype,
                                     device=table.device)
            tables[p].copy_(table)
        return tables.cpu().numpy()

    def run_global_distributed_ba(self, shards: int = 1, max_iters: int = 40,
                                  time_steady_state: bool = True) -> dict | None:
        """Global bundle adjustment over the whole keyframe map (README config
        5), after the live loop: feature tracks rebuilt across the keyframe
        history (`_global_pairs`), landmarks seeded from each keyframe's
        camera-frame keypoint 3D (the depth prior), the problem partitioned
        into `shards` landmark shards per process (`parallel.shard_problem`;
        the JAX package's device count) and solved by the landmark-sharded
        Schur LM (`parallel.distributed_bundle_adjust`), two poses fixed
        (monocular: the frame and the scale). Refined keyframe poses flow
        into the exported trajectory when the cost did not rise.

        Returns stats (keyframes, landmarks, observations, shards, iterations,
        seconds, ba_iters_per_sec, initial and final cost, applied) or None
        when the map is too small. `time_steady_state` solves twice from the
        same state and times the second (the first pays the first calls'
        set-up), as the JAX package does. Needs `global_ba` and the feature
        front end."""
        from .parallel import distributed_bundle_adjust, landmark_layout, shard_problem

        self._retire_window_ba(wait=True)
        hist = self._kf_history
        if len(hist) < 4:
            return None
        graph = TrackGraph(max_tracks=4 * self.config.ba.landmark_capacity)
        min_matches = self.config.features.min_matches
        pairs = self._global_pairs()
        for (ia, ib), table in zip(pairs, self._global_match_tables(pairs)):
            good = table[:, 6] > 0.5
            if int(good.sum()) < min_matches:
                continue
            graph.add_keyframe_matches(
                int(hist[ia][0]), int(hist[ib][0]), table[:, 0].astype(np.int64),
                table[:, 1].astype(np.int64), table[:, 2:4], table[:, 4:6], good)
        kf_ids = [int(h[0]) for h in hist]
        T_cw = self._np_inv_se3_batch(np.stack([self._kf_poses[i] for i in kf_ids]))
        seed_p3d = {int(h[0]): (h[4].cpu().numpy(), h[3].cpu().numpy())
                    for h in hist if h[4] is not None}
        built = graph.build_problem(
            kf_ids, T_cw, self.cam,
            max_landmarks=self.config.ba.landmark_capacity, max_obs=self.config.ba.obs_capacity,
            # Global-map gates: two-view tracks count, and each observation
            # is judged alone at a drift-sized 30 px (odometry drift is what
            # this solve removes; Huber bounds what gets through).
            min_views=2, obs_gate_px=30.0, seed_p3d=seed_p3d or None, device=self.device,
        )
        if built is None:
            return None
        problem, lm_order = built
        n_obs = int(problem.obs_valid.sum())
        if n_obs < 30:
            return None   # too few sane observations to steer a global BA
        layout = landmark_layout(shards)
        sharded = shard_problem(problem, layout.total)
        bcfg = self.config.ba

        def run():
            t0 = time.perf_counter()
            out = distributed_bundle_adjust(
                sharded, self.cam, layout, max_iters=max_iters,
                huber_delta=bcfg.huber_delta_px, num_fixed_poses=2,
                pose_prior_weight=bcfg.global_pose_prior_weight,
            )
            row = torch.stack([out.iterations.float(), out.initial_cost, out.cost]).tolist()
            return out, row, time.perf_counter() - t0

        out, row, dt = run()
        if time_steady_state:
            out, row, dt = run()
        iters, c0, c = int(row[0]), row[1], row[2]
        stats = {
            "keyframes": len(kf_ids), "landmarks": len(lm_order), "observations": n_obs,
            "shards": layout.total, "iterations": iters, "seconds": dt,
            "ba_iters_per_sec": iters / max(dt, 1e-9), "initial_cost": c0, "final_cost": c,
        }
        T_wc_all = self._np_inv_se3_batch(out.T_cw.cpu().numpy())
        # Never apply a non-finite pose (as loop closure's correction).
        applied = bool(np.isfinite(c) and c <= c0 and np.isfinite(T_wc_all).all())
        if applied:
            for i, fid in enumerate(kf_ids):
                self._kf_poses[fid] = T_wc_all[i]
            kfs = self.keyframes.keyframes
            for i, k in enumerate(kfs):
                Tn = self._kf_poses.get(k.frame_id)
                if Tn is not None:
                    kfs[i] = k._replace(T_wc=torch.from_numpy(Tn.copy()).to(self.device))
        stats["applied"] = applied
        return stats

    # ------------------------------------------------------------ export

    # ------------------------------------------------------------ session

    def export_map_ply(self, path: str, max_points: int = 20000) -> int:
        """Write the map as a PLY point cloud: every keyframe's valid tracked
        points in the world frame (under its latest pose), subsampled to at
        most `max_points` by a stride (uw-slam's point-cloud topic,
        src/Visualizer.cpp:421-446). Returns the number of points written."""
        from .viz import write_ply

        clouds = []
        for kf in self.keyframes.keyframes:
            p = kf.points.p3d.reshape(-1, 3).cpu().numpy()[
                kf.points.valid.reshape(-1).cpu().numpy()]
            T = self._kf_poses.get(kf.frame_id)
            T = np.asarray(kf.T_wc.cpu().numpy() if T is None else T)
            clouds.append(p @ T[:3, :3].T + T[:3, 3])
        if not clouds:
            write_ply(path, np.zeros((0, 3), np.float32))
            return 0
        cloud = np.concatenate(clouds)
        if len(cloud) > max_points:
            step = -(-len(cloud) // max_points)
            cloud = cloud[::step]
        write_ply(path, cloud)
        return len(cloud)

    def save_checkpoint(self, path: str) -> None:
        """Save the session (`utils.checkpoint.save_session`, the JAX
        package's keys, so either package resumes the other's file): the
        frame counter, live pose and velocity, the trajectory's records and
        the keyframe poses. The frames in flight, a keyframe match and a
        window solve are retired first (`flush`)."""
        from .utils.checkpoint import save_session

        self.flush()
        traj = self.trajectory
        eye = np.eye(4, dtype=np.float32)
        kf_ids = sorted(self._kf_poses)
        save_session(path, {
            "frame_id": np.asarray(self._frame_id),
            "T_wc": self._T_wc.cpu().numpy(),
            "velocity": self._velocity.cpu().numpy(),
            "traj_ts": np.asarray([s.timestamp for s in traj]),
            "traj_T": (np.stack([s.T_wc for s in traj]) if traj
                       else np.zeros((0, 4, 4), np.float32)),
            "traj_ref_kf": np.asarray([s.ref_kf_id for s in traj]),
            "traj_T_kf": (np.stack([eye if s.T_kf_frame is None else s.T_kf_frame
                                    for s in traj]) if traj
                          else np.zeros((0, 4, 4), np.float32)),
            "kf_ids": np.asarray(kf_ids),
            "kf_poses": (np.stack([self._kf_poses[k] for k in kf_ids]) if kf_ids
                         else np.zeros((0, 4, 4), np.float32)),
        })

    def resume_from(self, path: str) -> int:
        """Restore a session saved by `save_checkpoint` (of either package)
        -> the next frame index. Pyramids are not saved: the next frame is a
        first frame (synchronous, a new keyframe at the restored pose), and
        the trajectory, keyframe poses and live pose continue from the file.
        The frame graphs' static inputs, which hold the previous session's
        frames, are cleared; every replay copies its inputs in anew."""
        from .utils.checkpoint import load_session

        st = load_session(path)
        self.flush()
        self._frame_id = int(st["frame_id"])
        self._T_wc = torch.from_numpy(np.asarray(st["T_wc"], np.float32)).to(self.device)
        self._velocity = torch.from_numpy(np.asarray(st["velocity"], np.float32)).to(self.device)
        self._kf_poses = {int(k): np.asarray(T, np.float32)
                          for k, T in zip(st["kf_ids"], st["kf_poses"])}
        self.trajectory = [
            FrameState(
                frame_id=i, timestamp=float(st["traj_ts"][i]),
                T_wc=np.asarray(st["traj_T"][i], np.float32), tracked_inliers=0,
                track_error=0.0, is_keyframe=False, ref_kf_id=int(st["traj_ref_kf"][i]),
                T_kf_frame=np.asarray(st["traj_T_kf"][i], np.float32),
            )
            for i in range(len(st["traj_ts"]))
        ]
        self._prev = None          # the next frame re-bootstraps
        self._prev_feats = None
        self._pipe_broken = False
        for key, step in self._steps.items():
            if key[0] in ("plain", "boot"):
                step.clear_inputs()
        return self._frame_id

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
