"""Configuration of the SLAM system: the dataclasses of `uwslam_tpu.config`,
field for field and default for default, so a configuration means the same
in both packages. `WeightKind` is the port's (`tracking.robust`).

Reference origins of the constants (uw-slam): PYRAMID_LEVELS,
GRADIENT_THRESHOLD and BLOCK_SIZE globals (src/Options.cpp:26-28); GN eps
and iteration cap (src/Tracker.cpp:508,688); ratio 0.65
(include/Tracker.h:80); RANSAC 3.0/0.99 (src/Tracker.cpp:150); patch size 5
(include/Tracker.h:289); keypoint reuse threshold 110 (src/System.cpp:208);
depth factor 0.0002 (src/Tracker.cpp:1223); <= 200 keypoints per frame
(src/Tracker.cpp:1190).

`unported` is the error of a flag or input whose slice is not ported yet
(the CLI's session tooling).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .tracking.robust import WeightKind


def unported(what: str, roadmap: str) -> NotImplementedError:
    """The error for a switch, flag or input whose slice is not ported yet;
    `roadmap` names the ROADMAP.md slice and item that will port it."""
    return NotImplementedError(
        f"{what} is not ported to uwslam_tpu_torch yet (ROADMAP {roadmap})"
    )


@dataclass(frozen=True)
class TrackerConfig:
    pyramid_levels: int = 5              # PYRAMID_LEVELS
    track_levels: tuple[int, ...] = (3, 2, 1, 0)  # coarse-to-fine schedule
    max_iterations: int = 10             # reference GN cap per level
    step_epsilon: float = 1e-4           # reference eps=0.001 (|delta| stop)
    num_points: int = 2048               # semi-dense top-K selection capacity
    point_block: int = 8                 # spatial spread block (ref: 32x32 grid)
    point_mode: str = "semi_dense"       # "semi_dense" (ObtainCandidatePoints)
                                         # | "dense" (ObtainAllPoints)
    dense_stride: int = 2                # pixel stride in dense mode
    # Huber by default: under constant-depth model error Tukey's
    # redescending weights reject the nearest, highest-parallax points that
    # constrain translation (uw-slam ships Tukey 4.6851, src/Tracker.cpp:1626,
    # but runs identity weights, :769).
    weight_kind: WeightKind = WeightKind.HUBER
    track_mode: str = "fc"               # "fc" | "ic" (inverse compositional:
                                         # constant ref-side J, ~3x less
                                         # sampling per LM iteration)
    affine_brightness: bool = False      # DSO-style joint (a, b) estimation:
                                         # I_tgt = (1+a) I_ref + b — for
                                         # underwater lighting / exposure
    mono_depth: float = 1.0              # z=1 when no depth (Tracker.cpp:1228)
    depth_factor: float = 0.0002         # TUM 16-bit depth scaling
    min_inliers: int = 100               # tracking-failure threshold
    # Monocular depth bootstrapping (needs use_features): triangulate the
    # feature matches against the tracked pose and feed the resulting coarse
    # inverse-depth prior to point selection, replacing the constant-z
    # fallback (the thing the reference hardcodes at Tracker.cpp:1228-1232).
    depth_bootstrap: bool = False
    bootstrap_block: int = 32            # prior grid cell size (pixels)
    bootstrap_anchor_frames: int = 10    # init window: triangulate vs the
    #                                      first frame over the composed
    #                                      (wide) baseline for this many
    #                                      frames — two-view depth noise
    #                                      falls as 1/baseline
    bootstrap_edge_ratio: float = 0.0    # >0: drop selected points whose
    #                                      prior read straddles a depth edge
    #                                      (cell disagreement > this ratio).
    #                                      OFF by default: measured WORSE on
    #                                      occluding scenes — it preferentially
    #                                      culls the highest-parallax (near-
    #                                      edge) points that constrain
    #                                      translation best; the Tukey
    #                                      weights already down-weight the
    #                                      phantom-depth residuals.
    # Per-point photometric depth refinement of freshly-selected points.
    # OFF: measured 2-3%/frame monocular scale shrink — the refinement is
    # near-biased at occlusion boundaries and feeds the pose directly,
    # bypassing the prior's gauge anchor. Kept for RGBD-free experimentation.
    bootstrap_refine_points: bool = False
    # Blend each prior depth read toward the grid's median inverse depth
    # (1.0 = raw grid, the default: short well-anchored runs NEED the raw
    # structure — it beats constant-z 3.9x on the 12-frame multi-plane
    # scene). On LONG runs the grid's structured per-point error (~35%
    # gauge-removed) accumulates and destabilizes the photometric LM;
    # 0.25 measured best there (150-frame TUM stand-in sweep: 0.0479 vs
    # 0.0875 raw / 0.0535 constant ATE — see depth_prior.sample_prior and
    # eval.py config 2's --bootstrap-shrink).
    bootstrap_shrink: float = 1.0


@dataclass(frozen=True)
class FeatureConfig:
    per_level: int = 256
    detect_levels: int = 3
    max_keypoints: int = 200             # reference cap (Tracker.cpp:1190)
    patch_size: int = 5                  # reference patch_size_
    ratio: float = 0.65                  # reference ratio test
    ransac_threshold_px: float = 3.0     # reference RANSAC distance
    ransac_hypotheses: int = 256
    min_matches: int = 15
    keypoint_reuse_threshold: int = 110  # reference usekeypoints rule


@dataclass(frozen=True)
class KeyframeConfig:
    window_size: int = 10                # reference 10-frame retention
    min_inlier_ratio: float = 0.55
    max_translation: float = 0.12
    max_rotation: float = 0.10
    min_gap: int = 3
    max_gap: int = 30


@dataclass(frozen=True)
class BAConfig:
    max_iterations: int = 20
    huber_delta_px: float = 2.0
    photometric: bool = False            # direct (photometric) window BA over
                                         # keyframe pyramids instead of
                                         # feature reprojection BA — the cost
                                         # the reference's Ceres scaffolding
                                         # intended (Tracker.h:295-505)
    photometric_level: int = 1           # pyramid level for photometric BA
    photometric_huber: float = 12.0      # intensity-unit Huber delta
    # Information weight anchoring window poses to tracked odometry
    # (1/sigma^2 in (units, rad)^-2 summed-residual scale; 0 disables).
    pose_prior_weight: float = 1e5
    # Optional anchor for the end-of-run GLOBAL distributed BA toward the
    # chain it starts from. Default OFF: once the global track graph
    # contains cross-loop observations and multi-view-triangulated
    # landmarks, the unanchored solve is strictly best (240-frame revisit
    # eval: 0.161 at w=0 vs 0.175 at 1e3, 0.182 at 1e4, 0.184 at 1e5 —
    # the prior only holds the correction back). Before the cross-loop
    # pairs existed the opposite held (unanchored 0.190 vs loop-only
    # 0.183): a global BA whose problem contains no information beyond the
    # odometry+PGO chain can only re-drift it, and this weight was the
    # guard. Keep it available for maps where loop closure is off and the
    # seeded problem is weak.
    global_pose_prior_weight: float = 0.0
    landmark_capacity: int = 4096
    obs_capacity: int = 16384
    run_every_n_keyframes: int = 1
    # Retire the window solve a few frames later through the pending-
    # correction path, as loop closure does; False writes back synchronously.
    asynchronous: bool = True


@dataclass(frozen=True)
class RelocConfig:
    """Tracking-failure detection + relocalization (the reference has neither:
    a diverged GN just writes a bad pose, SURVEY.md §5)."""

    min_inliers: int = 100               # below this the frame is LOST
    min_inlier_ratio: float = 0.25       # of the point budget
    max_error: float = 1e3               # photometric error explosion guard
    pnp_threshold_px: float = 3.0
    pnp_min_inliers: int = 12
    max_candidates: int = 5              # most-recent keyframes tried


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop detection + pose-graph correction (map.loop_closure)."""

    min_gap: int = 8
    max_candidates: int = 3
    min_similarity: float = 0.70
    min_matches: int = 25
    # Wide-baseline revisit semantics (see map.loop_closure.LoopConfig for
    # the measurements): relaxed ratio + loose PnP threshold with robust
    # GN polish; the 3 px / 0.65 consecutive-frame settings verified a
    # TRUE revisit with only 3-6 inliers and closed zero loops.
    match_ratio: float = 0.80
    pnp_threshold_px: float = 8.0
    pnp_min_inliers: int = 20
    # Loose-threshold safety gates (see map.loop_closure.LoopConfig): a
    # match-inlier-ratio floor plus a reverse-PnP mutual-consistency check
    # so the relaxed 8 px gate cannot admit a geometrically-consistent
    # false loop on scenes unlike the eval sequence.
    min_inlier_ratio: float = 0.25
    check_reverse_pnp: bool = True
    reverse_max_rot: float = 0.15
    reverse_max_trans_ratio: float = 0.35
    odometry_weight: float = 100.0
    loop_weight: float = 30.0
    max_pgo_iters: int = 30
    # VLAD retrieval (map.loop_closure): vocabulary size, descriptors needed
    # before training, and the (lower) cosine gate for VLAD signatures.
    vocab_size: int = 16
    vocab_min_desc: int = 1024
    min_similarity_vlad: float = 0.25
    use_vlad: bool = True
    # Pose-graph group: Sim(3) (default — absorbs monocular scale drift at
    # closure, the capability the reference's uw::Sim3 typedef intended,
    # uw-slam include/Options.h:130) vs SE(3) (--loop-se3).
    use_sim3: bool = True


@dataclass(frozen=True)
class SlamConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    reloc: RelocConfig = field(default_factory=RelocConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    use_features: bool = False           # config-2+ feature front-end
    use_ba: bool = False                 # config-4+ windowed BA
    use_reloc: bool = True               # failure detection + relocalization
    use_loop_closure: bool = False       # loop detection + pose-graph correction
    # Retain a lightweight record (pose + keypoints + descriptors) of EVERY
    # keyframe — including ones evicted from the sliding window — so a global
    # distributed bundle adjustment over the whole map can run at the end
    # (BASELINE config 5: partitioned keyframe map + distributed BA).
    global_ba: bool = False
    profile: bool = False                # per-stage timing (utils.profiling)
    trajectory_csv: str | None = None    # reference CSV dump equivalent
