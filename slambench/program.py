"""The system under test: `uwslam_tpu_torch.SlamSystem`, built from a
configuration's CLI flags as `uwslam_tpu_torch.cli.main:main` builds it.

The flags are parsed by the program's own parser (so a flag means what it
means to a user of the CLI) and turned into a `SlamConfig` by the same
rules as `main`; the camera comes from the configuration file, in place of
a calibration file on disk.
"""
from __future__ import annotations

from dataclasses import replace


def build_system(config: dict, device):
    """-> `SlamSystem` of the configuration's `flags` and `camera` on `device`."""
    from uwslam_tpu_torch.camera import PinholeCamera
    from uwslam_tpu_torch.camera.calibration import Calibration
    from uwslam_tpu_torch.cli.main import build_parser
    from uwslam_tpu_torch.config import (
        FeatureConfig,
        KeyframeConfig,
        SlamConfig,
        TrackerConfig,
    )
    from uwslam_tpu_torch.system import SlamSystem
    from uwslam_tpu_torch.tracking.robust import WeightKind

    args = build_parser().parse_args(["-d", "-", "-c", "-", *config["flags"]])
    if args.no_pipeline or args.profile or args.offline:
        raise ValueError("the replay drives the pipelined live loop: a configuration "
                         "may not pass --no-pipeline, --profile or --offline")
    track_levels = (
        tuple(int(s) for s in args.track_levels.split(","))
        if args.track_levels else tuple(range(args.levels - 2, -1, -1))
    )
    cfg = SlamConfig(
        tracker=TrackerConfig(
            pyramid_levels=args.levels, track_levels=track_levels,
            max_iterations=args.gn_iters, weight_kind=WeightKind(args.weights),
            mono_depth=args.mono_depth, num_points=args.num_points,
            track_mode=args.track_mode, affine_brightness=args.affine,
            depth_bootstrap=args.depth_bootstrap,
            **{
                name: getattr(args, name)
                for name in ("bootstrap_edge_ratio", "bootstrap_block", "bootstrap_shrink")
                if getattr(args, name) is not None
            },
        ),
        features=FeatureConfig(per_level=args.kp_per_level),
        keyframes=KeyframeConfig(min_gap=args.kf_min_gap, max_gap=args.kf_max_gap),
        use_features=args.features or args.depth_bootstrap or args.dist_ba,
        use_ba=args.ba or args.photo_ba,
        use_loop_closure=args.loop_closure,
        global_ba=args.dist_ba,
    )
    if args.photo_ba:
        cfg = replace(cfg, ba=replace(cfg.ba, photometric=True))
    if args.ba_prior_weight is not None:
        cfg = replace(cfg, ba=replace(cfg.ba, pose_prior_weight=args.ba_prior_weight))
    if args.loop_se3:
        cfg = replace(cfg, loop=replace(cfg.loop, use_sim3=False))
    if args.reference_mode:
        cfg = replace(
            cfg,
            tracker=replace(cfg.tracker, track_levels=(0,), max_iterations=10,
                            weight_kind=WeightKind.NONE, affine_brightness=False,
                            depth_bootstrap=False),
            use_features=True, use_ba=False, use_reloc=False,
        )
    cam = config["camera"]
    calib = Calibration(
        raw=PinholeCamera(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                          width=cam["width"], height=cam["height"]),
        out_width=cam["width"], out_height=cam["height"],
    )
    return SlamSystem(calib, cfg, device=device)
