"""Command line of the port: `python -m uwslam_tpu_torch.cli.main`.

The flags of `uwslam_tpu.cli.main` (uw-slam's -d/-s/-c/--TUM/--EUROC plus the
JAX package's own), on one torch device: `--platform cuda` (the default)
or `cpu`. Without a card the default exits non-zero; it never continues on
the CPU.

The live loop is pipelined by default (`SlamSystem.process_frame_async`:
one CUDA graph replay per frame, frames uploaded one ahead by
`DeviceFramePrefetcher`, diagnostics read back in batches a few frames
late); `--no-pipeline` or `--profile` gives the synchronous
`process_frame`, and frames with a depth image (`-p`) always take it.
`--offline` tracks the dataset in chunks with the batched tracker
(`track_sequence_batched`, FC or IC, with depth frames under `-p`).
`--features` turns the feature front end on (patch points around matched
keypoints; synchronous by the JAX package's own rule), `--depth-bootstrap`
the depth prior (pipelined once the prior is installed), `--ba` reprojection
window bundle adjustment, `--photo-ba` photometric window bundle adjustment
(a synchronous solve at the keyframes it is due on), `--reference-mode`
uw-slam's active pipeline, `--loop-closure` loop detection with a Sim(3)
pose-graph correction (SE(3) with `--loop-se3`), `--dist-ba` the global
landmark-sharded bundle adjustment of the whole keyframe map after the
last frame, in `--host-devices` shards (the JAX package's device count;
default 1). The stderr lines of loop closure and of the global BA have the
JAX package's format, so `eval.py`'s patterns read them. Session tooling:
`--viz-port` serves the live trajectory over HTTP (0: an ephemeral port,
printed), `--map-out` writes the keyframe map as PLY, `--checkpoint` saves
the session after the last frame, `--resume` continues a saved one (at its
next dataset index unless `-s` is given), `--trace DIR` writes a
`torch.profiler` Chrome trace of the run into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="uwslam-tpu-torch",
        description="Monocular direct SLAM (uw-slam capability surface), "
                    "PyTorch and CUDA",
    )
    p.add_argument("-d", "--directory", required=True, help="directory of input images")
    p.add_argument("-s", "--start", type=int, default=0, help="start index in the dataset")
    p.add_argument("-c", "--calibration", required=True,
                   help="calibration XML (OpenCV FileStorage) or JSON")
    p.add_argument("-p", "--depth", default=None, help="TUM depth image directory")
    p.add_argument("--tum-gt", "--TUM", default=None,
                   help="TUM ground-truth file for ATE evaluation")
    p.add_argument("--euroc-gt", "--EUROC", default=None,
                   help="EUROC ground-truth CSV for ATE evaluation")
    p.add_argument("--trajectory-out", default=None,
                   help="write the estimated trajectory (TUM format)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--levels", type=int, default=5, help="pyramid levels")
    p.add_argument("--euroc", action="store_true",
                   help="treat -d as an EUROC mav0 dir (cam0/data/*.png)")
    p.add_argument("--features", action="store_true",
                   help="feature front end: detection and patch points around "
                        "matched keypoints (README config 2)")
    p.add_argument("--ba", action="store_true",
                   help="sliding-window bundle adjustment (README config 4)")
    p.add_argument("--ba-prior-weight", type=float, default=None,
                   help="window-BA pose-prior information weight anchoring the "
                        "window's poses to the tracked odometry (default "
                        "BAConfig.pose_prior_weight)")
    p.add_argument("--photo-ba", action="store_true", help="photometric window BA")
    p.add_argument("--loop-closure", action="store_true",
                   help="loop detection + pose-graph correction")
    p.add_argument("--dist-ba", action="store_true",
                   help="end-of-run global distributed bundle adjustment over the "
                        "whole keyframe map (implies --features)")
    p.add_argument("--mono-depth", type=float, default=1.0,
                   help="assumed scene depth for pure-mono tracking")
    p.add_argument("--reference-mode", action="store_true",
                   help="uw-slam's active pipeline: identity weights, <= 200 "
                        "matched keypoints x patch points, level-0 GN only, 10 "
                        "iterations, constant depth, no BA, bootstrap or "
                        "failure detection")
    p.add_argument("--loop-se3", action="store_true",
                   help="with --loop-closure: SE(3) pose graph instead of Sim(3)")
    p.add_argument("--depth-bootstrap", action="store_true",
                   help="monocular depth bootstrapping: triangulate the feature "
                        "matches against the tracked pose and select points at "
                        "the depths of the resulting prior (implies --features)")
    p.add_argument("--num-points", type=int, default=2048,
                   help="tracked point budget per frame")
    p.add_argument("--bootstrap-edge-ratio", type=float, default=None,
                   help="with --depth-bootstrap: drop points whose prior read "
                        "straddles a depth edge (cells differ by more than this "
                        "ratio); 0 disables")
    p.add_argument("--bootstrap-block", type=int, default=None,
                   help="with --depth-bootstrap: cell size of the prior grid (px)")
    p.add_argument("--bootstrap-shrink", type=float, default=None,
                   help="with --depth-bootstrap: blend prior reads toward the "
                        "grid's median (1.0 = the raw grid)")
    p.add_argument("--kf-min-gap", type=int, default=3,
                   help="minimum frames between keyframes")
    p.add_argument("--kf-max-gap", type=int, default=30,
                   help="maximum frames between keyframes")
    p.add_argument("--kp-per-level", type=int, default=256,
                   help="feature keypoint capacity per pyramid level")
    p.add_argument("--viz-port", type=int, default=None, help="live trajectory view port")
    p.add_argument("--map-out", default=None, help="write the keyframe map as PLY")
    p.add_argument("--checkpoint", default=None, help="save the session state here")
    p.add_argument("--resume", default=None, help="resume a saved session")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage timing breakdown")
    p.add_argument("--trace", default=None, metavar="DIR", help="capture a device trace")
    p.add_argument("--weights", choices=("tukey", "huber", "none"), default="huber",
                   help="robust IRLS kernel for photometric tracking")
    p.add_argument("--track-levels", default=None,
                   help="comma-separated coarse-to-fine level schedule, e.g. "
                        "'2,1,0' (default: levels-2 .. 0)")
    p.add_argument("--gn-iters", type=int, default=10,
                   help="max LM iterations per pyramid level")
    p.add_argument("--track-mode", choices=("fc", "ic"), default="fc",
                   help="forward- or inverse-compositional LM")
    p.add_argument("--affine", action="store_true",
                   help="jointly estimate affine brightness (a, b) per frame pair")
    p.add_argument("--no-pipeline", action="store_true",
                   help="process every frame synchronously (the live loop is "
                        "pipelined by default)")
    p.add_argument("--offline", action="store_true",
                   help="batch the dataset through the pair-parallel tracker "
                        "(odometry only: no keyframes or relocalization)")
    p.add_argument("--chunk", type=int, default=64,
                   help="frames per device batch in --offline mode")
    p.add_argument("--platform", default="cuda", choices=("cpu", "cuda"),
                   help="torch device to run on (default cuda; no fallback)")
    p.add_argument("--host-devices", type=int, default=None,
                   help="landmark shards of the global BA in this process (the "
                        "JAX package's virtual host devices; default 1)")
    return p


def _report_ate(ts, poses, args) -> None:
    from ..io import associate, ate_rmse, read_groundtruth_euroc, read_groundtruth_tum

    gt_rows = None
    if args.tum_gt:
        gt_rows = read_groundtruth_tum(args.tum_gt)
    elif args.euroc_gt:
        gt_rows = read_groundtruth_euroc(args.euroc_gt)
    if gt_rows is None or not len(gt_rows):
        return
    ia, ib = associate(ts, gt_rows[:, 0], max_dt=0.05)
    if len(ia) >= 3:
        rmse = ate_rmse(poses[ia][:, :3, 3], gt_rows[ib][:, 1:4])
        print(f"ATE RMSE (Sim3-aligned): {rmse:.4f} m over {len(ia)} poses")
    else:
        print("WARNING: too few associated gt poses for ATE", file=sys.stderr)


def report_global_ba(stats: dict | None) -> None:
    """The global BA's stderr line, in the JAX CLI's format (its "devices"
    are the port's landmark shards)."""
    if stats is None:
        print("dist BA: map too small, skipped", file=sys.stderr)
        return
    print(f"dist BA: {stats['keyframes']} kfs, {stats['landmarks']} landmarks, "
          f"{stats['observations']} obs over {stats['shards']} devices: "
          f"{stats['iterations']} iters in {stats['seconds']:.3f}s "
          f"({stats['ba_iters_per_sec']:.1f} iters/s), cost "
          f"{stats['initial_cost']:.3f} -> {stats['final_cost']:.3f}"
          + ("" if stats["applied"] else " (not applied)"), file=sys.stderr)


def run_offline(args, system, config, seq) -> int:
    """Offline odometry: chunks of `--chunk` frames, overlapping by one so
    the relative poses chain across chunk boundaries, each tracked as one
    batch of pairs from the identity."""
    import numpy as np
    import torch

    from ..io import FramePrefetcher, write_trajectory_tum
    from ..tracking import compose_trajectory, track_sequence_batched

    tcfg = config.tracker
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    if n < 2:
        print("offline mode needs >= 2 frames", file=sys.stderr)
        return 1
    chunk = max(2, args.chunk)

    def track_chunk(imgs, depths):
        # Depth is used only where every frame of the chunk has it.
        use_depth = all(d is not None for d in depths)
        T_rel, _, _ = track_sequence_batched(
            torch.stack(imgs), system.cam,
            depth_frames=torch.stack(depths) if use_depth else None,
            mono_z=tcfg.mono_depth, levels=tcfg.pyramid_levels,
            track_levels=tcfg.track_levels, num_points=tcfg.num_points,
            max_iters=tcfg.max_iterations, mode=tcfg.track_mode,
            affine=tcfg.affine_brightness,
        )
        return T_rel

    T_rel_all, imgs, depths = [], [], []
    missing_depth = 0
    t0 = time.perf_counter()
    prefetcher = FramePrefetcher(seq)
    try:
        for i, (img, depth) in prefetcher:
            if i >= n:
                break
            if args.depth and depth is None:
                missing_depth += 1
            imgs.append(system._ingest(img))
            depths.append(None if depth is None else system._ingest_depth(depth))
            if len(imgs) == chunk:
                T_rel_all.append(track_chunk(imgs, depths))
                # one-frame overlap chains the chunks
                imgs, depths = imgs[-1:], depths[-1:]
    finally:
        prefetcher.close()
    if len(imgs) >= 2:
        T_rel_all.append(track_chunk(imgs, depths))
    if missing_depth:
        print(f"WARNING: {missing_depth} frames lack depth; chunks containing "
              f"them fall back to mono_z={tcfg.mono_depth}", file=sys.stderr)
    poses = compose_trajectory(torch.cat(T_rel_all).cpu()).numpy()
    n = len(poses)
    dt = time.perf_counter() - t0
    print(f"tracked {n} frames in {dt:.2f}s ({n / dt:.1f} fps, offline)", file=sys.stderr)
    ts = (
        np.asarray(seq.timestamps[:n]) if seq.timestamps is not None
        else np.arange(n, dtype=np.float64)
    )
    if args.trajectory_out:
        write_trajectory_tum(args.trajectory_out, ts, poses)
    _report_ate(ts, poses, args)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        print("error: --platform cuda (the default) needs a CUDA card and none is "
              "visible; pass --platform cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")

    from dataclasses import replace

    from .. import camera
    from ..config import FeatureConfig, KeyframeConfig, SlamConfig, TrackerConfig
    from ..io import open_directory, open_euroc, open_tum
    from ..system import SlamSystem
    from ..tracking.robust import WeightKind

    calib = camera.load(args.calibration)
    track_levels = (
        tuple(int(s) for s in args.track_levels.split(","))
        if args.track_levels else tuple(range(args.levels - 2, -1, -1))
    )
    config = SlamConfig(
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
        profile=args.profile,
        trajectory_csv=args.trajectory_out,
    )
    if args.photo_ba:
        config = replace(config, ba=replace(config.ba, photometric=True))
    if args.ba_prior_weight is not None:
        config = replace(config, ba=replace(config.ba, pose_prior_weight=args.ba_prior_weight))
    if args.loop_se3:
        config = replace(config, loop=replace(config.loop, use_sim3=False))
    if args.reference_mode:
        # uw-slam's active pipeline (src/System.cpp:193-223, src/Tracker.cpp:
        # 632-872): features -> <= 200 matched keypoints -> patch points, 10
        # GN iterations at level 0 only, identity weights (its Tukey is off,
        # src/Tracker.cpp:769), constant depth, no BA, no failure detection.
        config = replace(
            config,
            tracker=replace(
                config.tracker, track_levels=(0,), max_iterations=10,
                weight_kind=WeightKind.NONE, affine_brightness=False, depth_bootstrap=False,
            ),
            use_features=True, use_ba=False, use_reloc=False,
        )
    system = SlamSystem(calib, config, device=device)
    if args.resume:
        start_at = system.resume_from(args.resume)
        print(f"resumed at frame {start_at}", file=sys.stderr)
        if args.start == 0:
            args.start = start_at   # continue at the next dataset index
    if args.euroc:
        seq = open_euroc(args.directory, start=args.start)
    elif args.depth:
        seq = open_tum(args.directory, args.depth, start=args.start)
    else:
        seq = open_directory(args.directory, start=args.start)

    if args.offline:
        with _traced(args.trace):
            return run_offline(args, system, config, seq)

    viz = None
    if args.viz_port is not None:
        from ..viz import VizServer

        viz = VizServer(port=args.viz_port)
        print(f"live view: http://127.0.0.1:{viz.port}", file=sys.stderr)
    try:
        run_live(args, system, seq, viz)
    finally:
        if viz is not None:
            viz.close()
    if args.map_out:
        n_pts = system.export_map_ply(args.map_out)
        print(f"map: {n_pts} points -> {args.map_out}", file=sys.stderr)
    if args.checkpoint:
        system.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    ts, poses = system.export_trajectory(args.trajectory_out)
    _report_ate(ts, poses, args)
    return 0


def _traced(logdir):
    """`utils.profiling.trace(logdir)`, or nothing without a directory."""
    if logdir is None:
        return contextlib.nullcontext()
    from ..utils.profiling import trace

    return trace(logdir)


def run_live(args, system, seq, viz=None) -> None:
    """The live loop over `seq` (pipelined unless `--no-pipeline` or
    `--profile`), under `--trace`, then the run's stderr report; every
    fifth frame the estimated positions (and the ground truth's, when
    given) go to `viz`."""
    import numpy as np

    from ..io import (
        DeviceFramePrefetcher,
        FramePrefetcher,
        read_groundtruth_euroc,
        read_groundtruth_tum,
    )

    gt_rows = None
    if viz is not None and args.tum_gt:
        gt_rows = read_groundtruth_tum(args.tum_gt)
    elif viz is not None and args.euroc_gt:
        gt_rows = read_groundtruth_euroc(args.euroc_gt)

    # Pipelined by default; --no-pipeline and --profile (stage timers need
    # fenced stages) take the synchronous loop.
    pipelined = not (args.no_pipeline or args.profile)
    print("live loop: " + ("pipelined process_frame_async" if pipelined
                           else "synchronous process_frame"), file=sys.stderr)
    step = system.process_frame_async if pipelined else system.process_frame
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    # Steady state excludes the first frames (kernel build, graph capture,
    # allocator warm-up).
    warmup = min(15, max(0, n - 10))
    t0 = time.perf_counter()
    t_warm = None
    prefetcher = (DeviceFramePrefetcher(seq, system.device) if pipelined
                  else FramePrefetcher(seq))
    try:
        with _traced(args.trace):
            for i, (img, depth) in prefetcher:
                if i >= n:
                    break
                if i == warmup:
                    t_warm = time.perf_counter()
                state = step(
                    img, depth,
                    timestamp=seq.timestamps[i] if seq.timestamps is not None else None,
                )
                if i % 50 == 0 and state is not None:
                    print(f"frame {i}: inliers={state.tracked_inliers} "
                          f"err={state.track_error:.3f} kf={state.is_keyframe}",
                          file=sys.stderr)
                if viz is not None and i % 5 == 0 and i > 0 and system.trajectory:
                    est = np.stack([s.T_wc[:3, 3] for s in system.trajectory])
                    gt = (gt_rows[: len(est), 1:4]
                          if gt_rows is not None and len(gt_rows) else None)
                    viz.update(est, gt)
            if pipelined:
                system.flush()   # retire the frames still in flight
    finally:
        prefetcher.close()
    dt = time.perf_counter() - t0
    print(f"tracked {n} frames in {dt:.2f}s ({n / dt:.1f} fps)", file=sys.stderr)
    if t_warm is not None and n - warmup >= 5:
        dtw = time.perf_counter() - t_warm
        nw = n - warmup
        print(f"steady state: {nw} frames in {dtw:.2f}s ({nw / dtw:.1f} fps warm, "
              f"first {warmup} frames excluded)", file=sys.stderr)
    if system.ba_stats["runs"]:
        bs = system.ba_stats
        print(f"window BA: {bs['iters']} LM iters over {bs['runs']} runs, "
              f"{bs['time']:.2f}s of host time", file=sys.stderr)
    if args.loop_closure and system._loops is not None:
        print(f"loop closure: {len(system._loops.loop_edges)} edges accepted", file=sys.stderr)
    if args.dist_ba:
        report_global_ba(system.run_global_distributed_ba(shards=args.host_devices or 1))
    if args.profile:
        print(system.timers.report(), file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
