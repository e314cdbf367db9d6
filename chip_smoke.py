"""Smoke test of the PyTorch/CUDA port (uwslam_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python chip_smoke.py`. It needs no network and no arguments, and
exits non-zero, printing no result, when no card is visible or any phase
fails. Phases, one line each:

1. The card's name and power limit (nvidia-smi).
2. Build the kernels from uwslam_tpu_torch/csrc with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path: the pyramid kernel (K1 redesigned: one launch builds
   every level's 2x2 mean and Scharr gx, gy, |g|) on 96 x 480 x 640 at 5
   levels, field by field and level by level, and K1 alone (the same kernel
   at one level) on each of those levels; K2
   warp+sample with 95 pairs, 2048 points at every track level (1 channel
   planar, and 3 channels as texels), including points behind the camera
   and on the exact right and bottom edges; K3 sample with 95 pairs, 3
   channels (planar and texels), 2048 points at levels 3, 2, 1, its interior
   also against `grid_sample`; the fused LM evaluation `lm_evaluate` (IC,
   Huber and none, the pose alone and with an affine brightness (a, b) from
   a seed) at every track level on the same points: valid counts
   equal, every sum within LM_SUM_RTOL of the pair's scale, H symmetric,
   the padding zero, two launches bit-equal. The pyramid kernel, K1, K2 and K3 must equal their plain
   versions bit for bit.
4. The main path: the repo's bench.py sequence (96 frames of 640 x 480)
   rendered on the card and tracked by SequenceTracker in IC mode. Every
   kernel of the path must have launched (the pyramid once); the
   trajectory's ATE must be within 1 mm; the
   same frames tracked on the CPU must give the same relative poses.
5. Timing after warm-up: frames/s of the median of 10 chunks (CUDA
   events), the device's busy time and launches in one profiled chunk, and
   each kernel against its plain version, in device time (profiler; CUDA
   events where a profile, taken up to three times, records no kernel) and
   in wall time per call (CUDA events); `lm_evaluate` also with affine
   brightness.
3b. The live path's kernel shapes at B = 1: the pyramid kernel on one
   frame at 3 levels (480 x 640, 240 x 320, 120 x 160) and K1 alone on each
   level, K2 with C = 1 and with C = 3 texels
   (intensity and both gradients) and `lm_evaluate` (FC, on the texels; the
   pose alone and with affine brightness) at
   levels 1 and 0, and K3 with C = 1 at the descriptor shape (768 keypoints
   x 64 taps per level), each against its plain version as in phase 3.
3c. eval.py's rectified EUROC shape (1 x 480 x 736): the pyramid kernel at 5
   levels against the plain pyramid, and `lm_evaluate` (FC, one pair, 2048
   texels, the pose alone and with affine brightness: configs 2 and 3)
   against its plain version as in phase 3; both timed beside their bounds.
6. The live path (configuration 1): the same 96 frames through
   `SlamSystem.process_frame` (FC, 3 levels, track levels (1, 0), 10 LM
   iterations, 2048 points, keyframes, relocalization on). Every frame must
   be ok, ATE <= 2 mm, every kernel launched; the port's CPU run of the
   first 50 frames must give the same poses (1e-3 on se3.log) and the same
   keyframes. From here to phase 19 the CPU comparison runs (phases 6-7,
   10, 11b, 11c, 15, 17, 19) go on in a process of their own beside the
   card's work (`ProcessRuns`).
7. Relocalization: the same run with frame 50 replaced by uniform noise
   (numpy seed 0): frame 50 lost, frame 51 relocalized, ATE <= 4 mm over
   the other 95 frames. The port's CPU run of these 96 frames (whose first
   50 serve phase 6) must give the same statuses, keyframes and poses,
   the relocalized one included (1e-3 on se3.log): CPU and card draw the
   same RANSAC samples.
8. The CLI: the first 32 frames as 8-bit PGM files with TUM timestamps,
   ground truth and a calibration XML in a temporary directory, through
   `uwslam_tpu_torch.cli.main.main` live and with `--offline`; both must
   exit 0 and print an ATE <= 2 cm (8-bit quantization alone moves the JAX
   package's CPU run of these 32 frames from 0.28 mm to 11.2 mm).
9. Live timing: frames/s and per-frame latency (median, p90; CUDA events
   in phase 6's run) after 15 warm-up frames, and device busy ms, idle
   share, kernel launches and the costliest operators per frame from the
   profiler over 5 frames.

10. Depth images: K3 with C = 1 on a TUM-encoded depth image (uint16, 5000
   per metre, with holes, a depth step and last-column points) against its
   plain version, bit for bit, at the live shape (1 x 480 x 640, 8,192
   corner reads) and the offline shape (96 frames), timed beside its bound
   and `grid_sample`; `_depth_at` on the card against the CPU; every kernel
   against its plain version at `track_sequence`'s shapes (B = 1, 5 levels,
   FC, track levels 3-0: the pyramid kernel down to 30 x 40, K3, K2 and `lm_evaluate` for
   one pair at every track level), as in phase 3b; the offline IC chunk and `track_sequence` (FC, sequential, 96 frames) with the
   plane's depth frames (ATE <= 1 mm; the CPU's run of the first frames
   within 1e-3 on se3.log); the live path with depth images
   (`process_frame(depth=)`, all ok, ATE <= 2 mm; in a process of its own
   beside the offline runs). The monocular depth is
   set wrong (1 where the plane is at 2), so only the depth images can give
   these trajectories.
11. The pipelined live loop: (a) the CUDA graph's replay against the eager
   megastep on the same inputs, every output bit-equal; (b) the 96 frames
   through `process_frame_async` + `flush`: frame ids in order, statuses
   and keyframes equal to the CPU's pipelined run, poses within 1e-3, ATE
   <= 2 mm and within 5 mm of the synchronous run's, at least 90 frames
   through the graph, every kernel launched; (c) the relocalization
   sequence pipelined: the failure is found at retirement, the frames in
   flight are drained as lost, the loop re-enters the graph; statuses,
   keyframes and poses equal to the CPU's pipelined run of the same frames
   (1e-3), ATE <= 2 mm on each side of the drained frames; (d) frames/s,
   per-frame time (median, p90; CUDA events), and from one profiled window
   with event marks around it the device busy time, graph and kernel
   launches per frame and idle share, beside phase 9's synchronous loop;
   each kernel's launches in that window counted by its name in the
   profile must equal what the wrappers counted (a replay runs no Python,
   so the wrappers' counts on this path are added per replay); a window
   whose trace comes back short of records is profiled again, up to three
   windows.
12. Rectification: 32 frames rendered with radtan distortion; every kernel
   against its plain version at the cropped region of interest's shapes
   (1 x 464 x 624 and its two halvings, no multiples of a 32 x 8 block), as
   in phase 3b; the frames through the pipelined loop (region of interest and camera equal to the CPU run's,
   ATE <= 2 cm, card vs CPU 1e-3) and, as 8-bit files in the EUROC layout,
   through the CLI with `--euroc`.
13. Bundle adjustment at the bench's window shape (10 keyframes x 1024
   landmarks x 10,240 observations, `max_iters=25`, problem from a numpy
   seed): final cost below the initial one and within 1% of the port's CPU
   run, refined poses card vs CPU within 1e-3 on se3.log, two card runs
   bit-equal, pose error against the true poses smaller than at the start;
   the solve as a captured graph (what the live loop dispatches) bit-equal
   to the eager one; iterations, ms per solve and iterations/s of both, and
   from the profiler the kernels and device time of one solve.
14. K3 at the depth-refinement shape (C = 3 texels of one 480 x 640 frame,
   2048 points, last-row and last-column points among them) against its
   plain version, limit 0, timed beside its bound and `grid_sample`; and
   `refine_inverse_depth` on the card against the CPU (5 launches).
15. Config 2, synchronous: 48 frames of the multi-plane scene with
   `use_features` and `depth_bootstrap`, and with the bootstrap off: every
   frame ok, the prior installed within the first frames, bootstrap ATE
   below the constant-depth ATE, two card runs bit-equal over the first 24
   frames. Against the
   port's CPU run of those 24 frames, which takes the same forms of
   every operation: equal statuses, both ATEs under the bar and close,
   poses within
   CONFIG2_POSE_ATOL (this path amplifies last-bit differences, which a
   card run on those frames plus 1e-4 gray levels of noise measures:
   the 1e-3 of the other paths does not hold here, see the constant).
   Also uw-slam's active pipeline
   (`--reference-mode`: patch points, level 0, identity weights) on 48 plane
   frames under a bar from the JAX package's CPU run of the same frames.
16. Config 2, pipelined: the bootstrap megastep's replay against its eager
   call, bit for bit (in a process of its own beside phase 15); the pipelined trajectory against the synchronous one
   (PIPE_VS_SYNC_ATE); frames through the graph, launches per replay, ms per
   frame, and device ms and kernels per frame from a profiled window.
17. Config 4: the 96 plane frames with `use_features` and `use_ba`
   (synchronous, the JAX package's rule for patch points): window solves
   retired and applied, ATE within 10% of the run without BA, card vs CPU
   1e-3 and equal solves over the first 42 frames (both run that prefix);
   and the pipelined loop (`use_ba` alone: keyframes carry features
   for relocalization) with BA on beside BA off: per-frame time (median,
   p90, max, mean), the host's time in BA and a keyframe retirement's host
   time by part, ATE under the JAX package's own for that configuration; the
   keyframes' match tables, dispatched on the solves' stream and read back
   a few frames later, bit-equal to the match computed eagerly on the same
   keyframes.
18. The CLI with `--features --depth-bootstrap`, with `--features --ba` and
   with `--photo-ba` on the 8-bit dataset of phase 8: exit 0, ATE within
   CLI_ATE_MAX (in a process of its own beside phases 15-16a; its line
   follows 16a's).
19. Photometric window BA: K3 at the solve's shape (10 observers' texels at
   level 1, 240 x 320, each sampled at the 10 x 2048 projections of a
   10-keyframe two-plane window; and C = 1 for the reference intensity)
   against its plain version, bit for bit, timed beside its bound and
   `grid_sample`; the window solve eager and as a captured graph: two
   replays bit-equal, replay equal to the eager call, K3 launched
   2 max_iters + 1 times per solve, card against the CPU within 1e-3 in the
   poses, the final cost within 1% of the CPU's cost at the card's final
   state and within 3% of the CPU's own solve (PHOTO_SOLVE_COST_RTOL says
   why), replay ms, kernels, device ms and idle share; then
   the 96 bench frames with `use_ba` + `ba.photometric` synchronous and
   pipelined: every frame ok, equal keyframes, the pipelined trajectory
   within PHOTO_PIPE_T_ATOL of the synchronous one per frame and its ATE
   within PHOTO_PIPE_ATE_GAP, ATE within PHOTO_ATE_RATIO of the JAX
   package's CPU run, the card against the CPU's synchronous run of all 96
   frames (its 5 solves) within 1e-3, and the pipelined frame times.
20. Configs 5, 6 and 7 (loop closure and the global distributed BA), their
   sequence rendered on the card by `uwslam_tpu_torch.eval`'s counterpart
   of eval.py's tum_long dataset (the four broadband planes of its `tum`
   scene, the loop path that revisits itself every `loop_period` frames,
   gain and bias drift, noise of sigma 1.5 from a generator seeded per
   frame as eval.py seeds its keys; the render the JAX figures were
   measured on, EVAL_FRAMES_DIGEST) and run through the CLI with eval.py's
   flags and health checks: (a) config 5 at eval.py's quick size (80
   frames, period 56) twice on the card with the window solves retired at
   once, bit-equal, and once on the CPU (all 80 frames) in a process of its
   own while the card runs phases 20-23 (its line follows phase 23's); each
   under eval.py's health checks and the ATE
   bar (1.25x the largest JAX CLI run of the same frames), card against CPU
   reported over the CPU's frames (CPU_RUN_THREADS's note says why it is
   not held); (b) configs 6 and 7 the same way (in a process of their own
   while this one runs (a)'s two), under their health checks,
   and config 5's ATE against config 6's (eval.py's check that the global
   BA earns its place): asserted when every JAX CLI run of the same frames
   passes it, printed beside their figures when one fails it too;
   (c) config 5 on the full-size loop path (period 160) over its first 240
   frames (PHASE20_LONG_FRAMES; `python -m uwslam_tpu_torch.eval` runs all
   640) as the CLI runs it, pipelined: at least one loop edge, a global BA on at least 100
   observations and applied, ATE within 1.25x the JAX CLI's run of the same frames,
   the pyramid kernel, `lm_evaluate` and K3 launched; frames/s, frame times, loop closure's
   host ms per keyframe, the global BA's figures; (d) the landmark-sharded
   solve with 8 shards beside `ba.schur`'s `bundle_adjust` on one problem,
   both within 5e-3 of the truth, two sharded solves bit-equal (direct and
   pcg); a Sim(3) pose graph of the full run's size eager and with its LM
   pass as a captured graph, bit-equal, and their ms per solve.
21. Sequence-sharded tracking: the 96 frames (2048 points, 5 levels, track
   levels 3-0, max_iters 10) over 8 sequence shards in one process; batched
   IC against the unsharded `track_sequence_batched` (1e-6 on se3.log,
   inliers equal, ATE within 1 mm), the sequential chunks in FC within
   1.25x the JAX package's CPU run of the same call (in a process of their
   own beside phase 24, their line after 24's); launches, ms, frames/s.
22. Observer-sharded photometric BA: phase 19's window over 1, 2 and 5
   shards, each within tests/test_photometric_ba.py's bar of one shard's
   solve, cost below 0.2 of the initial one, two 5-shard solves bit-equal,
   the 5-shard solve as a captured graph bit-equal to the eager one; K3 at
   one shard's shape against its plain version, timed beside its bound and
   `grid_sample`.
23. The session tooling through the CLI on the 96 frames as 8-bit files:
   `--checkpoint` after 48 frames and `--resume` (first 48 rows equal to the
   uninterrupted run's within 1e-5, ATE within 1.25x the JAX package's CPU
   run of the same split), `--map-out` on the card and the CPU (equal vertex
   counts), `--trace` (the trace names `lm_evaluate` and the pyramid kernel;
   kernel records and graph launches in it reported beside the wrappers'
   counts), `--viz-port 0` and a `VizServer` answering on port 0; then
   `uwslam_tpu_torch.entry.entry()` on the card against the CPU (1e-4 on
   se3.log), each kernel against its plain version and timed at its shapes
   (B = 1, 5 levels, IC), and `dryrun_multichip(8)`. The CPU's `--map-out`
   run and `entry()` go on in a process of their own.
24. eval.py's configs 0-4 and 8-10 at full size (`uwslam_tpu_torch.eval`):
   150 TUM frames of 640 x 480 and 120 frames of each EUROC scene at 752 x
   480 with the real radtan coefficients (rectified to 736 x 480), rendered
   on the card, each config through the port's CLI with eval.py's flags
   (the reference-mode configs 0, 8 and 9 each in a process of its own
   beside 1, 2, 3 and 10 in this one, then config 4 alone:
   SIDE_EVAL_CONFIGS): the render the JAX figures were measured on
   (EVAL_FRAMES_DIGEST), every frame tracked, ATE within its bar
   (EVAL_ATE_MAX: 1.25 x the largest of the JAX CLI's CPU runs of the same
   frames, printed beside it), fps, warm fps, window-BA iterations/s and
   each kernel's launches per config; eval.py's health checks that every
   JAX CLI run of those frames passes are asserted, those one fails too
   printed beside their figures; the pyramid kernel, `lm_evaluate` and K3
   launched, and `lm_evaluate` in each of the affine configs 2 and 3 (their
   K2 and `lm_evaluate` launches printed).
25. The measuring tools at their full design points, in a process of
   their own (see `phase_tools_fresh`), with reduced repetitions (1 timed
   call per budget stage, 1 profiled attribution chunk, 1 solve per shard
   count): (a)
   `uwslam_tpu_torch.offline_budget` on the bench chunk (the stages' device
   busy times, pyramid + selection + all track levels, within 3% of the
   whole chunk's; the pyramid stage one launch; the chunk's launches 11,090,
   of which a profile may lose up to 3 records; its ATE within 1 mm); (b)
   `attribute_trace` (the rows, the rows under the threshold
   and the unattributed time equal the profiler's kernel time within 1%, at
   most 2% unattributed; the pyramid kernel, K2, K3 and `lm_evaluate` by
   name under their wrappers' files with 1 / 5 / 3 / 32 launches per chunk, as the wrappers
   count them, the attribution taken again up to 3 times where a profile comes back short
   of a hand-written kernel's record); (c) `scaling` with one solve per shard count (every row 30
   iterations, finite, the final cost within 1e-3 relative across a curve's
   shard counts); (d) the chunk's host ms per launch without and with
   `ops._lib.launch_ranges()` (the profiler ranges the attribution opens
   around the hand-written kernels' launches), in turns.

Every phase line ends in its seconds, split into the card's work and the
CPU comparison runs it waited for, and the script's running total.

Then a JSON line of per-kernel results, K1 alone among them (`on_path`
false: no path launches it, each builds its pyramid in one launch):
(launches on the offline, the live,
the depth, the pipelined, the rectified, the bootstrap, the BA, the
photometric BA, the long config-5, the sequence-sharded, the entry's
and each phase-24 config's path, and K3's per photometric shard count;
time, plain version's
time, the card's bound for the same bytes and operations, and a library
call's time where one computes the same function; `lm_evaluate`'s also
with affine brightness at the offline, live and EUROC shapes, `_affine`
keys), the card's name and power limit, and, last,
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from uwslam_tpu_torch.micro import (  # the card's bound and the kernels' operation counts
    BLEND_FLOPS,
    TAPS_FLOPS,
    bound,
    bound_lm_evaluate,
    bound_sampler,
    bound_pyramid,
    bound_scharr,
    brightness,
    grid_sample_call,
    scharr_conv_call,
    warm_profile,
)
from uwslam_tpu_torch.system import BOOT_STAGES, KEYFRAME_PARTS, PIPE_DIAG, PLAIN_STAGES
from uwslam_tpu_torch.utils.profiling import device_work

K1_ATOL = 0.0        # the pyramid kernel and K1: bit-equal (rounded intrinsics in the plain
                     # version's order)
SAMPLE_ATOL = 0.0    # K2/K3, planar and texels: bit-equal, masks equal
# lm_evaluate against its plain version: both sum ~2048 f32 terms per pair,
# the kernel in a tree, the plain version as bmm does, and the kernel's
# Jacobian arithmetic is contracted to FMAs. Each sum is held to this
# fraction of the pair's scale for it (H: its largest entry; b: its
# Cauchy-Schwarz bound sqrt(2 max|H| cost); cost and sum |r|: themselves).
LM_SUM_RTOL = 2e-5
# K3's interior against grid_sample(align_corners=True), which goes through
# normalized coordinates: u is recovered to ~W eps = 4e-5 px, times a
# gradient of up to ~100 gray levels per pixel.
GRID_SAMPLE_ATOL = 2e-2
MAX_LAUNCHES_PER_CHUNK = 12295   # the unfused LM loop's count; must fall
MAX_LAUNCHES_PER_FRAME = 9403
T_REL_ATOL = 1e-3    # se3.log of the card's vs the CPU's relative poses
ATE_MAX = 1e-3       # m; the JAX package's f32 CPU run gives 0.000278 m
TIMING_REPS = 20
PROFILE_LONG_REPS = 500
CHUNK_RUNS = 10
LIVE_ATE_MAX = 2e-3      # m; the JAX package's CPU run of the live path: 0.000853 m
# m. The relocalized pose rests on ~28 descriptor matches and moves by
# millimetres with the input's last bits: the JAX package's CPU run gives
# 0.00172 m on frames rendered by JAX and 0.005815 m on the port's (at most
# 1.1e-4 gray levels apart); the port gives 0.0038849 m on frames rendered
# on the card, on the card and on its host's CPU alike, and 0.005346 m on
# frames rendered on a CPU.
RELOC_ATE_MAX = 4e-3
LIVE_T_ATOL = 1e-3       # se3.log of the card's vs the CPU's per-frame T_wc
LIVE_WARMUP = 15         # the JAX CLI's own warm-up count
LIVE_PROFILED_FRAMES = 3  # op-level tracing adds seconds to each profiled frame
NOISE_FRAME = 50         # frames before it are the same in phases 6 and 7
CLI_FRAMES = 32
CLI_ATE_MAX = 2e-2       # m; JAX CPU on the same 32 8-bit frames: 0.011238 m
DEPTH_PER_METRE = 5000.0     # TUM depth images
DEPTH_CPU_FRAMES = 32        # the CPU tracks this prefix of the depth runs
PIPE_MIN_GRAPH_FRAMES = 90   # of 96: all but the first go through the graph
PIPE_VS_SYNC_ATE = 5e-3      # m, as tests/test_pipeline.py
PIPE_PROFILED_FRAMES = 8
PROFILE_ATTEMPTS = 3
# m, over the frames that are ok. At retirement the lost frame takes the last
# retired pose and the frames in flight coast on it, so the trajectory keeps
# the camera's motion over those frames as an offset (the JAX package's
# rule); the synchronous run relocalizes one frame later (RELOC_ATE_MAX).
# Frames 51-54 are drained while the camera moves 0.044 m, and a step of that
# size after 55 of 96 frames is an aligned RMSE just above 0.02 m: phase 11c
# prints it for the card and for the port's CPU run of the same frames. The
# checks that decide are the frame-by-frame agreement with that CPU run and
# LIVE_ATE_MAX on each side of the step; this bar only bounds the step.
PIPE_RELOC_ATE_MAX = 3e-2
# The kernels of the paths, by the names the profiler reports them
# (substrings). K1 alone (`scharr`) is the pyramid kernel at one level and
# runs on no path: every path builds its pyramid in one launch.
KERNEL_SYMBOLS = {"pyramid": "pyramid_kernel", "warp_sample": "warp_sample_kernel",
                  "bilinear_sample": "bilinear_sample_kernel",
                  "lm_evaluate": "lm_evaluate_kernel"}
PATH_KERNELS = tuple(KERNEL_SYMBOLS)
RECT_FRAMES = 32
RECT_DISTORTION = dict(k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5)   # EUROC-like
RECT_ATE_MAX = 2e-2
BA_COST_RTOL = 1e-2      # final cost, card vs CPU
BA_POSE_ATOL = 1e-3      # se3.log of the refined poses, card vs CPU
SCENE_FRAMES = 48
# The CPU comparisons of phases 15 and 17 run a prefix of their sequences,
# held to the card's run of the same frames, to keep the script inside its
# time limit on a loaded host (the CPU runs took 60-75 s each there).
CONFIG2_CPU_FRAMES = 24   # of phase 15's 48
CONFIG4_CPU_FRAMES = 42   # of phase 17's 96 (keyframes 0, 30, 40: one solve)
SCENE_TWIST_AMP = (0.30, 0.10, 0.07, 0.02, 0.06, 0.03)   # x sin(2 pi i / 48)
SCENE_MONO_DEPTH = 2.5
PRIOR_INSTALLED_BY = 3   # frame by which the depth prior must exist
CONFIG2_ATE_MAX = 3e-2   # m; the port's CPU run 0.0148 m, constant depth 0.0453 m
# Config 2 fixes the monocular scale from its first pair (0.039 m apart, 1.4
# to 5 m away), where the essential matrix is determined to about 1e-3 of
# its norm, and feeds each frame's depth refinement and RANSAC winner back
# into the next frame's tracking. Card and CPU run the same forms of every
# operation and differ in the last bits alone; 1e-4 gray levels of image
# noise (4e-7 of the range) move the card's poses by 0.0027 to 0.0115 and the
# CPU's by 0.0117 to 0.0147 over the 48 frames, keyframes with them, and the
# card is 0.0120 from the CPU (H100 80GB HBM3, 700 W, and its host). So the
# bound is 2.5 times that gap, not the 1e-3 of the other paths; the ATEs must
# agree to 15%, the statuses must be equal, and the keyframes are printed.
# The card is held to the CPU over the first CONFIG2_CPU_FRAMES frames, and
# the noise run that measures the amplification is taken over those frames.
# What holds the card's path to the bit is its own second run (over those
# frames too) and phase 16.
CONFIG2_POSE_ATOL = 3e-2
CONFIG2_NOISE = 1e-4      # gray levels; the run that measures the amplification
REFERENCE_ATE_MAX = 5e-3  # m; the JAX package's CPU run of these 48 frames: 0.001757 m
BOOT_PROFILED_FRAMES = 2
# m; the JAX package's CPU runs of the 96 frames: pipelined with `use_ba`
# 0.002693 m (0.000853 m without: its window BA costs accuracy on this
# fronto-parallel plane), `use_features` + `use_ba` 0.003712 m (0.003671 m).
PIPE_BA_ATE_MAX = 3.2e-3
FEATURES_BA_ATE_MAX = 5e-3
# Photometric window BA's window (phase 19): 10 keyframes of the two-plane
# scene at the bench camera, keyframe k at k times this twist, poses 1-9
# perturbed by PHOTO_POSE_NOISE and inverse depths by PHOTO_DEPTH_NOISE
# (numpy seed 0), solved at pyramid level 1 as the live system does.
PHOTO_KEYFRAMES = 10
PHOTO_STEP = (0.02, 0.008, 0.004, 0.0015, -0.002, 0.003)
PHOTO_POSE_NOISE = 0.008
PHOTO_DEPTH_NOISE = 0.05
PHOTO_MAX_ITERS = 20     # BAConfig.max_iterations, what the live system runs
# m; scripts/jax_live_reference.py --photo-ba [--pipelined]: the JAX
# package's CPU runs of the 96 bench frames with photometric window BA,
# synchronous and pipelined (0.000853 m without BA). The port's live ATE may
# be at most PHOTO_ATE_RATIO times the one of its loop.
JAX_PHOTO_ATE = 0.00035402
JAX_PHOTO_ATE_PIPELINED = 0.00039362
PHOTO_ATE_RATIO = 1.25
# The pipelined loop solves at a keyframe's retirement, a few frames after
# the synchronous loop would, and its correction reaches the chain through
# the pending correction: over the 96 frames the port's CPU runs of the two
# loops differ by 0.0016813 in se3.log per frame and by 5.4e-5 m in ATE
# (0.00034764 against 0.00040210 m). Held per frame to the bound of
# tests/test_torch_photometric_ba.py and in ATE to this difference.
PHOTO_PIPE_T_ATOL = 2e-3
PHOTO_PIPE_ATE_GAP = 1e-4
# The window's final cost is ~0.006 (interpolation noise) after 20 passes
# that are still creeping along weakly observed depths, so where an f32 run
# ends moves with its summation order: the CPU's own final cost moves by
# ~0.8% between 1, 2 and 4 threads (phase 19 prints that spread), and the card
# read 0.94% from its host's CPU (H100 80GB HBM3, 700 W). Two costs are held:
# the card's final cost against the CPU's cost function at the card's final
# state (the same point: 1%), and the CPU's own solve against the card (3%).
PHOTO_COST_RTOL = 1e-2
PHOTO_SOLVE_COST_RTOL = 3e-2


# The script's start, then each line's time; the seconds of CPU comparison
# runs since the last line.
_CLOCK = {"start": time.perf_counter(), "cpu": 0.0, "timing": 0.0}


def say(phase: str, msg: str) -> None:
    """A phase's line, ending in the seconds since the previous line (the
    phase's time), split into the card's work (everything but the CPU runs:
    renders, the host's driving of the card, checks) and the CPU comparison
    runs (`cpu_run`), and the seconds since the script started."""
    now = time.perf_counter()
    last = _CLOCK.get("last", _CLOCK["start"])
    cpu, _CLOCK["cpu"], _CLOCK["last"] = _CLOCK["cpu"], 0.0, now
    timing, _CLOCK["timing"] = _CLOCK["timing"], 0.0
    print(f"[{phase}] {msg} [{now - last:.1f} s: card work {now - last - cpu:.1f} s (of which "
          f"kernel timing {timing:.1f} s), CPU runs {cpu:.1f} s; "
          f"{now - _CLOCK['start']:.1f} s in all]", flush=True)


@contextlib.contextmanager
def cpu_run():
    """Counts the block's seconds as a CPU comparison run on the next phase
    line. The CPU runs follow the host's load; the card's work does not."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CLOCK["cpu"] += time.perf_counter() - t0


class RunRecord:
    """What the phases read of a SlamSystem's run in another process
    (`record`, a dict of the port's own types, made there): its frame
    states, exported trajectory, window solves, region of interest and
    camera (`states_vs_cpu`, `card_vs_cpu`, `live_ate`, `pose_gap` and
    `all_ok` take it as they take the system)."""

    def __init__(self, record: dict):
        self.trajectory, self._exported = record["trajectory"], record["exported"]
        self.ba_stats, self._roi, self.cam = record["ba_stats"], record["roi"], record["cam"]

    @staticmethod
    def record(system) -> dict:
        return {"trajectory": list(system.trajectory), "exported": system.export_trajectory(),
                "ba_stats": dict(system.ba_stats), "roi": system._roi, "cam": system.cam}

    def export_trajectory(self):
        return self._exported


def _job_live_noisy(inp):
    return run_live(inp["noisy"], "cpu")[1]


def _depth_trackers():
    """Phase 10's offline trackers: {name: (tracker, sequential)}."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.tracking.sequence import SequenceTracker

    return {
        "chunk_ic": (bench.make_tracker(bench.CAM), False),
        "track_sequence_fc": (SequenceTracker(
            bench.CAM, levels=bench.LEVELS, track_levels=bench.TRACK_LEVELS,
            num_points=bench.NUM_POINTS, max_iters=bench.ITERS, mode="fc"), True),
    }


def _job_depth(name):
    def job(inp):
        tracker, sequential = _depth_trackers()[name]
        n = DEPTH_CPU_FRAMES
        return tracker(inp["frames"][:n], mono_z=1.0, depth_frames=inp["depths"][:n],
                       sequential=sequential)[0]
    return job


def _job_pipelined(inp):
    return RunRecord.record(run_pipelined(inp["frames"], "cpu")[0])


def _job_pipelined_reloc(inp):
    return RunRecord.record(run_pipelined(inp["noisy"], "cpu")[0])


def _job_config2(inp):
    system = front_end_system("cpu", bootstrap=True)
    drive(system, inp["scene"][:CONFIG2_CPU_FRAMES])
    return RunRecord.record(system)


def _job_config4(inp):
    system = ba_system("cpu", features=True)
    drive(system, inp["frames"][:CONFIG4_CPU_FRAMES])
    return RunRecord.record(system)


def photo_solve(cam):
    """Phase 19's window solve at `cam`: the fields of a PhotoBAProblem ->
    the solver's outputs."""
    from uwslam_tpu_torch.ba import photometric as pba

    def solve(*fields):
        return tuple(pba.photometric_bundle_adjust(pba.PhotoBAProblem(*fields), cam,
                                                   max_iters=PHOTO_MAX_ITERS))
    return solve


def _job_photo_solve(inp):
    """Phase 19's window solved on the CPU -> (its outputs, seconds, its
    final cost at 1, 2 and 4 threads)."""
    prob, cam = inp["photo_window"]
    solve = photo_solve(cam)
    t0 = time.perf_counter()
    cpu = solve(*prob)
    cpu_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    by_threads = {}
    for n in (1, 2, 4):
        torch.set_num_threads(n)
        by_threads[n] = float(solve(*prob)[2])
    torch.set_num_threads(threads)
    return cpu, cpu_s, by_threads


def _job_photo_ba(inp):
    system = photo_system("cpu")
    drive(system, inp["frames"])
    return RunRecord.record(system)


def _job_map_out(inp):
    """Phase 23's `--map-out` run of the CLI on the CPU -> its stderr."""
    return cli_text(inp["map_out"], "--map-out on cpu")[2]


def _job_entry(inp):
    """`entry()` on the CPU -> its pose."""
    from uwslam_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    return fn(*args)


def _job_config5_quick(inp):
    """Config 5 on the CPU over the first QUICK_CPU_FRAMES frames, window
    solves retired at once as in phase 20(a)'s card runs."""
    return run_loop_config(inp["quick"], 5, "cpu", retire_at_once=True,
                           max_frames=QUICK_CPU_FRAMES)


# The CPU comparison runs: each the port's CPU run of what the card ran.
CPU_JOBS = {"live_noisy": _job_live_noisy, "depth_chunk_ic": _job_depth("chunk_ic"),
            "depth_track_sequence_fc": _job_depth("track_sequence_fc"),
            "pipelined": _job_pipelined,
            "pipelined_reloc": _job_pipelined_reloc, "config2": _job_config2,
            "config4": _job_config4, "photo_solve": _job_photo_solve,
            "photo_ba": _job_photo_ba, "config5_quick": _job_config5_quick,
            "map_out": _job_map_out, "entry": _job_entry}
# Those of phases 6-7, 10, 11b, 11c, 15, 17 and 19, in the order the phases
# read them: one process runs them from phase 6 on (phase 20's and 23's run
# in processes of their own).
WORKER_JOBS = ("live_noisy", "depth_chunk_ic", "depth_track_sequence_fc", "pipelined",
               "pipelined_reloc", "config2", "config4", "photo_solve", "photo_ba")


class ProcessRuns:
    """Runs in a process of their own (`--runs`), one after another, while
    this process goes on; each result lands in a file under `root` (a
    directory of its own) as soon as it is done. `runs` maps each run's key
    to its argument, and `kind` says what a run is:
      "cpu"     a CPU_JOBS entry on `inputs` (the CPU comparison runs);
      "system"  a SIDE_SYSTEMS entry on `inputs`, on the card;
      "eval"    phase 24's CLI arguments (`run_cli_in_process`);
      "loop"    phase 20's data arguments on the card (`run_loop_config`,
                window solves retired at once, the poses left out).
    The process takes this one's number of CPU threads unless `threads`
    says otherwise, so a CPU run is the one this process would make.
    `result(key)` waits for one run -> (its result, its seconds there);
    waiting on a "cpu" run counts as a CPU run on the phase line."""

    def __init__(self, root: Path, kind: str, runs: dict, inputs=None,
                 threads: int | None = None):
        root.mkdir(parents=True)
        self.root, self.kind = root, kind
        spec = root / "spec.pkl"
        spec.write_bytes(pickle.dumps({
            "kind": kind, "runs": runs, "inputs": inputs,
            "threads": threads or torch.get_num_threads()}))
        self.proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--runs",
                                      str(spec)])

    def result(self, key):
        out = self.root / f"{key}.pkl"
        with cpu_run() if self.kind == "cpu" else contextlib.nullcontext():
            deadline = time.perf_counter() + RUN_TIMEOUT_S
            while not out.exists():
                if self.proc.poll() is not None and not out.exists():
                    raise AssertionError(f"the {self.kind} runs' process exited "
                                         f"{self.proc.returncode} before its {key} run")
                if time.perf_counter() > deadline:
                    raise AssertionError(f"the {self.kind} run {key} took over "
                                         f"{RUN_TIMEOUT_S} s")
                time.sleep(0.05)
        done = pickle.loads(out.read_bytes())
        return done["result"], done["s"]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def runs_process(spec_path: str) -> None:
    """Body of the `--runs` process (`ProcessRuns`): every run of the spec
    in order, each result written to `<key>.pkl` beside the spec as soon as
    it is done."""
    spec = pickle.loads(Path(spec_path).read_bytes())
    torch.set_num_threads(spec["threads"])
    kind, inputs, root = spec["kind"], spec["inputs"], Path(spec_path).parent
    if kind == "cpu":
        os.nice(10)   # the CPU comparison runs yield the host to the card's processes
    table = kernels_table() if kind == "eval" else None
    for key, arg in spec["runs"].items():
        t0 = time.perf_counter()
        if kind == "cpu":
            result = CPU_JOBS[key](inputs)
        elif kind == "system":
            result = SIDE_SYSTEMS[key](inputs)
        elif kind == "eval":
            result = run_cli_in_process(arg, table, f"config {key}")
        else:
            result = strip_poses(run_loop_config(arg, key, "cuda", retire_at_once=True))
        tmp = root / f"{key}.pkl.tmp"
        tmp.write_bytes(pickle.dumps({"result": result, "s": time.perf_counter() - t0}))
        os.replace(tmp, root / f"{key}.pkl")


def kernels_table():
    from uwslam_tpu_torch import ops

    # In the order of `ops.graph.COUNTED`, which a captured step's
    # `kernel_launches` follows.
    return [
        {"name": "pyramid", "wrapper": ops.cuda_build_pyramid,
         "source": "uwslam_tpu_torch/csrc/pyramid.cu",
         "replaces": "uwslam_tpu/ops/pallas_pyramid.py:26"},
        {"name": "warp_sample", "wrapper": ops.warp_and_sample,
         "source": "uwslam_tpu_torch/csrc/warp_sample.cu",
         "replaces": "uwslam_tpu/ops/pallas_track.py:40"},
        {"name": "bilinear_sample", "wrapper": ops.cuda_bilinear_sample,
         "source": "uwslam_tpu_torch/csrc/warp_sample.cu",
         "replaces": "uwslam_tpu/ops/pallas_sample.py:29"},
        {"name": "lm_evaluate", "wrapper": ops.lm_evaluate,
         "source": "uwslam_tpu_torch/csrc/lm_evaluate.cu",
         "replaces": "uwslam_tpu/ops/pallas_track.py:40"},
        {"name": "scharr", "wrapper": ops.scharr_gradients_batched,
         "source": "uwslam_tpu_torch/csrc/pyramid.cu",
         "replaces": "uwslam_tpu/ops/pallas_pyramid.py:26"},
    ]


def check_pyramid(pyr, what: str) -> dict:
    """A path's pyramid (one launch of the pyramid kernel) against the plain
    pyramid of its level-0 images, field by field and level by level, and K1
    alone (the kernel at one level) on each of its levels against
    `scharr_plain`, all at K1_ATOL -> {"pyramid": err, "scharr": err}."""
    from uwslam_tpu_torch import ops

    err = {"pyramid": 0.0, "scharr": 0.0}
    want = ops.pyramid_plain(pyr.images[0], pyr.levels)
    for field, got_l, want_l in zip(("image", "gx", "gy", "gm"), pyr, want):
        for lvl, (g, w) in enumerate(zip(got_l, want_l)):
            if g.shape != w.shape:
                raise AssertionError(f"pyramid {what} {field} level {lvl}: shape "
                                     f"{tuple(g.shape)}, not {tuple(w.shape)}")
            e = float((g - w).abs().max())
            if not e <= K1_ATOL:
                raise AssertionError(f"pyramid {what} {field} level {lvl}: {e} > {K1_ATOL}")
            err["pyramid"] = max(err["pyramid"], e)
    for lvl, img in enumerate(pyr.images):
        for got, plain, nm in zip(ops.scharr_gradients_batched(img), ops.scharr_plain(img),
                                  ("gx", "gy", "gm")):
            e = float((got - plain).abs().max())
            if not e <= K1_ATOL:
                raise AssertionError(f"scharr {what} level {lvl} {nm}: {e} > {K1_ATOL}")
            err["scharr"] = max(err["scharr"], e)
    return err


def pyramid_calls(frames, levels: int) -> tuple[dict, dict, dict]:
    """What `time_pairs` takes for the pyramid kernel on `frames` at `levels`
    and for K1 alone on its level 0: (kernel, plain) callables, bounds, and
    the convolution yardstick of the pyramid."""
    from uwslam_tpu_torch import ops

    calls = {"pyramid": (lambda: ops.cuda_build_pyramid(frames, levels),
                         lambda: ops.pyramid_plain(frames, levels)),
             "scharr": (lambda: ops.scharr_gradients_batched(frames),
                        lambda: ops.scharr_plain(frames))}
    bounds = {"pyramid": bound_pyramid(frames, levels), "scharr": bound_scharr(frames)}
    return calls, bounds, {"pyramid": scharr_conv_call(frames)}


def exact_coordinate(f: float, c: float, target: int) -> tuple[float, float]:
    """An f32 (x, z) for which the plain projection f * x / z + c is exactly
    `target` (the last pixel of a row or column)."""
    for z in (1.0, 2.0, 3.0, 0.5, 1.5, 5.0, 7.0, 0.75):
        x = torch.tensor([(target - c) / f * z], dtype=torch.float32)
        zt = torch.tensor([z], dtype=torch.float32)
        for _ in range(64):
            u = float((f * x / zt + c)[0])
            if u == target:
                return float(x[0]), z
            x = torch.nextafter(
                x, torch.tensor([torch.inf if u < target else -torch.inf])
            )
    raise RuntimeError(f"no f32 point projects exactly onto {target}")


def edge_points(cam, n: int) -> torch.Tensor:
    """n reference points (n, 3) for an identity pose: 36 on the exact right
    and bottom edges and corner, then 4 behind or at the camera, repeated."""
    W, H = cam.width, cam.height
    xr, zr = exact_coordinate(cam.fx, cam.cx, W - 1)
    yb, zb = exact_coordinate(cam.fy, cam.cy, H - 1)
    span = torch.linspace(-0.3, 0.3, 17)
    pts = [(xr, float(s) * H / cam.fy * zr, zr) for s in span]
    pts += [(float(s) * W / cam.fx * zb, yb, zb) for s in span]
    if zr == zb:
        pts.append((xr, yb, zr))
    else:
        pts.append((xr, float(span[0]) * H / cam.fy * zr, zr))
    pts += [(xr, 0.0, zr)]
    pts += [(0.0, 0.0, -1.0), (0.0, 0.0, 5e-4), (0.0, 0.0, 0.0), (0.1, 0.1, 1e-3)]
    pts = torch.tensor(pts, dtype=torch.float32)
    return pts.repeat((n + len(pts) - 1) // len(pts), 1)[:n]


def compare(kernel_out, plain_out, atol: float, what: str) -> float:
    """Max |kernel - plain| over the value tensors; masks must be equal."""
    (kv, kmask), (pv, pmask) = kernel_out, plain_out
    if not torch.equal(kmask, pmask):
        raise AssertionError(f"{what}: validity masks differ "
                             f"({int((kmask != pmask).sum())} points)")
    err = float((kv - pv).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs error {err} > {atol}")
    return err


def lm_sums_error(got, want) -> float:
    """Largest error of a kernel's (B, 48) or, with affine brightness,
    (B, 80) sums against the plain version's, as a fraction of each pair's
    scale for that sum (see LM_SUM_RTOL). Valid counts must be equal, the
    kernel's H symmetric and its padding zero."""
    from uwslam_tpu_torch.ops.cuda_track import LM_AFFINE, LM_POSE

    lay = LM_AFFINE if got.shape[1] == LM_AFFINE.width else LM_POSE
    if not torch.equal(got[:, lay.count], want[:, lay.count]):
        raise AssertionError("lm_evaluate: valid counts differ")
    H = got[:, lay.H].view(-1, lay.n, lay.n)
    if not torch.equal(H, H.transpose(1, 2)) or bool(got[:, lay.count + 1:].any()):
        raise AssertionError("lm_evaluate: H is not symmetric or the padding not zero")
    got, want = got.double(), want.double()
    h_scale = want[:, lay.H].abs().amax(-1, keepdim=True)
    b_scale = torch.sqrt(2.0 * h_scale * want[:, lay.cost, None])
    tail = slice(lay.cost, lay.abs_r + 1)
    worst = 0.0
    for sl, scale in ((lay.H, h_scale), (lay.b, b_scale), (tail, want[:, tail].abs())):
        rel = (got[:, sl] - want[:, sl]).abs() / scale.clamp(min=1e-30)
        worst = max(worst, float(rel.max()))
    return worst


def lm_scale(target, pts_l, T, cam_l, fc: bool, ab=None):
    """The level's scale as the main path takes it: the MAD of the residuals
    at T (the affine residuals at (T, ab) where ab is given)."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.photometric import _affine_residual
    from uwslam_tpu_torch.tracking.robust import mad_sigma

    vals, ok = ops.warp_and_sample_plain(target if fc else target[:, None], pts_l.p3d, T,
                                         cam_l, texels=fc)
    valid = pts_l.valid & ok
    r = torch.where(valid, vals[:, 0] - pts_l.intensity, 0.0)
    if ab is not None:
        r = _affine_residual(r, pts_l.intensity, ab, valid)
    return mad_sigma(r, valid), ok


def check_lm_evaluate(target, pts_l, T, cam_l, what: str, J_ref=None) -> float:
    """`lm_evaluate` (Huber and none; the pose alone and with an affine
    brightness (a, b) from `brightness`) against its plain version at poses
    T: counts equal, sums within LM_SUM_RTOL, a second launch bit-equal. The
    scale is the MAD of the residuals at T, as on the main path."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.robust import WeightKind

    fc = J_ref is None
    worst = 0.0
    for ab in (None, brightness(T.shape[0], T.device)):
        sigma, _ = lm_scale(target, pts_l, T, cam_l, fc, ab)
        form = "affine" if ab is not None else "pose"
        for kind in (WeightKind.HUBER, WeightKind.NONE):
            args = (pts_l.intensity, pts_l.valid, sigma, cam_l, kind, J_ref)
            evaluator = ops.LMEvaluator(target, pts_l.p3d, *args, affine=ab is not None)
            first = evaluator(T, ab).clone()
            if not torch.equal(first, evaluator(T, ab)):
                raise AssertionError(f"{what} {form} {kind.value}: two launches differ")
            plain = ops.lm_evaluate_plain(target, pts_l.p3d, T, *args, ab=ab)
            if not int(plain[:, evaluator.layout.count].max()) > 0:
                raise AssertionError(f"{what}: no valid point")
            err = lm_sums_error(first, plain)
            if not err <= LM_SUM_RTOL:
                raise AssertionError(f"{what} {form} {kind.value}: sums differ by {err} of "
                                     f"their scale > {LM_SUM_RTOL}")
            worst = max(worst, err)
    return worst


def check_grid_sample(kernel_out, stack, uv, what: str) -> float:
    """K3 against grid_sample where the two compute the same function: at
    valid points off the last row and column."""
    vals, ok = kernel_out
    H, W = stack.shape[-2:]
    inner = (ok & (uv[..., 0] < W - 1) & (uv[..., 1] < H - 1))[:, None]
    diff = torch.where(inner, vals - grid_sample_call(stack, uv)(), 0.0)
    err = float(diff.abs().max())
    if not err <= GRID_SAMPLE_ATOL:
        raise AssertionError(f"{what}: differs from grid_sample by {err} > {GRID_SAMPLE_ATOL}")
    return err


def phase_parity(pyr, pts, cam, track_levels, seed: int = 0):
    """Kernel vs plain version on the card at the main path's shapes.
    Returns {kernel name: max abs error}."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.photometric import ic_jacobian
    from uwslam_tpu_torch.tracking.points import TrackPoints

    dev = pyr.images[0].device
    err = {"warp_sample": 0.0, "bilinear_sample": 0.0,
           "lm_evaluate": 0.0, "bilinear_sample_vs_grid_sample": 0.0,
           **check_pyramid(pyr, f"{pyr.images[0].shape[0]} frames")}

    gen = torch.Generator().manual_seed(seed)
    B = pts.p3d.shape[0] - 1
    twists = 0.02 * torch.randn(B, 6, generator=gen)
    n_edge = 64
    T = se3.exp(twists).to(dev)
    T[: B // 4] = torch.eye(4, device=dev)   # identity pairs carry edge points
    for lvl in track_levels:
        cam_l = cam.scaled(lvl)
        p3d = pts.p3d[:-1].clone()
        p3d[: B // 4, :n_edge] = edge_points(cam_l, n_edge).to(dev)
        tgt = pyr.images[lvl][1:, None]
        k = ops.warp_and_sample(tgt, p3d, T, cam_l)
        p = ops.warp_and_sample_plain(tgt, p3d, T, cam_l)
        if not bool(p[1][: B // 4, :36].all()):
            raise AssertionError("edge points must be valid in the plain version")
        err["warp_sample"] = max(
            err["warp_sample"], compare(k, p, SAMPLE_ATOL, f"warp_sample level {lvl}")
        )
        tgt_planes = (pyr.images[lvl][1:], pyr.grad_x[lvl][1:], pyr.grad_y[lvl][1:])
        k = ops.warp_and_sample(ops.pack_texels(*tgt_planes), p3d, T, cam_l, texels=True)
        p = ops.warp_and_sample_plain(torch.stack(tgt_planes, dim=1), p3d, T, cam_l)
        err["warp_sample"] = max(err["warp_sample"], compare(
            k, p, SAMPLE_ATOL, f"warp_sample texels level {lvl}"))

        # The reference pass (K3; level 0 carries its values from selection).
        uv = pts.uv[:-1] * (1.0 / (1 << lvl))
        ref_planes = (pyr.images[lvl][:-1], pyr.grad_x[lvl][:-1], pyr.grad_y[lvl][:-1])
        stack = torch.stack(ref_planes, dim=1)
        if lvl == 0:
            ref, ref_ok = (pts.intensity[:-1], pts.gx0[:-1], pts.gy0[:-1]), pts.valid[:-1]
        else:
            W, H = cam_l.width, cam_l.height
            edges = torch.tensor(
                [[W - 1, 1.5], [W - 1, H - 1], [2.25, H - 1], [0.0, 0.0],
                 [W - 1 + 1e-3, 3.0], [-1e-3, 3.0], [5.0, H - 1 + 1e-3],
                 [float("nan"), 2.0]], device=dev,
            )
            uv_edge = uv.clone()
            uv_edge[: B // 4, : len(edges)] = edges
            p = ops.bilinear_sample_plain(stack, uv_edge)
            for name, k in (
                ("planar", ops.cuda_bilinear_sample(stack, uv_edge)),
                ("texels", ops.cuda_bilinear_sample(ops.pack_texels(*ref_planes), uv_edge,
                                                    texels=True)),
            ):
                err["bilinear_sample"] = max(err["bilinear_sample"], compare(
                    k, p, SAMPLE_ATOL, f"bilinear_sample {name} level {lvl}"))
            err["bilinear_sample_vs_grid_sample"] = max(
                err["bilinear_sample_vs_grid_sample"],
                check_grid_sample(k, stack, uv_edge, f"bilinear_sample level {lvl}"))
            vals, ref_ok = ops.cuda_bilinear_sample(stack, uv)
            ref, ref_ok = (vals[:, 0], vals[:, 1], vals[:, 2]), pts.valid[:-1] & ref_ok
        pts_l = TrackPoints(uv=uv, p3d=p3d, intensity=ref[0], valid=ref_ok)
        err["lm_evaluate"] = max(err["lm_evaluate"], check_lm_evaluate(
            pyr.images[lvl][1:], pts_l, T, cam_l, f"lm_evaluate IC level {lvl}",
            J_ref=ic_jacobian(pts_l, ref[1], ref[2], cam_l)))
    return err


def phase_euroc_pyramid(dev) -> tuple[dict, dict]:
    """The kernels at the shape of eval.py's rectified EUROC frames (480 x
    736: configs 3, 4 and 8-10) on two views of the bench's plane: the
    pyramid kernel (one frame, 5 levels) against the plain pyramid, and
    `lm_evaluate` (FC, one pair, 2048 texels; the pose alone and with affine
    brightness, as configs 2 and 3 run it) against its plain version; their
    times beside their bounds."""
    from uwslam_tpu_torch import bench, ops
    from uwslam_tpu_torch.camera.model import PinholeCamera
    from uwslam_tpu_torch.image.pyramid import build_pyramid
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.micro import EUROC_F, EUROC_H, EUROC_W, N_PTS
    from uwslam_tpu_torch.tracking.points import topk_gradient_points
    from uwslam_tpu_torch.tracking.robust import WeightKind

    cam = PinholeCamera(fx=EUROC_F[0], fy=EUROC_F[1], cx=(EUROC_W - 1) / 2.0,
                        cy=(EUROC_H - 1) / 2.0, width=EUROC_W, height=EUROC_H)
    poses = bench.bench_poses(2, device=dev)
    frames = bench.bench_frames(poses, cam)
    ref, tgt = (build_pyramid(frames[i], levels=bench.LEVELS) for i in (0, 1))
    err = check_pyramid(ref, "EUROC 480x736")
    pts = topk_gradient_points(ref.images[0], ref.grad_mag[0], cam, num_points=N_PTS,
                               mono_z=bench.MONO_Z)
    T = se3.compose(poses[1:], se3.inverse(poses[:1])).contiguous()
    texels = ops.pack_texels(tgt.images[0], tgt.grad_x[0], tgt.grad_y[0])
    err["lm_evaluate"] = check_lm_evaluate(texels, pts, T, cam, "lm_evaluate FC EUROC")
    calls, bounds, library = pyramid_calls(frames[:1].contiguous(), bench.LEVELS)
    ab = brightness(1, dev)
    for name, form in (("lm_evaluate", None), ("lm_evaluate_affine", ab)):
        sigma, ok = lm_scale(texels, pts, T, cam, True, form)
        args = (pts.intensity, pts.valid, sigma, cam, WeightKind.HUBER)
        evaluator = ops.LMEvaluator(texels, pts.p3d, *args, affine=form is not None)
        calls[name] = (lambda e=evaluator, a=form: e(T, a),
                       lambda a=args, f=form: ops.lm_evaluate_plain(texels, pts.p3d, T, *a,
                                                                    ab=f))
        bounds[name] = bound_lm_evaluate(pts.valid, ok, fc=True, affine=form is not None)
    return err, time_pairs(calls, bounds, library)


def phase_main_path(tracker, frames, poses, mono_z, table):
    """Track the chunk on the card with fresh launch counts; check the
    trajectory, and the CPU's run of the same frames."""
    from uwslam_tpu_torch.bench import trajectory_ate
    from uwslam_tpu_torch.lie import se3

    for k in table:
        k["wrapper"].launches = 0
    T_rel, inliers, _ = tracker(frames, mono_z=mono_z)
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n in PATH_KERNELS if not launches[n]]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    n = frames.shape[0] - 1
    if tuple(T_rel.shape) != (n, 4, 4) or not bool(torch.isfinite(T_rel).all()):
        raise AssertionError(f"bad T_rel: shape {tuple(T_rel.shape)}")
    ate = trajectory_ate(T_rel, poses)
    if not ate <= ATE_MAX:
        raise AssertionError(f"ATE {ate} m > {ATE_MAX} m")
    with cpu_run():
        T_cpu, _, _ = tracker(frames.cpu(), mono_z=mono_z)
    ate_cpu = trajectory_ate(T_cpu, poses)
    dev_cpu = float((se3.log(T_rel.cpu()) - se3.log(T_cpu)).abs().max())
    if not dev_cpu <= T_REL_ATOL:
        raise AssertionError(f"card vs CPU se3.log differs by {dev_cpu} > {T_REL_ATOL}")
    return {
        "launches": launches, "ate": ate, "ate_cpu": ate_cpu,
        "card_vs_cpu": dev_cpu, "min_inliers": int(inliers.min()),
    }


def wall_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean ms per call of fn over `reps` back-to-back calls, CUDA events,
    after one warm-up call. A short kernel's host-side dispatch (checks,
    allocation, launch) can exceed its device time; then this is host time."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class NoDeviceTime(RuntimeError):
    """The profiler recorded no kernel in any of its attempts."""


def profiled_kernels(fn, reps: int, ops: bool = False, attempts: int = 3):
    """The profiler's per-kernel averages over `reps` calls of fn, after one
    call traced and dropped (`micro.warm_profile`); with ops=True also the host-side operators (aten::mul,
    ...) that launched device work, as a second list. A profile that
    recorded no device time (the CUDA activity trace occasionally comes back
    empty for a short window) is taken again, up to `attempts` times."""
    from torch.autograd import DeviceType

    def run():
        for _ in range(reps):
            fn()

    for _ in range(attempts):
        averages = warm_profile(run, fn).key_averages()
        kernels = device_work(averages)
        if sum(e.self_device_time_total for e in kernels) > 0:
            break
    else:
        raise NoDeviceTime(f"the profiler saw no device time in {attempts} attempts")
    if ops:
        return kernels, [e for e in averages if e.device_type == DeviceType.CPU
                         and e.self_device_time_total > 0]
    return kernels


def device_profile(fn, reps: int = TIMING_REPS) -> tuple[float, float]:
    """(device ms, kernel launches) per call of fn: the sum of the self
    device time of every kernel the profiler saw over `reps` calls."""
    kernels = profiled_kernels(fn, reps)
    total_us = sum(e.self_device_time_total for e in kernels)
    return total_us / 1e3 / reps, sum(e.count for e in kernels) / reps


def call_ms(fn) -> tuple[float, str]:
    """(ms per call, timer) of one kernel or plain call: device time from the
    profiler, over a window of TIMING_REPS calls and, where that records no
    kernel (the trace of a window of a few microseconds can come back empty),
    of PROFILE_LONG_REPS calls; CUDA events around back-to-back calls only
    where neither does (they include the host's dispatch)."""
    for reps in (TIMING_REPS, PROFILE_LONG_REPS):
        try:
            return device_profile(fn, reps)[0], "profiler"
        except NoDeviceTime:
            pass
    return wall_ms(fn), "cuda_events"


def turns(kernel, plain) -> dict:
    """Kernel vs plain ms per call in turns kernel, plain, plain, kernel."""
    (k1, t1), (p1, t2), (p2, t3), (k2, t4) = (
        call_ms(f) for f in (kernel, plain, plain, kernel))
    timers = sorted({t1, t2, t3, t4})
    return {"device_ms": (k1 + k2) / 2, "plain_device_ms": (p1 + p2) / 2,
            **({} if timers == ["profiler"] else {"timers": timers})}


def time_pairs(pairs: dict, bounds: dict, library: dict) -> dict:
    """For each kernel: device ms of kernel and plain version (`turns`), wall
    ms per call of both (CUDA events around back-to-back calls: the host's
    dispatch where that is longer), its bound, and the library call's device
    ms where there is one."""
    t0 = time.perf_counter()
    out = {}
    for name, (kernel, plain) in pairs.items():
        wk1, wp1, wp2, wk2 = (wall_ms(f) for f in (kernel, plain, plain, kernel))
        out[name] = {**turns(kernel, plain), "wall_ms": (wk1 + wk2) / 2,
                     "plain_wall_ms": (wp1 + wp2) / 2, **bounds[name],
                     "library_ms": call_ms(library[name])[0] if name in library else None}
    _CLOCK["timing"] += time.perf_counter() - t0
    return out


def phase_timing(pyr, pts, cam, T_rel, affine: bool = True):
    """Kernel vs plain version at the largest shape each has on the offline
    path (the pyramid kernel on the whole batch, K1 alone on level 0; K3
    level 1), with each kernel's bound from these inputs.
    `bilinear_sample` is the texel path the chunk runs, `bilinear_sample_planar`
    the same sample from three planes; both beside `grid_sample`.
    `lm_evaluate_affine` (with affine=True) is the same evaluation with a
    brightness (a, b)."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.photometric import ic_jacobian
    from uwslam_tpu_torch.tracking.points import TrackPoints
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    img0 = pyr.images[0]
    tgt0 = pyr.images[0][1:, None]
    ref = pts.select(slice(None, -1))
    p3d = ref.p3d
    planes1 = (pyr.images[1][:-1], pyr.grad_x[1][:-1], pyr.grad_y[1][:-1])
    stack1, texels1 = torch.stack(planes1, dim=1), ops.pack_texels(*planes1)
    uv1 = ref.uv * 0.5
    vals, ok = ops.warp_and_sample(tgt0, p3d, T_rel, cam)
    valid = ref.valid & ok
    sigma = mad_sigma(torch.where(valid, vals[:, 0] - ref.intensity, 0.0), valid)
    pts0 = TrackPoints(uv=ref.uv, p3d=p3d, intensity=ref.intensity, valid=ref.valid)
    J_ref = ic_jacobian(pts0, ref.gx0, ref.gy0, cam)
    lm_args = (ref.intensity, ref.valid, sigma, cam, WeightKind.HUBER, J_ref)
    evaluator = ops.LMEvaluator(tgt0[:, 0], p3d, *lm_args)
    ab = brightness(p3d.shape[0], tgt0.device)
    sigma_ab, _ = lm_scale(tgt0[:, 0], pts0, T_rel, cam, False, ab)
    ab_args = (ref.intensity, ref.valid, sigma_ab, cam, WeightKind.HUBER, J_ref)
    evaluator_ab = ops.LMEvaluator(tgt0[:, 0], p3d, *ab_args, affine=True)
    sampler = ops.WarpSampler(tgt0, p3d, cam)
    pyr_calls, pyr_bounds, pyr_library = pyramid_calls(img0, pyr.levels)
    pairs = {
        **pyr_calls,
        "warp_sample": (lambda: sampler(T_rel),
                        lambda: ops.warp_and_sample_plain(tgt0, p3d, T_rel, cam)),
        "bilinear_sample": (lambda: ops.cuda_bilinear_sample(texels1, uv1, texels=True),
                            lambda: ops.bilinear_sample_texels_plain(texels1, uv1)),
        "bilinear_sample_planar": (lambda: ops.cuda_bilinear_sample(stack1, uv1),
                                   lambda: ops.bilinear_sample_plain(stack1, uv1)),
        "lm_evaluate": (lambda: evaluator(T_rel),
                        lambda: ops.lm_evaluate_plain(tgt0[:, 0], p3d, T_rel, *lm_args)),
    }
    if affine:
        pairs["lm_evaluate_affine"] = (
            lambda: evaluator_ab(T_rel, ab),
            lambda: ops.lm_evaluate_plain(tgt0[:, 0], p3d, T_rel, *ab_args, ab=ab))
    ok1 = ops.cuda_bilinear_sample(stack1, uv1)[1]
    bounds = {
        **pyr_bounds,
        "warp_sample": bound_sampler(ok, 1, 12),
        "bilinear_sample": bound_sampler(ok1, 3, 8),
        "bilinear_sample_planar": bound_sampler(ok1, 3, 8),
        "lm_evaluate": bound_lm_evaluate(ref.valid, ok, fc=False),
        "lm_evaluate_affine": bound_lm_evaluate(ref.valid, ok, fc=False, affine=True),
    }
    grid = grid_sample_call(stack1, uv1)
    return time_pairs(pairs, bounds, {"bilinear_sample": grid,
                                      "bilinear_sample_planar": grid, **pyr_library})


def live_config():
    """Configuration 1 at the bench design point: FC, 3 levels, track levels
    (1, 0), 10 LM iterations, 2048 points, Huber, keyframes, relocalization."""
    from uwslam_tpu_torch.config import SlamConfig, TrackerConfig

    return SlamConfig(
        tracker=TrackerConfig(
            pyramid_levels=3, track_levels=(1, 0), max_iterations=10,
            num_points=2048, mono_depth=2.0, track_mode="fc",
        ),
        use_reloc=True,
    )


def make_system(device, raw=None, mono_depth=None):
    """Configuration 1 on `device`; `raw` another raw camera than the bench's
    (a distorted one), `mono_depth` another monocular depth."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.system import SlamSystem

    raw = bench.CAM if raw is None else raw
    config = live_config()
    if mono_depth is not None:
        config = replace(config, tracker=replace(config.tracker, mono_depth=mono_depth))
    calib = Calibration(raw=raw, out_width=raw.width, out_height=raw.height)
    return SlamSystem(calib, config, device=device)


def run_live(frames, device, n=None, events=False, depths=None, mono_depth=None):
    """Frames (N, H, W) through a fresh SlamSystem on `device` -> (system,
    states, per-frame ms from CUDA events or None)."""
    system = make_system(device, mono_depth=mono_depth)
    n = frames.shape[0] if n is None else n
    states, ms = [], []
    for i in range(n):
        if events:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        depth = None if depths is None else depths[i]
        states.append(system.process_frame(frames[i], depth=depth, timestamp=float(i)))
        if events:
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    return system, states, (ms if events else None)


def run_pipelined(frames, device, raw=None, events=False):
    """Frames through `process_frame_async` + `flush` of a fresh SlamSystem ->
    (system, ms between the ends of consecutive frames on the device or None)."""
    system = make_system(device, raw=raw)
    marks = []
    for i in range(frames.shape[0]):
        system.process_frame_async(frames[i], timestamp=float(i))
        if events:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    system.flush()
    if not events:
        return system, None
    torch.cuda.synchronize()
    return system, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def counted(table, what: str, fn):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after -> (fn's result, {kernel: launches}); every kernel must
    have launched."""
    for k in table:
        k["wrapper"].launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n in PATH_KERNELS if not launches[n]]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")
    return out, launches


def live_ate(system, poses, keep=None) -> float:
    from uwslam_tpu_torch.io.trajectory import ate_rmse
    from uwslam_tpu_torch.lie import se3

    _, est = system.export_trajectory()
    gt = se3.inverse(poses.cpu()).numpy()
    keep = slice(None) if keep is None else keep
    return ate_rmse(est[keep, :3, 3], gt[keep, :3, 3])


def phase_parity_live(ref, tgt, pts, cam, track_levels, what: str, describe: bool = True,
                       seed: int = 1):
    """Kernels at a path's B = 1 shapes against their plain versions: the
    pyramid kernel's `ref` field by field and level by level, and K1 alone on
    each of its levels; at each track level K3 (C = 1, the FC
    reference pass), K2 (C = 1 and C = 3 texels) and `lm_evaluate` (FC, the
    pose alone and with affine brightness) for
    the pair (ref, tgt) with `ref`'s points `pts`; with describe=True K3 at
    the descriptor taps of every level. `what` names the path in a failure.
    Returns ({kernel: max abs error}, what `time_pairs` takes: {kernel:
    (kernel, plain) callables at the largest shape}, their bounds and the
    library calls)."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.features import detect_multiscale
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.points import TrackPoints
    from uwslam_tpu_torch.tracking.robust import WeightKind, mad_sigma

    dev = pts.uv.device
    frame = ref.images[0]                                   # (1, H, W)
    gen = torch.Generator().manual_seed(seed)
    T_move = se3.exp(0.02 * torch.randn(1, 6, generator=gen)).to(dev)
    err = {"warp_sample": 0.0, "bilinear_sample": 0.0, "lm_evaluate": 0.0,
           **check_pyramid(ref, what)}
    calls, bounds, library = pyramid_calls(frame, ref.levels)
    for lvl in track_levels:
        cam_l = cam.scaled(lvl)
        planes = (tgt.images[lvl], tgt.grad_x[lvl], tgt.grad_y[lvl])
        stacked, texels = torch.stack(planes, dim=1), ops.pack_texels(*planes)
        plane = tgt.images[lvl][:, None]
        p3d_edge = pts.p3d.clone()
        p3d_edge[0, :64] = edge_points(cam_l, 64).to(dev)
        uv_l = pts.uv * (1.0 / (1 << lvl))
        ref_int, ref_ok = k = ops.cuda_bilinear_sample(ref.images[lvl][:, None], uv_l)
        err["bilinear_sample"] = max(err["bilinear_sample"], compare(
            k, ops.bilinear_sample_plain(ref.images[lvl][:, None], uv_l), SAMPLE_ATOL,
            f"bilinear_sample {what} C=1 reference level {lvl}"))
        for T, p3d in ((torch.eye(4, device=dev)[None], p3d_edge), (T_move, pts.p3d)):
            p = ops.warp_and_sample_plain(stacked, p3d, T, cam_l)
            k = ops.warp_and_sample(texels, p3d, T, cam_l, texels=True)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, p, SAMPLE_ATOL, f"warp_sample {what} texels level {lvl}"))
            k = ops.warp_and_sample(plane, p3d, T, cam_l)
            err["warp_sample"] = max(err["warp_sample"], compare(
                k, (p[0][:, :1], p[1]), SAMPLE_ATOL, f"warp_sample {what} C=1 level {lvl}"))
            pts_l = TrackPoints(uv=pts.uv, p3d=p3d, intensity=ref_int[:, 0],
                                valid=pts.valid & ref_ok)
            err["lm_evaluate"] = max(err["lm_evaluate"], check_lm_evaluate(
                texels, pts_l, T, cam_l, f"lm_evaluate FC {what} level {lvl}"))
        if lvl == 0:
            q = pts.p3d
            sampler = ops.WarpSampler(plane, q, cam_l)
            ok = p[1]
            sigma = mad_sigma(torch.where(pts_l.valid & ok, p[0][:, 0] - pts_l.intensity, 0.0),
                              pts_l.valid & ok)
            lm_args = (pts_l.intensity, pts_l.valid, sigma, cam_l, WeightKind.HUBER)
            evaluator = ops.LMEvaluator(texels, q, *lm_args)
            ab = brightness(1, dev)
            sigma_ab, _ = lm_scale(texels, pts_l, T_move, cam_l, True, ab)
            ab_args = (pts_l.intensity, pts_l.valid, sigma_ab, cam_l, WeightKind.HUBER)
            evaluator_ab = ops.LMEvaluator(texels, q, *ab_args, affine=True)
            calls["warp_sample"] = (
                lambda: sampler(T_move),
                lambda c=cam_l: ops.warp_and_sample_plain(plane, q, T_move, c))
            calls["warp_sample_texels"] = (
                lambda c=cam_l: ops.warp_and_sample(texels, q, T_move, c, texels=True),
                lambda c=cam_l: ops.warp_and_sample_plain(texels, q, T_move, c, texels=True))
            calls["lm_evaluate"] = (
                lambda: evaluator(T_move),
                lambda: ops.lm_evaluate_plain(texels, q, T_move, *lm_args))
            calls["lm_evaluate_affine"] = (
                lambda: evaluator_ab(T_move, ab),
                lambda: ops.lm_evaluate_plain(texels, q, T_move, *ab_args, ab=ab))
            bounds["warp_sample"] = bound_sampler(ok, 1, 12)
            bounds["warp_sample_texels"] = bound_sampler(ok, 3, 12)
            bounds["lm_evaluate"] = bound_lm_evaluate(pts_l.valid, ok, fc=True)
            bounds["lm_evaluate_affine"] = bound_lm_evaluate(pts_l.valid, ok, fc=True,
                                                             affine=True)
    if not describe:
        return err, (calls, bounds, library)
    fcfg = live_config().features
    kps = detect_multiscale([g[0] for g in ref.grad_x], [g[0] for g in ref.grad_y],
                            per_level=fcfg.per_level, levels=fcfg.detect_levels)
    half = 3.5
    offs = (torch.arange(8, dtype=torch.float32, device=dev) - half) * 2.0
    du, dv = torch.meshgrid(offs, offs, indexing="xy")
    taps = torch.stack([du.reshape(-1), dv.reshape(-1)], dim=-1)
    for lvl, img in enumerate(ref.images):
        uv = ((kps.uv / (1 << lvl))[:, None, :] + taps[None]).reshape(1, -1, 2)
        image = img[None]                                   # (1, 1, H_l, W_l)
        k = ops.cuda_bilinear_sample(image, uv)
        p = ops.bilinear_sample_plain(image, uv)
        err["bilinear_sample"] = max(err["bilinear_sample"], compare(
            k, p, SAMPLE_ATOL, f"bilinear_sample {what} C=1 describe level {lvl}"))
        if lvl == 0:
            calls["bilinear_sample"] = (
                lambda i=image, q=uv: ops.cuda_bilinear_sample(i, q),
                lambda i=image, q=uv: ops.bilinear_sample_plain(i, q),
            )
            bounds["bilinear_sample"] = bound_sampler(k[1], 1, 8)
            library["bilinear_sample"] = grid_sample_call(image, uv)
    return err, (calls, bounds, library)


def card_vs_cpu(card_states, cpu_states, what: str) -> float:
    """Statuses and keyframe flags must be equal and every T_wc within
    LIVE_T_ATOL on se3.log; returns the largest se3.log difference."""
    from uwslam_tpu_torch.lie import se3

    n = len(cpu_states)
    for key in ("status", "is_keyframe"):
        card = [getattr(s, key) for s in card_states[:n]]
        cpu = [getattr(s, key) for s in cpu_states]
        if card != cpu:
            raise AssertionError(f"{what}: {key} differs: card {card} vs CPU {cpu}")
    card = torch.from_numpy(np.stack([s.T_wc for s in card_states[:n]]))
    cpu = torch.from_numpy(np.stack([s.T_wc for s in cpu_states]))
    dev = float((se3.log(card) - se3.log(cpu)).abs().max())
    if not dev <= LIVE_T_ATOL:
        raise AssertionError(f"{what}: card vs CPU se3.log differs by {dev} > {LIVE_T_ATOL}")
    return dev


def phase_live(frames, poses, table, cpu_states):
    """Configuration 1 live on the card with fresh launch counts; the CPU's
    run of the first frames (`cpu_states()`, read once the card's run is
    done) must agree."""
    for k in table:
        k["wrapper"].launches = 0
    system, states, frame_ms = run_live(frames, frames.device, events=True)
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in table}
    missing = [n for n in PATH_KERNELS if not launches[n]]
    if missing:
        raise AssertionError(f"kernels not launched on the live path: {missing}")
    bad = [(s.frame_id, s.status) for s in states if s.status != "ok"]
    if bad:
        raise AssertionError(f"live frames not ok: {bad[:10]}")
    if not all(np.isfinite(s.T_wc).all() for s in states):
        raise AssertionError("non-finite live pose")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX:
        raise AssertionError(f"live ATE {ate} m > {LIVE_ATE_MAX} m")
    cpu_states = cpu_states()
    dev_cpu = card_vs_cpu(states, cpu_states, "live path")
    return {
        "launches": launches, "ate": ate, "card_vs_cpu": dev_cpu,
        "cpu_frames": len(cpu_states),
        "keyframes": int(sum(s.is_keyframe for s in states)),
        "min_inliers": int(min(s.tracked_inliers for s in states)),
    }, frame_ms


def with_noise_frame(frames):
    """The frames with frame NOISE_FRAME replaced by uniform noise (numpy
    seed 0)."""
    noisy = frames.clone()
    noise = np.random.default_rng(0).uniform(0, 255, tuple(frames.shape[1:]))
    noisy[NOISE_FRAME] = torch.from_numpy(noise.astype(np.float32)).to(frames.device)
    return noisy


def phase_reloc(noisy, poses, cpu_states):
    """The relocalization run on the card; the CPU's run of the same frames
    (`cpu_states`) must agree frame by frame, the relocalized pose included."""
    system, states, _ = run_live(noisy, noisy.device)
    got = (states[NOISE_FRAME].status, states[NOISE_FRAME + 1].status)
    if got != ("lost", "relocalized"):
        raise AssertionError(f"frames {NOISE_FRAME}, {NOISE_FRAME + 1}: {got}, "
                             "want ('lost', 'relocalized')")
    others = [s.status for i, s in enumerate(states)
              if i not in (NOISE_FRAME, NOISE_FRAME + 1)]
    keep = np.array([i != NOISE_FRAME for i in range(len(states))])
    ate = live_ate(system, poses, keep)
    if not ate <= RELOC_ATE_MAX:
        raise AssertionError(f"relocalization run ATE {ate} m > {RELOC_ATE_MAX} m")
    dev_cpu = card_vs_cpu(states, cpu_states, "relocalization run")
    return {"statuses": list(got), "other_not_ok": sum(s != "ok" for s in others),
            "ate": ate, "keyframes": int(sum(s.is_keyframe for s in states)),
            "card_vs_cpu": dev_cpu}


def write_dataset(frames, poses, root: Path):
    """8-bit PGM frames named by TUM timestamps, TUM ground truth (T_wc) and
    an undistorted calibration XML of the bench camera."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3

    rgb = root / "rgb"
    rgb.mkdir()
    imgs = frames.clamp(0, 255).to(torch.uint8).cpu().numpy()
    T_wc = se3.inverse(poses.cpu())
    q, t = (x.numpy() for x in se3.to_quaternion_translation(T_wc))
    lines = ["# ground truth\n# synthetic\n# timestamp tx ty tz qx qy qz qw\n"]
    for i, img in enumerate(imgs):
        ts = f"{1.0 + 0.033 * i:.6f}"
        h, w = img.shape
        (rgb / f"{ts}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        lines.append(f"{ts} {t[i, 0]} {t[i, 1]} {t[i, 2]} "
                     f"{q[i, 1]} {q[i, 2]} {q[i, 3]} {q[i, 0]}\n")
    (root / "groundtruth.txt").write_text("".join(lines))
    cam = bench.CAM
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>{cam.width}</in_width><in_height>{cam.height}</in_height>
<out_width>{cam.width}</out_width><out_height>{cam.height}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{cam.fx} {cam.fy} {cam.cx} {cam.cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>0 0 0 0</data></rectification>
</opencv_storage>
""")
    return rgb, root / "calib.xml", root / "groundtruth.txt"


def phase_cli(frames, poses):
    """The CLI live and offline on 8-bit PGM files; each must exit 0 and
    print an ATE within CLI_ATE_MAX."""
    from uwslam_tpu_torch.cli.main import main as cli_main

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rgb, calib, gt = write_dataset(frames[:CLI_FRAMES], poses[:CLI_FRAMES], Path(tmp))
        base = ["-d", str(rgb), "-c", str(calib), "--tum-gt", str(gt), "--levels", "3",
                "--track-levels", "1,0", "--mono-depth", "2.0", "--platform", "cuda"]
        for name, extra in (("live", []), ("offline", ["--offline", "--track-mode", "fc"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(base + extra + ["--trajectory-out", str(Path(tmp) / f"{name}.txt")])
            text = buf.getvalue()
            m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+-]+) m", text)
            if rc != 0 or m is None:
                raise AssertionError(f"CLI {name}: exit {rc}, output {text!r}")
            ate = float(m.group(1))
            if not ate <= CLI_ATE_MAX:
                raise AssertionError(f"CLI {name}: ATE {ate} m > {CLI_ATE_MAX} m")
            out[name] = {"ate": ate, "s": round(time.perf_counter() - t0, 2)}
    return out


def phase_live_timing(frames, calls, frame_ms):
    """Per-frame latency and frames/s of phase 6's card run after the
    warm-up frames (CUDA events around each process_frame, which ends in its
    diagnostics transfer); the profiler's device busy time, launches and
    costliest operators per frame over 5 frames of a fresh run; and each
    kernel against its plain version at the live path's largest shape
    (`time_pairs`)."""
    steady = frame_ms[LIVE_WARMUP:]
    system = make_system(frames.device)
    for i in range(LIVE_WARMUP):
        system.process_frame(frames[i], timestamp=float(i))
    reps = LIVE_PROFILED_FRAMES
    window = iter(range(LIVE_WARMUP, LIVE_WARMUP + reps + 1))
    kernels, ops = profiled_kernels(
        lambda: system.process_frame(frames[next(window)], timestamp=0.0), reps, ops=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    per_kernel = time_pairs(*calls)
    return {
        "frames_per_s": len(steady) / (sum(steady) / 1e3),
        "latency_ms_median": statistics.median(steady),
        "latency_ms_p90": float(np.percentile(steady, 90)),
        "device_busy_ms_per_frame": busy_ms,
        "idle_share": 1.0 - busy_ms / statistics.mean(steady),
        "launches_per_frame": sum(e.count for e in kernels) / reps,
        "top_ops_device_ms_and_calls_per_frame": {
            e.key: [round(e.self_device_time_total / 1e3 / reps, 4), round(e.count / reps, 1)]
            for e in top
        },
        "kernels_at_live_shapes": per_kernel,
    }


def tum_depth(cam, poses, plane_z: float = 2.0):
    """The plane's exact depth at each pose as TUM depth images: the uint16
    values (5000 per metre) as f32, which holds them exactly."""
    from uwslam_tpu_torch.utils.synthetic import plane_depth

    return torch.round(plane_depth(cam, poses, plane_z) * DEPTH_PER_METRE).clamp(0, 65535)


def corner_coordinates(depth, uv):
    """The (B, 4 N, 2) corner reads `_depth_at` hands kernel K3 for points uv
    (B, N, 2) on depth images (B, H, W)."""
    B, H, W = depth.shape
    u0 = torch.clamp(torch.floor(uv[..., 0]), 0, W - 2)
    v0 = torch.clamp(torch.floor(uv[..., 1]), 0, H - 2)
    corners = [torch.stack([u0 + du, v0 + dv], dim=-1)
               for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1))]
    return torch.stack(corners, dim=1).reshape(B, -1, 2)


def phase_depth_kernel(depths, pts):
    """K3 (C = 1) on depth images with holes, a step and last-column and
    last-row points against its plain version, bit for bit, at the live
    (B = 1) and offline (B = 96) shapes; `_depth_at` on the card against the
    CPU; times, bounds and `grid_sample` per shape."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.tracking.points import _depth_at

    awkward = depths.clone()
    H, W = awkward.shape[1:]
    awkward[:, :, W // 2:] = torch.round(awkward[:, :, W // 2:] * 1.6)   # a depth step
    awkward[:, 100:140, 80:160] = 0.0                                     # holes
    awkward[:, 300, 400] = 0.0
    uv = pts.uv.clone()
    edge = torch.tensor([[W - 1, 10.0], [W - 1, 57.25], [W - 1, H - 1], [33.5, H - 1],
                         [0.0, 0.0], [W // 2 - 0.5, 50.0], [W // 2, 50.0], [79.5, 120.0],
                         [399.5, 299.5], [W - 1 + 1e-3, 5.0], [-1e-3, 5.0]], device=uv.device)
    uv[:, : len(edge)] = edge
    errs, pairs, bounds, library = {}, {}, {}, {}
    for name, sl in (("live", slice(0, 1)), ("offline", slice(None))):
        image = awkward[sl][:, None].contiguous()
        corners = corner_coordinates(awkward[sl], uv[sl])
        k = ops.cuda_bilinear_sample(image, corners)
        errs[name] = compare(k, ops.bilinear_sample_plain(image, corners), SAMPLE_ATOL,
                             f"bilinear_sample on depth, {name} shape")
        if not bool(k[1].all()) or not bool((k[0] == 0).any()):
            raise AssertionError("corner reads must all be in bounds and meet holes")
        pairs[name] = (lambda i=image, q=corners: ops.cuda_bilinear_sample(i, q),
                       lambda i=image, q=corners: ops.bilinear_sample_plain(i, q))
        bounds[name] = bound_sampler(k[1], 1, 8)
        library[name] = grid_sample_call(image, corners)
    d, ok = _depth_at(awkward, uv, 1.0)
    d_cpu, ok_cpu = _depth_at(awkward.cpu(), uv.cpu(), 1.0)
    if not torch.equal(ok.cpu(), ok_cpu):
        raise AssertionError("_depth_at: the card's validity differs from the CPU's")
    want = [True] * 5 + [False, True, False, False, False, False]
    if ok[0, : len(edge)].tolist() != want:
        raise AssertionError(f"_depth_at at the edge points: {ok[0, :len(edge)].tolist()}")
    errs["depth_at_vs_cpu"] = float((d.cpu() - d_cpu).abs().max())
    if not errs["depth_at_vs_cpu"] <= 1e-6:
        raise AssertionError(f"_depth_at differs from the CPU by {errs['depth_at_vs_cpu']} m")
    errs["valid_share"] = float(ok.float().mean())
    return errs, time_pairs(pairs, bounds, library)


def phase_depth_paths(frames, poses, depths, table, worker):
    """The offline IC chunk, `track_sequence` (FC) and the live path with the
    plane's depth frames and a wrong monocular depth (1, the plane is at 2);
    the CPU's runs of the first frames from `worker`, the live path in a
    process of its own (`ProcessRuns`) beside the offline ones."""
    with tempfile.TemporaryDirectory() as tmp:
        side = ProcessRuns(Path(tmp) / "side", "system", {"live_rgbd": None},
                           {"frames": frames.cpu(), "depths": depths.cpu()})
        try:
            return depth_runs(frames, poses, depths, table, worker, side)
        finally:
            side.stop()


def depth_runs(frames, poses, depths, table, worker, side):
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3

    out = {}
    n_cpu = DEPTH_CPU_FRAMES
    for name, (tracker, sequential) in _depth_trackers().items():
        t0 = time.perf_counter()
        (T_rel, inliers, _), launches = counted(table, name, lambda: tracker(
            frames, mono_z=1.0, depth_frames=depths, sequential=sequential))
        card_s = time.perf_counter() - t0
        ate = bench.trajectory_ate(T_rel, poses)
        if not ate <= ATE_MAX:
            raise AssertionError(f"{name} with depth frames: ATE {ate} m > {ATE_MAX} m")
        T_cpu, _ = worker.result(f"depth_{name}")
        dev_cpu = float((se3.log(T_rel[: n_cpu - 1].cpu()) - se3.log(T_cpu)).abs().max())
        if not dev_cpu <= T_REL_ATOL:
            raise AssertionError(f"{name}: card vs CPU se3.log differs by {dev_cpu}")
        out[name] = {"ate": ate, "card_vs_cpu": dev_cpu, "cpu_frames": n_cpu,
                     "min_inliers": int(inliers.min()), "launches": launches,
                     "card_s": round(card_s, 2)}
    rgbd, card_s = side.result("live_rgbd")
    system = RunRecord(rgbd)
    bad = [(s.frame_id, s.status) for s in system.trajectory if s.status != "ok"]
    if bad:
        raise AssertionError(f"live RGB-D frames not ok: {bad[:10]}")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX:
        raise AssertionError(f"live RGB-D ATE {ate} m > {LIVE_ATE_MAX} m")
    if rgbd["graph_replays"]:
        raise AssertionError("frames with depth images must take the synchronous path")
    out["live_rgbd"] = {"ate": ate, "keyframes": int(sum(s.is_keyframe for s in system.trajectory)),
                        "launches": rgbd["launches"], "card_s": round(card_s, 2)}
    return out


def results(diag):
    """A megastep's diagnostics row without the stage times stamped after
    its results (`system.PIPE_DIAG`), which differ from call to call."""
    return diag[..., :PIPE_DIAG]


def phase_graph_vs_eager(frames, n: int = 4):
    """Each of the first n pipelined frames: the graph's replay against the
    eager megastep on the same inputs, every output bit-equal (of the
    diagnostics row its 26 results: the stage times after them are the
    card's clock)."""
    from uwslam_tpu_torch.ops.graph import tree_leaves

    system = make_system(frames.device)
    system.process_frame(frames[0], timestamp=0.0)
    eager = system._build_step_plain()
    compared = 0
    for i in range(1, n + 1):
        prev_pyr, prev_pts, _ = system._prev
        want = eager(frames[i], prev_pyr, prev_pts, system._velocity, system._T_wc,
                     system.keyframes.latest.T_wc, system._eye)
        system.process_frame_async(frames[i], timestamp=float(i))
        rec = system._pipe_queue[-1]
        got = (rec["pyr"], rec["pts"], system._velocity, system._T_wc, results(rec["diag"]))
        for a, b in zip(tree_leaves(got), tree_leaves((*want[:-1], results(want[-1])))):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"frame {i}: graph replay differs from the eager megastep by "
                    f"{float((a.float() - b.float()).abs().max())}")
            compared += 1
    system.flush()
    if system.graph_replays != n:
        raise AssertionError(f"{system.graph_replays} graph replays, expected {n}")
    return {"frames": n, "tensors_bit_equal": compared}


def states_vs_cpu(card, cpu, what: str) -> float:
    ids = [s.frame_id for s in card.trajectory]
    if ids != list(range(len(ids))):
        raise AssertionError(f"{what}: frame ids out of order: {ids}")
    return card_vs_cpu(card.trajectory, cpu.trajectory, what)


def phase_pipelined(frames, poses, table, sync_ate: float, worker):
    """96 frames through the pipelined loop on the card with fresh launch
    counts, against the CPU's pipelined run (`worker`) and the synchronous
    run's ATE."""
    t0 = time.perf_counter()
    (system, frame_ms), launches = counted(table, "the pipelined path", lambda: run_pipelined(
        frames, frames.device, events=True))
    card_s = time.perf_counter() - t0
    n = frames.shape[0]
    if len(system.trajectory) != n:
        raise AssertionError(f"{len(system.trajectory)} states for {n} frames")
    if system.graph_replays < PIPE_MIN_GRAPH_FRAMES:
        raise AssertionError(f"only {system.graph_replays} of {n} frames went through the "
                             f"graph, expected at least {PIPE_MIN_GRAPH_FRAMES}")
    bad = [(s.frame_id, s.status) for s in system.trajectory if s.status != "ok"]
    if bad:
        raise AssertionError(f"pipelined frames not ok: {bad[:10]}")
    ate = live_ate(system, poses)
    if not ate <= LIVE_ATE_MAX or not abs(ate - sync_ate) <= PIPE_VS_SYNC_ATE:
        raise AssertionError(f"pipelined ATE {ate} m (synchronous {sync_ate} m)")
    cpu, cpu_s = worker.result("pipelined")
    cpu = RunRecord(cpu)
    dev_cpu = states_vs_cpu(system, cpu, "pipelined loop")
    return {
        "launches": launches, "graph_replays": system.graph_replays, "ate": ate,
        "sync_ate": sync_ate, "card_vs_cpu": dev_cpu,
        "keyframes": [s.frame_id for s in system.trajectory if s.is_keyframe],
        "card_s": round(card_s, 2), "cpu_s": round(cpu_s, 2),
    }, frame_ms


def phase_pipelined_reloc(noisy, poses, worker):
    """The relocalization sequence through the pipelined loop, on the card
    and on the CPU (`worker`): statuses, keyframes and poses must agree frame
    by frame (`states_vs_cpu`), which holds the late failure, the drain and
    the re-entry to the port's CPU run; the ATE bars come second."""
    system, _ = run_pipelined(noisy, noisy.device)
    cpu, cpu_s = worker.result("pipelined_reloc")
    cpu = RunRecord(cpu)
    dev_cpu = states_vs_cpu(system, cpu, "pipelined relocalization run")
    status = [s.status for s in system.trajectory]
    first_bad = next(i for i, st in enumerate(status) if st != "ok")
    last_bad = max(i for i, st in enumerate(status) if st != "ok")
    if first_bad not in (NOISE_FRAME, NOISE_FRAME + 1):
        raise AssertionError(f"first frame not ok is {first_bad}: {status[first_bad]}")
    drained = status[first_bad + 1: last_bad + 1]
    if not drained or set(drained) != {"lost"} or len(drained) > 2 * system._pipe_batch + 1:
        raise AssertionError(f"frames drained after the failure: {drained}")
    if system._pipe_broken or set(status[last_bad + 1:]) != {"ok"}:
        raise AssertionError("the loop did not re-enter after the drain")
    if system.graph_replays < len(status) - len(drained) - 4:
        raise AssertionError(f"only {system.graph_replays} frames went through the graph")
    keep = np.array([st == "ok" for st in status])
    ate = live_ate(system, poses, keep)
    if not ate <= PIPE_RELOC_ATE_MAX:
        raise AssertionError(f"pipelined relocalization run ATE {ate} m > {PIPE_RELOC_ATE_MAX}")
    # Each side of the step alone is an ordinary tracked trajectory.
    index = np.arange(len(status))
    sides = {"before": live_ate(system, poses, index < first_bad),
             "after": live_ate(system, poses, index > last_bad)}
    for side, side_ate in sides.items():
        if not side_ate <= LIVE_ATE_MAX:
            raise AssertionError(f"ATE {side} the drained frames {side_ate} m > {LIVE_ATE_MAX}")
    est = np.stack([s.T_wc for s in system.trajectory])[last_bad + 2:]
    gt = torch.linalg.inv(poses.cpu()).numpy()[last_bad + 2:]
    step_err = float(np.abs(np.diff(est[:, :3, 3], axis=0) - np.diff(gt[:, :3, 3], axis=0)).max())
    if not step_err <= 5e-3:
        raise AssertionError(f"per-frame motion after the re-entry is off by {step_err} m")
    return {"first_not_ok": [first_bad, status[first_bad]], "drained_as_lost": len(drained),
            "re_entered_at": last_bad + 1, "graph_replays": system.graph_replays,
            "ate_over_ok_frames": ate, "ate_over_ok_frames_cpu": live_ate(cpu, poses, keep),
            "ate_before": sides["before"], "ate_after": sides["after"],
            "card_vs_cpu": dev_cpu, "step_err_after": step_err, "cpu_s": round(cpu_s, 2)}


def phase_pipelined_timing(frames, frame_ms, sync: dict, table):
    """The pipelined loop's frames/s and per-frame time after the warm-up
    frames (CUDA events at the end of each call of phase 11b's run; the host
    never waits for the frame it has just dispatched). Then one fresh system:
    a steady window of frames under the profiler with event marks around it,
    which gives, from that one window, the device busy time, the graph
    launches, every device launch and the idle share; and each kernel's
    launches counted by its name in the profile, which must equal what the
    wrappers counted over the window (`CapturedStep` adds a remembered count
    per replay: this is the measurement that holds it). Beside phase 9's
    synchronous loop. Tracing each of a graph's kernels slows the window
    down, so its idle share is an upper bound; `idle_share_vs_unprofiled`
    divides the same busy time by phase 11b's mean frame time."""
    from torch.profiler import ProfilerActivity, profile

    steady = frame_ms[LIVE_WARMUP:]
    system = make_system(frames.device)
    for i in range(LIVE_WARMUP):
        system.process_frame_async(frames[i], timestamp=float(i))
    torch.cuda.synchronize()
    reps = PIPE_PROFILED_FRAMES
    missed = []
    # The profiler's activity trace of a window of ~60,000 kernels can come
    # back a record or two short (seen once on an H100: 23 of 24 K2
    # launches): the window is profiled again, up to PROFILE_ATTEMPTS times,
    # and one window must show every launch the wrappers counted.
    for attempt in range(PROFILE_ATTEMPTS):
        first = LIVE_WARMUP + attempt * reps
        replays_before = system.graph_replays
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for k in table:
            k["wrapper"].launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for i in range(first, first + reps):
                system.process_frame_async(frames[i], timestamp=float(i))
            end.record()
            torch.cuda.synchronize()
        counted_by_wrappers = {k["name"]: k["wrapper"].launches for k in table
                               if k["name"] in KERNEL_SYMBOLS}
        window_ms = start.elapsed_time(end) / reps
        replays = system.graph_replays - replays_before
        if replays != reps:
            raise AssertionError(f"{replays} of the {reps} profiled frames went through the graph")
        averages = prof.key_averages()
        kernels = device_work(averages)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        if not busy_ms > 0:
            raise AssertionError("the profiler saw no device time in the pipelined window")
        seen = {name: sum(e.count for e in kernels if symbol in e.key)
                for name, symbol in KERNEL_SYMBOLS.items()}
        if seen == counted_by_wrappers and all(seen.values()):
            break
        missed.append(seen)
    else:
        raise AssertionError(f"launches in the profiled windows: the profiler saw {missed} by "
                             f"kernel name, the wrappers counted {counted_by_wrappers}")
    (step,) = system._steps.values()
    system.flush()
    step_ms = stage_ms(system, PLAIN_STAGES)
    graph_launches = sum(e.count for e in averages if e.key == "cudaGraphLaunch") / reps
    return {
        "frames_per_s": len(steady) / (sum(steady) / 1e3),
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": float(np.percentile(steady, 90)),
        "profiled_window": {
            "frames": reps, "ms_per_frame": window_ms,
            "device_busy_ms_per_frame": busy_ms,
            "idle_share": 1.0 - busy_ms / window_ms,
            "device_launches_per_frame": sum(e.count for e in kernels) / reps,
            "graph_launches_per_frame": graph_launches,
            "kernel_launches_seen_by_name": seen,
            "windows_short_of_records": missed,
            "kernel_launches_counted": counted_by_wrappers,
            "kernel_launches_per_replay_at_capture": dict(zip(
                (k["name"] for k in table), step.kernel_launches)),
        },
        "idle_share_vs_unprofiled": 1.0 - busy_ms / statistics.mean(steady),
        "step_ms_per_replay": step_ms,
        "synchronous_same_run": {k: sync[k] for k in (
            "frames_per_s", "latency_ms_median", "latency_ms_p90",
            "device_busy_ms_per_frame", "idle_share", "launches_per_frame")},
    }


def write_euroc_dataset(frames, poses, raw, root: Path):
    """8-bit PGM frames in the EUROC layout (mav0/cam0/data/<ns>.pgm), its
    ground-truth CSV and a calibration XML with the radtan coefficients."""
    from uwslam_tpu_torch.lie import se3

    data = root / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    imgs = frames.clamp(0, 255).to(torch.uint8).cpu().numpy()
    q, t = (x.numpy() for x in se3.to_quaternion_translation(se3.inverse(poses.cpu())))
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz\n"]
    for i, img in enumerate(imgs):
        ns = int(1e9 * (1.0 + 0.05 * i))
        h, w = img.shape
        (data / f"{ns}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        rows.append(f"{ns},{t[i, 0]},{t[i, 1]},{t[i, 2]},"
                    f"{q[i, 0]},{q[i, 1]},{q[i, 2]},{q[i, 3]}\n")
    (root / "gt.csv").write_text("".join(rows))
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>{raw.width}</in_width><in_height>{raw.height}</in_height>
<out_width>{raw.width}</out_width><out_height>{raw.height}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.fx} {raw.fy} {raw.cx} {raw.cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.k1} {raw.k2} {raw.p1} {raw.p2}</data></rectification>
</opencv_storage>
""")
    return root / "mav0", root / "calib.xml", root / "gt.csv"


def cli_text(argv, what: str) -> tuple[float, str, str]:
    """The port's CLI in this process -> (its ATE, stdout, stderr); it must
    exit 0 and print its ATE."""
    from uwslam_tpu_torch.cli.main import main as cli_main

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+-]+) m", buf.getvalue())
    if rc != 0 or m is None:
        raise AssertionError(f"CLI {what}: exit {rc}, output {buf.getvalue()!r} {err.getvalue()!r}")
    return float(m.group(1)), buf.getvalue(), err.getvalue()


def run_cli(argv, what: str) -> dict:
    """The port's CLI in this process; it must exit 0 and print its ATE."""
    t0 = time.perf_counter()
    ate, _, err = cli_text(argv, what)
    ba = re.search(r"window BA: (\d+) LM iters over (\d+) runs", err)
    return {"ate": ate, "s": round(time.perf_counter() - t0, 2),
            **({"ba_iters": int(ba.group(1)), "ba_runs": int(ba.group(2))} if ba else {})}


def phase_rectification(poses, table):
    """Distorted frames through the pipelined loop on the card and the CPU,
    and through the CLI with --euroc."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.utils.synthetic import render_plane_view_distorted

    raw = replace(bench.CAM, **RECT_DISTORTION)
    poses = poses[:RECT_FRAMES]
    frames = render_plane_view_distorted(raw, poses, bench.PLANE_Z)
    # The kernels at this path's shapes first: the cropped region of interest
    # is no multiple of the pyramid kernel's tiles and its rows have another
    # stride.
    from uwslam_tpu_torch.ops.cuda_pyramid import pyramid_tile

    probe = make_system(frames.device, raw=raw)
    pyrs = [probe._ingest_pyramid(frames[i]) for i in (0, 1)]
    shapes = [list(im.shape[1:]) for im in pyrs[0].images]
    tile = pyramid_tile(1, *shapes[0], len(shapes))
    if shapes[0][0] % tile == 0 and shapes[0][1] % tile == 0:
        raise AssertionError(f"the rectified frame {shapes[0]} does not test a ragged tile")
    parity, _ = phase_parity_live(*pyrs, probe._select_points(pyrs[0]), probe.cam,
                                  probe.config.tracker.track_levels, "rectified B=1")
    del probe, pyrs
    (system, _), launches = counted(table, "the rectified path", lambda: run_pipelined(
        frames, frames.device, raw=raw))
    with cpu_run():
        cpu, _ = run_pipelined(frames.cpu(), "cpu", raw=raw)
    if system._roi != cpu._roi or system.cam != cpu.cam:
        raise AssertionError(f"ROI or camera differ: card {system._roi} {system.cam}, "
                             f"CPU {cpu._roi} {cpu.cam}")
    if system._rect_map is None or system._roi[2:] == (raw.width, raw.height):
        raise AssertionError("the distorted calibration did not rectify and crop")
    if system.graph_replays != RECT_FRAMES - 1:
        raise AssertionError(f"{system.graph_replays} rectified frames went through the graph")
    dev_cpu = states_vs_cpu(system, cpu, "rectified pipelined loop")
    ate = live_ate(system, poses)
    if not ate <= RECT_ATE_MAX:
        raise AssertionError(f"rectified ATE {ate} m > {RECT_ATE_MAX} m")
    with tempfile.TemporaryDirectory() as tmp:
        mav, calib, gt = write_euroc_dataset(frames, poses, raw, Path(tmp))
        cli = run_cli(["-d", str(mav), "--euroc", "-c", str(calib), "--euroc-gt", str(gt),
                       "--levels", "3", "--track-levels", "1,0", "--mono-depth", "2.0",
                       "--platform", "cuda", "--trajectory-out", str(Path(tmp) / "est.txt")],
                      "--euroc")
    if not cli["ate"] <= RECT_ATE_MAX:
        raise AssertionError(f"CLI --euroc: ATE {cli['ate']} m > {RECT_ATE_MAX} m")
    return {"parity_max_abs_err": parity, "parity_level_shapes": shapes,
            "roi": list(system._roi), "ate": ate, "card_vs_cpu": dev_cpu,
            "graph_replays": system.graph_replays, "launches": launches, "cli_euroc": cli}


# ------------------------------------------------------ configs 2 and 4

def top_operators(fn, n: int = 8) -> dict | None:
    """{operator: [device ms, calls]} of the costliest operators of one eager
    call of fn (op-level tracing), or None where no device time is seen."""
    try:
        _, ops = profiled_kernels(fn, 1, ops=True)
    except NoDeviceTime:
        return None
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:n]
    return {e.key: [round(e.self_device_time_total / 1e3, 4), e.count] for e in top}


def profile_once(fn):
    """(device ms, kernels) of one call of fn from the profiler, or (None,
    None) where it records no device time."""
    try:
        return device_profile(fn, 1)
    except NoDeviceTime:
        return None, None


def phase_ba(gpu: str):
    """Bundle adjustment at the bench's window shape, eager and as the
    captured graph the live loop dispatches."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.ba.schur import BAProblem, bundle_adjust, lm_passes
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.ops.graph import CapturedStep

    dev = torch.device("cuda", 0)
    problem, T_gt = bench.ba_bench_problem(dev)
    kw = dict(max_iters=bench.BA_MAX_ITERS)

    def gap(T_a, T_b) -> float:
        return float(se3.log(se3.compose(T_a, se3.inverse(T_b))).abs().max())

    first = bundle_adjust(problem, bench.CAM, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = bundle_adjust(problem, bench.CAM, **kw)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("two bundle_adjust runs on the card differ")
    t0 = time.perf_counter()
    with cpu_run():
        cpu = bundle_adjust(BAProblem(*(t.cpu() for t in problem)), bench.CAM, **kw)
    cpu_s = time.perf_counter() - t0
    c0, c, c_cpu = float(again.initial_cost), float(again.cost), float(cpu.cost)
    if not (c < c0 and abs(c - c_cpu) <= BA_COST_RTOL * c_cpu):
        raise AssertionError(f"BA cost {c0} -> {c} on the card, {c_cpu} on the CPU")
    dev_cpu = gap(again.T_cw.cpu(), cpu.T_cw)
    if not dev_cpu <= BA_POSE_ATOL:
        raise AssertionError(f"BA poses card vs CPU differ by {dev_cpu} > {BA_POSE_ATOL}")
    err0, err = gap(problem.T_cw, T_gt), gap(again.T_cw, T_gt)
    if not err < err0:
        raise AssertionError(f"BA pose error {err0} -> {err}: no improvement")

    def solve(*q):
        out = bundle_adjust(BAProblem(*q), bench.CAM, **kw)
        return out.T_cw, out.points, out.cost, out.initial_cost, out.iterations

    t0 = time.perf_counter()
    step = CapturedStep(solve, tuple(problem))
    capture_s = time.perf_counter() - t0
    out = step(*problem)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("the captured solve differs from the eager one")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    step(*problem)
    end.record()
    replay_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end)
    busy_ms, kernels = profile_once(lambda: step(*problem))
    top = top_operators(lambda: bundle_adjust(problem, bench.CAM, **kw))
    iters = int(again.iterations)
    return {
        "iterations": iters, "iterations_cpu": int(cpu.iterations),
        "lm_passes_executed": lm_passes(bench.BA_MAX_ITERS),
        "cost": [c0, c], "cost_cpu": c_cpu, "card_vs_cpu": dev_cpu,
        "pose_error": [err0, err], "two_runs_bit_equal": True,
        "eager_ms": eager_ms, "eager_host_ms": host_ms,
        "eager_iters_per_s": iters / (eager_ms / 1e3),
        "graph_equals_eager": True, "capture_s": round(capture_s, 2),
        "replay_ms": replay_ms, "replay_host_ms": replay_host_ms,
        "replay_iters_per_s": iters / (replay_ms / 1e3),
        "replay_device_busy_ms": busy_ms, "replay_kernels": kernels,
        "replay_idle_share": None if busy_ms is None else 1.0 - busy_ms / replay_ms,
        "top_ops_device_ms_and_calls_per_solve": top,
        "bench": bench.bench_ba_iters(dev), "cpu_s": round(cpu_s, 2), "gpu": gpu,
    }


def phase_refine_kernel(frames, pts, cam):
    """K3 at the depth-refinement shape against its plain version, and
    `refine_inverse_depth` on the card against the CPU."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.image.pyramid import build_pyramid
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.depth_refine import refine_inverse_depth

    dev = frames.device
    pyr = build_pyramid(frames[1], levels=1)
    texels = ops.pack_texels(pyr.images[0], pyr.grad_x[0], pyr.grad_y[0])
    W, H = cam.width, cam.height
    uv = pts.uv[:1].clone() + 0.37                      # subpixel, as projections are
    edge = torch.tensor([[W - 1, 10.0], [W - 1, 57.25], [W - 1, H - 1], [33.5, H - 1],
                         [0.0, 0.0], [W - 1.5, H - 1.5], [W - 1 + 1e-3, 5.0], [-1e-3, 5.0],
                         [float("nan"), 3.0]], device=dev)
    uv[0, : len(edge)] = edge
    before = ops.cuda_bilinear_sample.launches
    k = ops.cuda_bilinear_sample(texels, uv, texels=True)
    if ops.cuda_bilinear_sample.launches != before + 1:
        raise AssertionError("K3 did not launch at the depth-refinement shape")
    err = compare(k, ops.bilinear_sample_texels_plain(texels, uv), SAMPLE_ATOL,
                  "bilinear_sample at the depth-refinement shape")
    if k[1][0, : len(edge)].tolist() != [True] * 6 + [False] * 3:
        raise AssertionError(f"K3 validity at the edge points: {k[1][0, :len(edge)].tolist()}")
    planes = ops.unpack_texels(texels).contiguous()
    grid_err = check_grid_sample(k, planes, uv, "depth-refinement shape")
    times = time_pairs(
        {"refine": (lambda: ops.cuda_bilinear_sample(texels, uv, texels=True),
                    lambda: ops.bilinear_sample_texels_plain(texels, uv))},
        {"refine": bound_sampler(k[1], 3, 8)},
        {"refine": grid_sample_call(planes, uv)},
    )["refine"]
    one = pts.select(slice(0, 1))
    T = se3.exp(torch.tensor([0.012, 0.004, 0.002, 0.001, -0.001, 0.002], device=dev))
    before = ops.cuda_bilinear_sample.launches
    ref = refine_inverse_depth(one, T, pyr.images[0], pyr.grad_x[0], pyr.grad_y[0], cam)
    launches = ops.cuda_bilinear_sample.launches - before
    if launches != 5:
        raise AssertionError(f"refine_inverse_depth launched K3 {launches} times, not 5")
    with cpu_run():
        cpu = refine_inverse_depth(
            type(one)(*(None if f is None else f.cpu() for f in one)), T.cpu(),
            *(x[0].cpu() for x in (pyr.images, pyr.grad_x, pyr.grad_y)), cam)
    rho_dev = float((ref.inv_depth.cpu() - cpu.inv_depth).abs().max())
    flips = int((ref.good.cpu() != cpu.good).sum())
    if not rho_dev <= 1e-4 or flips > 4:
        raise AssertionError(f"refine_inverse_depth card vs CPU: {rho_dev}, {flips} flags flip")
    return {"max_abs_err": err, "vs_grid_sample": grid_err, "launches_per_refinement": launches,
            "refine_card_vs_cpu": rho_dev, "good_flags_flipped": flips,
            "good_share": float(ref.good.float().mean())}, times


def scene_sequence(dev):
    """SCENE_FRAMES views of the multi-plane scene along a sinusoidal twist,
    rendered on the card -> (frames (N, H, W), camera-from-world poses)."""
    import math

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.utils.synthetic import render_scene_view

    amp = torch.tensor(SCENE_TWIST_AMP, dtype=torch.float32, device=dev)
    poses = se3.exp(torch.stack([
        amp * math.sin(2.0 * math.pi * i / SCENE_FRAMES) for i in range(SCENE_FRAMES)]))
    return torch.stack([render_scene_view(bench.CAM, T) for T in poses]), poses


def front_end_system(device, *, bootstrap=False, ba=False, features=True, reference=False,
                     tracker=None):
    """A SlamSystem of this slice's configurations on `device`: the CLI's
    default tracker (5 levels, track levels 3-0) on the scene, or `tracker`."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.config import SlamConfig, TrackerConfig
    from uwslam_tpu_torch.system import SlamSystem
    from uwslam_tpu_torch.tracking.robust import WeightKind

    tracker = TrackerConfig(mono_depth=SCENE_MONO_DEPTH) if tracker is None else tracker
    tracker = replace(tracker, depth_bootstrap=bootstrap)
    config = SlamConfig(tracker=tracker, use_features=features, use_ba=ba)
    if reference:
        config = replace(config, use_reloc=False, tracker=replace(
            tracker, track_levels=(0,), max_iterations=10, weight_kind=WeightKind.NONE))
    calib = Calibration(raw=bench.CAM, out_width=bench.CAM.width, out_height=bench.CAM.height)
    return SlamSystem(calib, config, device=device)


def drive(system, frames, pipelined=False, events=False):
    """Frames through the system -> (first frame with a depth prior or None,
    ms between frame ends or None)."""
    step = system.process_frame_async if pipelined else system.process_frame
    installed, marks = None, []
    for i in range(frames.shape[0]):
        step(frames[i], timestamp=float(i))
        if installed is None and system._depth_prior is not None:
            installed = i
        if events:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    system.flush()
    if not events:
        return installed, None
    torch.cuda.synchronize()
    return installed, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def all_ok(system, what: str) -> None:
    bad = [(s.frame_id, s.status) for s in system.trajectory if s.status != "ok"]
    if bad or not all(np.isfinite(s.T_wc).all() for s in system.trajectory):
        raise AssertionError(f"{what}: frames not ok: {bad[:10]}")


def pose_gap(a, b, n: int | None = None) -> float:
    """Largest |se3.log| difference of two systems' exported poses (the
    first `n`)."""
    from uwslam_tpu_torch.lie import se3

    pa, pb = (torch.from_numpy(s.export_trajectory()[1][:n]) for s in (a, b))
    return float((se3.log(pa) - se3.log(pb)).abs().max())


def phase_config2(scene, scene_poses, plane_frames, plane_poses, table, worker):
    """Config 2 on the card, synchronous, with and without the bootstrap,
    against the port's CPU run (`worker`); and the reference-mode preset.
    The runs without the bootstrap and in reference mode, then phase 16a's
    comparison (`phase_boot_graph_vs_eager`, its result under
    "boot_graph_vs_eager"), go on in a process of their own (`ProcessRuns`)
    beside the bootstrap's."""
    with tempfile.TemporaryDirectory() as tmp:
        side = ProcessRuns(Path(tmp) / "side", "system",
                           dict.fromkeys(("config2_flat", "reference_mode", "boot_graph_vs_eager")),
                           {"scene": scene.cpu(), "plane": plane_frames[:SCENE_FRAMES].cpu()})
        try:
            out, boot = config2_runs(scene, scene_poses, plane_poses, table, worker, side)
            out["boot_graph_vs_eager"] = side.result("boot_graph_vs_eager")[0]
        finally:
            side.stop()
    return out, boot


def config2_runs(scene, scene_poses, plane_poses, table, worker, side):
    dev = scene.device
    t0 = time.perf_counter()
    boot = front_end_system(dev, bootstrap=True)
    (installed, _), launches = counted(table, "the bootstrap path", lambda: drive(boot, scene))
    card_s = time.perf_counter() - t0
    all_ok(boot, "config 2")
    if installed is None or installed > PRIOR_INSTALLED_BY:
        raise AssertionError(f"depth prior installed at frame {installed}")
    # The CPU runs the first CONFIG2_CPU_FRAMES frames; without BA a frame's
    # exported pose is final once tracked, so the card's run of all frames
    # holds the card's run of the prefix. The second card run and the run
    # with noise take that prefix too: the frames the CPU is held on.
    n_cpu = CONFIG2_CPU_FRAMES
    again = front_end_system(dev, bootstrap=True)
    drive(again, scene[:n_cpu])
    if pose_gap(boot, again, n_cpu) != 0.0:
        raise AssertionError(f"two config-2 runs on the card differ over {n_cpu} frames")
    cpu, cpu_s = worker.result("config2")
    cpu = RunRecord(cpu)
    all_ok(cpu, "config 2 on the CPU")
    ate_prefix = live_ate(boot, scene_poses, keep=slice(0, n_cpu))
    ate_cpu, gap = live_ate(cpu, scene_poses[:n_cpu]), pose_gap(boot, cpu, n_cpu)
    statuses = lambda s: [x.status for x in s.trajectory]   # noqa: E731
    if not (statuses(boot)[:n_cpu] == statuses(cpu) and ate_cpu <= CONFIG2_ATE_MAX
            and abs(ate_prefix - ate_cpu) <= 0.15 * ate_cpu and gap <= CONFIG2_POSE_ATOL):
        raise AssertionError(f"config 2 card vs CPU over {n_cpu} frames: ATE {ate_prefix} vs "
                             f"{ate_cpu} m, poses {gap}")
    # How far last-bit differences carry on this path: the CPU's frames plus
    # noise far below one gray level, on the card.
    noise = CONFIG2_NOISE * torch.randn(scene.shape, generator=torch.Generator().manual_seed(0))
    shaken = front_end_system(dev, bootstrap=True)
    drive(shaken, (scene + noise.to(dev))[:n_cpu])
    all_ok(shaken, "config 2 with 1e-4 of noise")
    by_noise = pose_gap(boot, shaken, n_cpu)
    if not by_noise <= CONFIG2_POSE_ATOL:
        raise AssertionError(f"1e-4 gray levels of noise moved config 2's poses by {by_noise}")
    beside = {key: side.result(key)[0] for key in ("config2_flat", "reference_mode")}
    flat = RunRecord(beside["config2_flat"])
    all_ok(flat, "config 2 at constant depth")
    ate, ate_flat = live_ate(boot, scene_poses), live_ate(flat, scene_poses)
    if not (ate < ate_flat and ate <= CONFIG2_ATE_MAX):
        raise AssertionError(f"bootstrap ATE {ate} m, constant depth {ate_flat} m")
    n = SCENE_FRAMES
    ref = RunRecord(beside["reference_mode"])
    all_ok(ref, "reference mode")
    ate_ref = live_ate(ref, plane_poses[:n])
    matches = beside["reference_mode"]["matches"]
    if not ate_ref <= REFERENCE_ATE_MAX or matches < beside["reference_mode"]["min_matches"]:
        raise AssertionError(f"reference mode: ATE {ate_ref} m, {matches} matches")
    kfs = lambda s: [x.frame_id for x in s.trajectory if x.is_keyframe]   # noqa: E731
    return {
        "ate": ate, "ate_constant_depth": ate_flat, "cpu_frames": n_cpu,
        "ate_card_cpu_frames": ate_prefix, "ate_cpu": ate_cpu,
        "card_vs_cpu_pose": gap, "statuses": "equal", "two_card_runs": "bit-equal",
        "noise_1e-4_moves_card_poses_by": by_noise, "keyframes_with_noise": kfs(shaken),
        "prior_installed_at": installed, "keyframes": kfs(boot),
        "keyframes_cpu": kfs(cpu),
        "launches": launches, "frames": n, "card_s": round(card_s, 2), "cpu_s": round(cpu_s, 2),
        "reference_mode": {"ate": ate_ref, "frames": n, "matches_last_pair": matches,
                           "patch_points_last_pair": 25 * min(matches, 200)},
    }, boot


def phase_boot_graph_vs_eager(scene, n: int = 3):
    """The bootstrap megastep's replay against its eager call on the same
    inputs (the frame's RANSAC uniforms included), every output bit-equal
    (of the diagnostics row its results, as in phase 11a)."""
    from uwslam_tpu_torch.ops.graph import tree_leaves

    system = front_end_system(scene.device, bootstrap=True)
    compared = replayed = 0
    for i in range(scene.shape[0]):
        if replayed < n and system._can_pipeline(None):
            prev_pyr, prev_pts, _ = system._prev
            kp, desc = system._prev_feats
            want = system._build_step_boot()(
                scene[i], prev_pyr, prev_pts, kp.uv, desc, kp.valid, system._depth_prior,
                system._velocity, system._T_wc, system.keyframes.latest.T_wc, system._eye,
                system._ransac_uniforms(desc.shape[0], system._frame_id))
            system.process_frame_async(scene[i], timestamp=float(i))
            rec = system._pipe_queue[-1]
            got = (rec["pyr"], *rec["feats"], system._velocity, system._T_wc, rec["prior"],
                   rec["kp_depth"], rec["pts"], results(rec["diag"]))
            for a, b in zip(tree_leaves(got), tree_leaves((*want[:-1], results(want[-1])))):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"frame {i}: the bootstrap graph's replay differs from the eager "
                        f"megastep by {float((a.float() - b.float()).abs().max())}")
                compared += 1
            replayed += 1
        elif replayed < n:
            system.process_frame_async(scene[i], timestamp=float(i))
        else:
            break
    system.flush()
    if replayed != n:
        raise AssertionError(f"only {replayed} frames entered the bootstrap megastep")
    return {"frames": n, "tensors_bit_equal": compared}


def phase_config2_pipelined(scene, scene_poses, table, sync_system):
    """Config 2 through the pipelined loop against the synchronous run, the
    device ms of the bootstrap megastep's stages (its stamps) over that run,
    and a profiled window of the bootstrap megastep."""
    from torch.profiler import ProfilerActivity, profile

    dev = scene.device
    system = front_end_system(dev, bootstrap=True)
    t0 = time.perf_counter()
    (_, frame_ms), launches = counted(table, "the pipelined bootstrap path",
                                      lambda: drive(system, scene, pipelined=True, events=True))
    card_s = time.perf_counter() - t0
    all_ok(system, "config 2 pipelined")
    if [s.frame_id for s in system.trajectory] != list(range(scene.shape[0])):
        raise AssertionError("config 2 pipelined: frame ids out of order")
    ate, sync_ate = live_ate(system, scene_poses), live_ate(sync_system, scene_poses)
    gap = pose_gap(system, sync_system)
    if not abs(ate - sync_ate) <= PIPE_VS_SYNC_ATE or not gap <= LIVE_T_ATOL:
        raise AssertionError(f"config 2 pipelined ATE {ate} m vs synchronous {sync_ate} m, "
                             f"poses {gap}")
    (key,) = [k for k in system._steps if k[0] == "boot"]
    step = system._steps[key]
    if step.replays < scene.shape[0] - 16:
        raise AssertionError(f"only {step.replays} frames went through the bootstrap graph")
    steady = frame_ms[-(step.replays - 4):]
    step_ms = stage_ms(system, BOOT_STAGES)
    if step_ms["frames"] != step.replays:
        raise AssertionError(f"{step_ms['frames']} of {step.replays} bootstrap replays stamped")
    # A profiled window of a fresh run, once it is in the megastep.
    fresh = front_end_system(dev, bootstrap=True)
    warm = scene.shape[0] - BOOT_PROFILED_FRAMES - 2
    for i in range(warm):
        fresh.process_frame_async(scene[i], timestamp=float(i))
    torch.cuda.synchronize()
    before = fresh.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm, warm + BOOT_PROFILED_FRAMES):
            fresh.process_frame_async(scene[i], timestamp=float(i))
        torch.cuda.synchronize()
    profiled = fresh.graph_replays - before
    prev_pyr, prev_pts, _ = fresh._prev
    kp, desc = fresh._prev_feats
    eager_inputs = (scene[-1], prev_pyr, prev_pts, kp.uv, desc, kp.valid, fresh._depth_prior,
                    fresh._velocity, fresh._T_wc, fresh.keyframes.latest.T_wc, fresh._eye,
                    fresh._ransac_uniforms(desc.shape[0], 0))
    top = top_operators(lambda: fresh._build_step_boot()(*eager_inputs))
    fresh.flush()
    kernels = device_work(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / max(profiled, 1)
    return {
        "launches": launches, "graph_replays": step.replays,
        "launches_per_replay": dict(zip((k["name"] for k in table), step.kernel_launches)),
        "ate": ate, "sync_ate": sync_ate, "pipelined_vs_sync_pose": gap,
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": float(np.percentile(steady, 90)),
        "frames_per_s": len(steady) / (sum(steady) / 1e3),
        "step_ms_per_replay": step_ms,
        "profiled_frames": profiled,
        "device_busy_ms_per_frame": busy_ms if busy_ms > 0 else None,
        "device_launches_per_frame": sum(e.count for e in kernels) / max(profiled, 1),
        "idle_share_vs_unprofiled": (1.0 - busy_ms / statistics.mean(steady)
                                     if busy_ms > 0 else None),
        "top_ops_device_ms_and_calls_per_eager_megastep": top,
        "card_s": round(card_s, 2),
    }


def ba_system(device, features: bool):
    """Config 4 at the live design point (phase 6's tracker)."""
    return front_end_system(device, ba=True, features=features, tracker=live_config().tracker)


def stage_ms(system, stages: tuple[str, ...]) -> dict:
    """Mean device ms of each megastep stage (`FrameState.step_ms`, the
    stamps inside the graph) over the frames whose replay stamped `stages`,
    and their count; every stage time must be non-negative."""
    stamped = [s.step_ms for s in system.trajectory
               if s.step_ms is not None and tuple(s.step_ms) == stages]
    if not stamped or min(min(ms.values()) for ms in stamped) < 0:
        raise AssertionError(f"{len(stamped)} frames stamped {stages}, "
                             f"or a negative stage time")
    return {"frames": len(stamped),
            **{k: statistics.mean(ms[k] for ms in stamped) for k in stages}}


def frame_summary(ms) -> dict:
    """Median, p90, max and mean ms between frame ends after the warm-up
    frames, and how many frames took over 3 times the median."""
    steady = ms[LIVE_WARMUP:]
    median = statistics.median(steady)
    return {"median": median, "p90": float(np.percentile(steady, 90)),
            "max": max(steady), "mean": statistics.mean(steady),
            "frames_over_3x_median": sum(m > 3 * median for m in steady)}


def spy_keyframe_matches(system) -> list:
    """Record every keyframe match the system applies to its track graph:
    ((the two keyframes), the arrays as they arrived)."""
    seen, pairs = [], {}
    dispatch, add = system._dispatch_keyframe_match, system._tracks.add_keyframe_matches

    def dispatch_spy(prev_kf, kf, window):
        pairs[(prev_kf.frame_id, kf.frame_id)] = (prev_kf, kf)
        return dispatch(prev_kf, kf, window)

    def add_spy(a, b, *arrays):
        seen.append((pairs.pop((a, b)), arrays))
        return add(a, b, *arrays)

    system._dispatch_keyframe_match = dispatch_spy
    system._tracks.add_keyframe_matches = add_spy
    return seen


def check_match_tables(system, seen) -> int:
    """Each match table the loop applied (a graph replay on the solves'
    stream, read back through pinned memory) against the match computed
    eagerly on the same keyframes and samples: bit-equal."""
    for (prev_kf, kf), got in seen:
        want = system._keyframe_match_table(
            prev_kf.kp_uv, prev_kf.kp_desc, prev_kf.kp_valid, kf.kp_uv, kf.kp_desc, kf.kp_valid,
            system._ransac_uniforms(prev_kf.kp_desc.shape[0], kf.frame_id)).cpu().numpy()
        ref = (want[:, 0].astype(np.int64), want[:, 1].astype(np.int64), want[:, 2:4],
               want[:, 4:6], want[:, 6] > 0.5)
        if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"keyframes {prev_kf.frame_id}-{kf.frame_id}: the deferred "
                                 "match table differs from the eager one")
    if not seen:
        raise AssertionError("no keyframe match was applied")
    return len(seen)


def phase_config4(frames, poses, table, plain_frame_ms, worker):
    """Window BA: `use_features` + `use_ba` synchronous against the run
    without BA (in a process of its own, `ProcessRuns`) and the CPU's
    (`worker`); then the pipelined loop with BA on and off."""
    with tempfile.TemporaryDirectory() as tmp:
        side = ProcessRuns(Path(tmp) / "side", "system", {"config4_without": None},
                           {"plane": frames.cpu()})
        try:
            return config4_runs(frames, poses, table, plain_frame_ms, worker, side)
        finally:
            side.stop()


def config4_runs(frames, poses, table, plain_frame_ms, worker, side):
    dev = frames.device
    t0 = time.perf_counter()
    with_ba = ba_system(dev, features=True)
    _, launches = counted(table, "the window-BA path", lambda: drive(with_ba, frames))
    card_s = time.perf_counter() - t0
    all_ok(with_ba, "config 4")
    stats = dict(with_ba.ba_stats)
    if stats["runs"] < 1 or stats["iters"] < 1 or with_ba._ba_inflight is not None:
        raise AssertionError(f"config 4: no window solve was retired: {stats}")
    without = RunRecord(side.result("config4_without")[0])
    ate, ate_without = live_ate(with_ba, poses), live_ate(without, poses)
    if not (ate <= 1.1 * ate_without and ate <= FEATURES_BA_ATE_MAX):
        raise AssertionError(f"config 4 ATE {ate} m, without BA {ate_without} m")
    moved = pose_gap(with_ba, without)
    if moved == 0.0:
        raise AssertionError("config 4: the window solves changed no pose")
    # Card against CPU on the first CONFIG4_CPU_FRAMES frames: a later solve
    # moves earlier keyframes, so the card runs that prefix again.
    n_cpu = CONFIG4_CPU_FRAMES
    prefix = ba_system(dev, features=True)
    drive(prefix, frames[:n_cpu])
    cpu, cpu_s = worker.result("config4")
    cpu = RunRecord(cpu)
    gap = pose_gap(prefix, cpu)
    runs_prefix = prefix.ba_stats["runs"]
    if not gap <= LIVE_T_ATOL or cpu.ba_stats["runs"] != runs_prefix or runs_prefix < 1:
        raise AssertionError(f"config 4 card vs CPU over {n_cpu} frames: poses {gap}, solves "
                             f"{runs_prefix} vs {cpu.ba_stats['runs']}")
    # The pipelined loop: keyframes carry features for relocalization, which
    # is all window BA needs; the frame itself is the plain megastep.
    pipe = ba_system(dev, features=False)
    seen = spy_keyframe_matches(pipe)
    _, ms_on = drive(pipe, frames, pipelined=True, events=True)
    all_ok(pipe, "pipelined loop with window BA")
    tables = check_match_tables(pipe, seen)
    if pipe.ba_stats["runs"] < 1 or not any(k[0] == "ba" for k in pipe._steps):
        raise AssertionError(f"pipelined loop: no captured window solve: {pipe.ba_stats}")
    ate_pipe = live_ate(pipe, poses)
    if not ate_pipe <= PIPE_BA_ATE_MAX:
        raise AssertionError(f"pipelined loop with window BA: ATE {ate_pipe} m")

    n_kf = sum(s.is_keyframe for s in pipe.trajectory)
    return {
        "launches": launches, "ba": stats, "ate": ate, "ate_without_ba": ate_without,
        "ba_moved_poses_by": moved, "card_vs_cpu": gap, "cpu_frames": n_cpu,
        "solves_cpu_frames": runs_prefix,
        "keyframes": [s.frame_id for s in with_ba.trajectory if s.is_keyframe],
        "card_s": round(card_s, 2), "cpu_s": round(cpu_s, 2),
        "pipelined": {
            "graph_replays": pipe.graph_replays, "ba": dict(pipe.ba_stats),
            "ate": ate_pipe, "frame_ms_ba_on": frame_summary(ms_on),
            "frame_ms_ba_off": frame_summary(plain_frame_ms),
            "match_tables_bit_equal_to_eager": tables,
            "retire_host_ms_per_keyframe": {k: 1e3 * pipe.retire_host_s[k] / n_kf
                                            for k in KEYFRAME_PARTS},
            "keyframes": n_kf,
        },
    }


def cli_front_end_argv(frames, poses, root: Path) -> dict:
    """Phase 18's CLI runs on the 8-bit dataset of phase 8 (written under
    `root`): {name: argv} for the flags of configs 2 and 4 and `--photo-ba`."""
    rgb, calib, gt = write_dataset(frames[:CLI_FRAMES], poses[:CLI_FRAMES], root)
    base = ["-d", str(rgb), "-c", str(calib), "--tum-gt", str(gt), "--levels", "3",
            "--track-levels", "1,0", "--mono-depth", "2.0", "--platform", "cuda"]
    return {name: base + extra + ["--trajectory-out", str(root / f"{name}.txt")]
            for name, extra in (("features_depth_bootstrap", ["--features", "--depth-bootstrap"]),
                                ("features_ba", ["--features", "--ba"]),
                                # Keyframes 0, 10, 20, 30: two photometric solves.
                                ("photo_ba", ["--photo-ba", "--kf-max-gap", "10"]))}


def cli_front_end_check(out: dict) -> dict:
    """Phase 18's runs (`_side_cli_front_end`): exit 0 (`run_cli`), ATE within
    CLI_ATE_MAX, and `--photo-ba`'s window solves reported."""
    for name, r in out.items():
        if not r["ate"] <= CLI_ATE_MAX:
            raise AssertionError(f"CLI {name}: ATE {r['ate']} m > {CLI_ATE_MAX} m")
    if not out["photo_ba"].get("ba_runs"):
        raise AssertionError("CLI photo_ba: no window solve reported")
    return out


# ------------------------------------------------ photometric window BA

def photo_window(dev):
    """PHOTO_KEYFRAMES views of the two-plane scene at the bench camera ->
    (the level-1 problem: 240 x 320 pyramids, 2048 top-K points per keyframe
    at their exact depths, off the depth seam; poses 1-9 perturbed and
    inverse depths with noise from numpy seed 0; the level's camera; the
    true camera-from-world poses)."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.ba.photometric import photo_ba_problem_from_keyframes
    from uwslam_tpu_torch.image.pyramid import build_pyramid
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.points import topk_gradient_points
    from uwslam_tpu_torch.utils.synthetic import render_two_plane_view, two_plane_depth

    cam = bench.CAM
    rng = np.random.default_rng(0)
    k = torch.arange(PHOTO_KEYFRAMES, dtype=torch.float32, device=dev)[:, None]
    T_gt = se3.exp(k * torch.tensor(PHOTO_STEP, device=dev))
    pyrs, pts = [], []
    for T in T_gt:
        pyr = build_pyramid(render_two_plane_view(cam, T), levels=3)
        p = topk_gradient_points(pyr.images[0], pyr.grad_mag[0], cam, num_points=bench.NUM_POINTS)
        depth = two_plane_depth(cam, T)
        z = depth[p.uv[0, :, 1].long(), p.uv[0, :, 0].long()]
        x_w = se3.apply(se3.inverse(T), cam.unproject(p.uv[0], z))[:, 0]
        ok = p.valid[0] & (z > 0.1) & (x_w.abs() > 0.25)
        pyrs.append(pyr)
        pts.append(p._replace(p3d=cam.unproject(p.uv, z[None]), valid=ok[None]))
    noise = rng.normal(scale=PHOTO_POSE_NOISE, size=(PHOTO_KEYFRAMES, 6)).astype(np.float32)
    noise[0] = 0.0
    T_init = se3.compose(se3.exp(torch.from_numpy(noise).to(dev)), T_gt)
    prob = photo_ba_problem_from_keyframes(pyrs, T_init, pts, level=1)
    scale = 1.0 + rng.normal(scale=PHOTO_DEPTH_NOISE, size=tuple(prob.inv_depth.shape))
    return (prob._replace(inv_depth=prob.inv_depth * torch.from_numpy(
        scale.astype(np.float32)).to(dev)), cam.scaled(1), T_gt)


def bound_touched(ok, uv, hw, texel_bytes: int, C: int) -> dict:
    """K3 where many points share taps: each distinct texel (or pixel) the
    valid points' four taps touch, read once, plus each point's uv (8 B) and
    validity (1 B) and its C samples, written once."""
    H, W = hw
    B, N = ok.shape
    u0 = torch.floor(uv[..., 0]).clamp(0, W - 2).long()
    v0 = torch.floor(uv[..., 1]).clamp(0, H - 2).long()
    base = (torch.arange(B, device=uv.device)[:, None] * (H * W) + v0 * W + u0)[ok]
    taps = torch.cat([base, base + 1, base + W, base + W + 1])
    n_touched = int(torch.unique(taps).numel())
    n_ok = int(ok.sum())
    return {**bound(n_touched * texel_bytes + B * N * (8 + 1 + 4 * C),
                    n_ok * (TAPS_FLOPS + BLEND_FLOPS * C)),
            "texels_touched": n_touched}


def photo_system(device):
    """Configuration 1 at the bench design point with photometric window BA
    (`--photo-ba`: `use_ba` and `ba.photometric`)."""
    from dataclasses import replace

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.config import BAConfig
    from uwslam_tpu_torch.system import SlamSystem

    config = replace(live_config(), use_ba=True, ba=BAConfig(photometric=True))
    calib = Calibration(raw=bench.CAM, out_width=bench.CAM.width, out_height=bench.CAM.height)
    return SlamSystem(calib, config, device=device)


def phase_photo_ba(frames, poses, table, window, worker):
    """K3 at the photometric solve's shapes against its plain version; the
    window solve (`window`: `photo_window`'s) eager and as a graph, against
    the CPU's (`worker`); the 96 bench frames with photometric window BA,
    synchronous and pipelined."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.ba import photometric as pba
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.ops.graph import CapturedStep, tree_clone

    dev = frames.device
    prob, cam, T_gt = window
    texels = pba.photo_texels(prob)
    uv = pba._project(prob, cam)[-1].contiguous()
    ref_img = prob.images[:, None].contiguous()
    k = ops.cuda_bilinear_sample(texels, uv, texels=True)
    err = compare(k, ops.bilinear_sample_texels_plain(texels, uv), SAMPLE_ATOL,
                  "bilinear_sample at the photometric shape")
    k1 = ops.cuda_bilinear_sample(ref_img, prob.uv)
    err_ref = compare(k1, ops.bilinear_sample_plain(ref_img, prob.uv), SAMPLE_ATOL,
                      "bilinear_sample for the reference intensity (C = 1)")
    planes = ops.unpack_texels(texels).contiguous()
    grid_err = max(check_grid_sample(k, planes, uv, "photometric shape"),
                   check_grid_sample(k1, ref_img, prob.uv, "photometric reference intensity"))
    hw = tuple(prob.images.shape[-2:])
    times = time_pairs(
        {"photo": (lambda: ops.cuda_bilinear_sample(texels, uv, texels=True),
                   lambda: ops.bilinear_sample_texels_plain(texels, uv)),
         "photo_ref": (lambda: ops.cuda_bilinear_sample(ref_img, prob.uv),
                       lambda: ops.bilinear_sample_plain(ref_img, prob.uv))},
        {"photo": bound_touched(k[1], uv, hw, 16, 3),
         "photo_ref": bound_touched(k1[1], prob.uv, hw, 4, 1)},
        {"photo": grid_sample_call(planes, uv), "photo_ref": grid_sample_call(ref_img, prob.uv)},
    )

    solve = photo_solve(cam)

    def gap(T_a, T_b) -> float:
        return float(se3.log(se3.compose(T_a, se3.inverse(T_b))).abs().max())

    before = ops.cuda_bilinear_sample.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = solve(*prob)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    per_solve = ops.cuda_bilinear_sample.launches - before
    if per_solve != 2 * PHOTO_MAX_ITERS + 1:
        raise AssertionError(f"a photometric solve launched K3 {per_solve} times, not "
                             f"{2 * PHOTO_MAX_ITERS + 1}")
    t0 = time.perf_counter()
    step = CapturedStep(solve, tuple(prob))
    capture_s = time.perf_counter() - t0
    first = tree_clone(step(*prob))
    second = step(*prob)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two replays of the captured photometric solve differ")
    if not all(torch.equal(a, b) for a, b in zip(first, eager)):
        raise AssertionError("the captured photometric solve differs from the eager one")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    step(*prob)
    end.record()
    replay_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end)
    busy_ms, kernels = profile_once(lambda: step(*prob))
    (cpu, cpu_s, by_threads), _ = worker.result("photo_solve")
    on_cpu = pba.PhotoBAProblem(*(t.cpu() for t in prob))
    with cpu_run():
        at_card = on_cpu._replace(T_cw=first[0].cpu(), inv_depth=first[1].cpu())
        c_at_card = float(pba._cost(*pba._observations(at_card, cam, jacobians=False),
                                    12.0))                  # the solve's default Huber delta
    c0, c, c_cpu = float(first[3]), float(first[2]), float(cpu[2])
    solve_gap = gap(first[0].cpu(), cpu[0])
    if not (c < c0 and abs(c - c_at_card) <= PHOTO_COST_RTOL * c_at_card
            and abs(c - c_cpu) <= PHOTO_SOLVE_COST_RTOL * c_cpu and solve_gap <= BA_POSE_ATOL):
        raise AssertionError(f"photometric solve: cost {c0} -> {c} (the CPU's at this state "
                             f"{c_at_card}, its own solve {c_cpu}), poses card vs CPU {solve_gap}")
    solve_out = {
        "keyframes": PHOTO_KEYFRAMES, "points": int(prob.valid.sum()),
        "observations_valid": int(k[1].sum()), "iterations": int(first[4]),
        "iterations_cpu": int(cpu[4]), "lm_passes_executed": PHOTO_MAX_ITERS,
        "k3_launches_per_solve": per_solve, "cost": [c0, c], "cost_cpu": c_cpu,
        "cost_cpu_at_card_state": c_at_card, "cost_cpu_by_threads": by_threads,
        "card_vs_cpu": solve_gap, "pose_error": [gap(prob.T_cw, T_gt), gap(first[0], T_gt)],
        "two_replays_bit_equal": True, "replay_equals_eager": True,
        "eager_ms": eager_ms, "capture_s": round(capture_s, 2), "replay_ms": replay_ms,
        "replay_host_ms": replay_host_ms, "replay_device_busy_ms": busy_ms,
        "replay_kernels": kernels,
        "replay_idle_share": None if busy_ms is None else 1.0 - busy_ms / replay_ms,
        "cpu_s": round(cpu_s, 2),
    }
    del step, first, second, eager

    # The 96 bench frames: synchronous (counted), pipelined, the CPU's prefix.
    t0 = time.perf_counter()
    sync = photo_system(dev)
    _, launches = counted(table, "the photometric BA path", lambda: drive(sync, frames))
    sync_s = time.perf_counter() - t0
    all_ok(sync, "photometric BA, synchronous")
    pipe = photo_system(dev)
    _, ms = drive(pipe, frames, pipelined=True, events=True)
    all_ok(pipe, "photometric BA, pipelined")
    kfs = [[s.frame_id for s in x.trajectory if s.is_keyframe] for x in (sync, pipe)]
    runs = (sync.ba_stats["runs"], pipe.ba_stats["runs"])
    ate_sync, ate_pipe = live_ate(sync, poses), live_ate(pipe, poses)
    bars = (PHOTO_ATE_RATIO * JAX_PHOTO_ATE, PHOTO_ATE_RATIO * JAX_PHOTO_ATE_PIPELINED)
    if kfs[0] != kfs[1] or runs[0] < 1 or runs[0] != runs[1]:
        raise AssertionError(f"photometric BA: keyframes {kfs}, solves {runs}")
    pipe_gap = pose_gap(sync, pipe)
    if not (pipe_gap <= PHOTO_PIPE_T_ATOL and abs(ate_sync - ate_pipe) <= PHOTO_PIPE_ATE_GAP
            and ate_sync <= bars[0] and ate_pipe <= bars[1]):
        raise AssertionError(f"photometric BA: ATE {ate_sync} m synchronous, {ate_pipe} m "
                             f"pipelined, bars {bars} m; the loops' poses differ by {pipe_gap}")
    cpu_sys, cpu_s = worker.result("photo_ba")
    cpu_sys = RunRecord(cpu_sys)
    if cpu_sys.ba_stats["runs"] != runs[0]:
        raise AssertionError(f"the CPU ran {cpu_sys.ba_stats} solves, the card {runs[0]}")
    dev_cpu = card_vs_cpu(sync.trajectory, cpu_sys.trajectory, "photometric BA")
    return {
        "k3": {"max_abs_err": max(err, err_ref), "texels_err": err, "reference_err": err_ref,
               "vs_grid_sample": grid_err},
        "solve": solve_out,
        "live": {"launches": launches, "ate": ate_sync, "ate_pipelined": ate_pipe,
                 "ate_bars": bars, "jax_cpu_ate": [JAX_PHOTO_ATE, JAX_PHOTO_ATE_PIPELINED],
                 "keyframes": kfs[0],
                 "ba": dict(sync.ba_stats), "ba_pipelined": dict(pipe.ba_stats),
                 "pipelined_vs_synchronous": pipe_gap,
                 "card_vs_cpu": dev_cpu, "cpu_frames": len(cpu_sys.trajectory),
                 "frame_ms_pipelined": frame_summary(ms),
                 "graph_replays": pipe.graph_replays, "sync_s": round(sync_s, 2),
                 "cpu_s": round(cpu_s, 2)},
    }, times


# -------------------------------- configs 5-7: loop closure and global BA

# Configs 5, 6 and 7 add --loop-closure and --dist-ba, --loop-closure,
# --dist-ba to eval.py:439-447's long-sequence flags (`eval.LONG_FLAGS`).
CONFIG_FLAGS = {5: ["--loop-closure", "--dist-ba"], 6: ["--loop-closure"], 7: ["--dist-ba"]}
QUICK_FRAMES, QUICK_LOOP_PERIOD = 80, 56       # eval.py --quick
# The port's CPU run of config 5 takes all the quick frames: on eval.py's draw
# rendered on the card its first loop edge comes after frame 64 (0 edges over
# 64 frames, 1 over 80; 89.5 and 120.9 s at 4 threads on a shared host). It
# runs beside the card's runs, in a process of its own.
QUICK_CPU_FRAMES = QUICK_FRAMES
FULL_FRAMES, FULL_LOOP_PERIOD = 640, 160
# Phase 20(c) runs the full-size loop path (period 160) over its first 240
# frames, one lap and half of its revisit, to keep the script inside its time
# limit: config 5 over all 640 frames on the card is in RESULTS_TORCH_r09.json
# (`python -m uwslam_tpu_torch.eval`).
PHASE20_LONG_FRAMES = 240
TUM_LONG_SEED = 4                              # eval.py's tum_long noise seed
# The JAX CLI's CPU runs of configs 5 and 6 on the card's render of these
# sequences (EVAL_FRAMES_DIGEST; `scripts/jax_config5_spread.py` under
# `UWSLAM_EVAL_DATA` holding that render), ATE m, Sim(3)-aligned, under XLA's
# default code (and AVX2 on the quick sequence). Config 5's bar on each
# sequence is CONFIG5_ATE_RATIO x the largest of its runs there.
JAX_QUICK_FRAMES_ATE = {5: {"default": 0.20690939, "AVX2": 0.16237608},
                        6: {"default": 0.15983418, "AVX2": 0.17842669}}
JAX_LONG_FRAMES_ATE = {5: {"default": 0.22704895}}
CONFIG5_ATE_RATIO = 1.25
CONFIG5_QUICK_ATE_MAX = CONFIG5_ATE_RATIO * max(JAX_QUICK_FRAMES_ATE[5].values())
CONFIG5_LONG_ATE_MAX = CONFIG5_ATE_RATIO * max(JAX_LONG_FRAMES_ATE[5].values())
# Card against the port's CPU run over the CPU's frames (poses and
# keyframes): REPORTED, not asserted. On this path last-bit differences
# decide keyframes, loop edges and the monocular scale the Sim(3) pose graph
# settles on, in the JAX package as in the port: the JAX CLI's runs of
# eval.py's own quick frames under XLA's default, AVX2, AVX and SSE4_2 code
# give config 5 ATE 0.072 to 0.174 m, 14 to 16 keyframes, 0 to 3 loop edges
# (`scripts/jax_config5_spread.py`; ROADMAP section 3). Each run is held to
# eval.py's health checks and the ATE bar.
CPU_RUN_THREADS = 4      # the port's CPU run of config 5, beside the card's runs
RUN_TIMEOUT_S = 600     # a run in a process of its own (`ProcessRuns`)
DIST_TRUTH_ATOL = 5e-3                         # tests/test_parallel.py:99-110
RIGID_ATOL = 1e-4                              # a keyframe pose's R^T R against I

# Phase 21: the bench's chunk tracked over 8 sequence shards in one process.
SEQ_SHARDS = 8
SEQ_MAX_ITERS = 10
SHARDED_T_ATOL = 1e-6    # se3.log, the sharded batched call against the unsharded one
# The JAX package's CPU run of the same call, sequential chunks, FC
# (scripts/jax_sharded_reference.py, 8 virtual CPU devices): 0.00087297 m.
JAX_SHARDED_FC_ATE = 0.00087297
SHARDED_ATE_RATIO = 1.25
# Phase 22: phase 19's window solved with its observers over 1, 2 and 5
# shards; tests/test_photometric_ba.py:240-243's bar for a sharded solve
# against the single-device one.
PHOTO_SHARD_COUNTS = (1, 2, 5)
PHOTO_SHARD_RTOL, PHOTO_SHARD_ATOL = 1e-3, 1e-4
PHOTO_COST_DROP = 0.2    # final cost below this share of the initial one
# Phase 23: the 96 bench frames through the CLI, stopped by --checkpoint
# after SESSION_SPLIT frames and continued by --resume.
SESSION_SPLIT = 48
SESSION_T_ATOL = 1e-5    # the resumed run's first rows against the uninterrupted run's
# The JAX package's CLI on its own 8-bit render of the same frames, split
# the same way (scripts/jax_resume_reference.py): 0.0268 m joined, 0.0284 m
# uninterrupted.
JAX_RESUME_ATE = 0.0268
RESUME_ATE_RATIO = 1.25
SESSION_SHORT_FRAMES = 16   # the --map-out, --trace and --viz-port runs
ENTRY_T_ATOL = 1e-4      # se3.log, entry() on the card against the CPU
# Phase 24: eval.py's configs that run on one device, at full size (150 TUM
# frames of 640 x 480; 120 EUROC frames of 752 x 480 rectified to 736 x 480),
# rendered on the card by `uwslam_tpu_torch.eval` and run through the CLI.
EVAL_CONFIGS = (0, 1, 2, 3, 4, 8, 9, 10)
AFFINE_CONFIGS = (2, 3)   # eval.py's configs with --affine (and Huber weights)
EVAL_TUM_FRAMES, EVAL_EUROC_FRAMES = 150, 120
# The sequences phases 24 and 20 render on the card, under eval.py's names
# (`render_eval_dataset`; `python scripts/chip_phases.py frames DIR` writes them).
EVAL_DATASETS = (f"tum_seq01_{EVAL_TUM_FRAMES}", f"euroc_mh01_{EVAL_EUROC_FRAMES}",
                 f"euroc_v101_{EVAL_EUROC_FRAMES}", f"tum_long_{QUICK_FRAMES}",
                 f"tum_long_{PHASE20_LONG_FRAMES}")
# The card's render of each sequence, the same in every run (two H100 80GB
# HBM3 machines gave the same digests): `frames_digest` of what
# `render_eval_dataset` writes. The JAX figures below were measured on these
# very frames; a phase whose render differs stops, since they would not apply.
EVAL_FRAMES_DIGEST = {
    f"tum_seq01_{EVAL_TUM_FRAMES}": "3c0658136832beb1",
    f"euroc_mh01_{EVAL_EUROC_FRAMES}": "70530ed21eb4a5b8",
    f"euroc_v101_{EVAL_EUROC_FRAMES}": "355c2329b8ce719f",
    f"tum_long_{QUICK_FRAMES}": "bb8d9187db7d7af4",
    f"tum_long_{PHASE20_LONG_FRAMES}": "cb903193ddc696a3"}
# The JAX CLI's CPU runs of phase 24's configs on the card's render
# (`python scripts/chip_phases.py frames DIR` on the card, then
# `UWSLAM_EVAL_DATA=DIR python scripts/jax_eval_reference.py` here), ATE m as
# the CLI prints it, under XLA's default code and, for the configs with the
# depth bootstrap, AVX2, AVX and SSE4_2 as well. Without the bootstrap the
# card lands within 5% of the JAX run (0.95-1.01x); it is held to
# EVAL_ATE_RATIO x that run. With it the monocular scale comes from the
# first pair's RANSAC, whose samples the port draws from its own generator
# (the JAX package from jax.random), so the same frames do not pin the two:
# on config 3 the JAX runs read 0.1393-0.1522 m, the port's CPU 0.1096 m and
# the card 0.0832 m. Those configs are held to EVAL_ATE_RATIO x the largest of
# the JAX runs of the same frames and of the JAX CLI's runs over eval.py's
# own draw and three more (JAX_DRAWS_ATE). A health check of eval.py is
# asserted when every JAX run of the same frames passes it, and printed
# beside their figures when one fails it too.
JAX_CARD_FRAMES_ATE = {
    0: {"default": 0.16}, 1: {"default": 0.0468},
    2: {"default": 0.0471, "AVX2": 0.0441, "AVX": 0.0470, "SSE4_2": 0.0605},
    3: {"default": 0.1435, "AVX2": 0.1522, "AVX": 0.1403, "SSE4_2": 0.1393},
    4: {"default": 0.0743, "AVX2": 0.0652, "AVX": 0.0890, "SSE4_2": 0.0655},
    8: {"default": 0.0628}, 9: {"default": 0.0572},
    10: {"default": 0.0737, "AVX2": 0.0634, "AVX": 0.0852, "SSE4_2": 0.0666}}
JAX_ISAS = ("default", "AVX2", "AVX", "SSE4_2")
# The JAX CLI's CPU runs (XLA's default code) of the bootstrap configs on
# eval.py's own render and with every noise seed moved by 10, 20 and 30
# (`scripts/jax_eval_reference.py [--seed-offset K]`).
JAX_DRAWS_ATE = {2: (0.0638, 0.0490, 0.0628, 0.0554), 3: (0.0619, 0.0730, 0.0885, 0.0839),
                 4: (0.0950, 0.0813, 0.0862, 0.0770), 10: (0.0946, 0.0792, 0.0832, 0.0763)}
EVAL_ATE_RATIO = 1.25
EVAL_ATE_MAX = {c: EVAL_ATE_RATIO * max([*runs.values(), *JAX_DRAWS_ATE.get(c, ())])
                for c, runs in JAX_CARD_FRAMES_ATE.items()}


def jax_tables(figures: dict[int, dict[str, float]]) -> list[dict]:
    """One results table of eval.py's shape per instruction set of the JAX
    runs in `figures` (a config measured under the default code alone
    stands in every table)."""
    return [{str(c): {"rc": 0, "ate_rmse_m": runs.get(isa, runs["default"])}
             for c, runs in figures.items()} for isa in JAX_ISAS]


def check_digest(root: Path, name: str) -> str:
    got = frames_digest(root)
    if got != EVAL_FRAMES_DIGEST[name]:
        raise AssertionError(f"the card's render of {name} is not the one the JAX figures were "
                             f"measured on: digest {got}, not {EVAL_FRAMES_DIGEST[name]}")
    return got


def write_tum_sequence(root: Path, n: int, loop_period: int, dev) -> list[str]:
    """eval.py's `tum_long` sequence (`uwslam_tpu_torch.eval.make_tum_dataset`,
    eval.py's seed 4) rendered on `dev`: the tum scene along the loop path,
    640 x 480 at fx = fy = 525, gain and bias drift, sensor noise of sigma
    1.5, 8-bit PNG files, TUM ground truth and calibration -> the CLI's data
    arguments."""
    from uwslam_tpu_torch import eval as ev

    ds = ev.make_tum_dataset(str(root), n, seed=TUM_LONG_SEED, loop_period=loop_period,
                             device=dev)
    return ["-d", ds["rgb"], "-c", ds["calib"], "--tum-gt", ds["gt"]]


def render_eval_dataset(root: Path, name: str, dev) -> dict:
    """One of EVAL_DATASETS rendered on `dev` under root / name, as phases 20
    and 24 render it -> the maker's dataset dict."""
    from uwslam_tpu_torch import eval as ev

    path = str(root / name)
    if name == f"tum_seq01_{EVAL_TUM_FRAMES}":
        return ev.make_tum_dataset(path, EVAL_TUM_FRAMES, device=dev)
    if name == f"euroc_mh01_{EVAL_EUROC_FRAMES}":
        return ev.make_euroc_dataset(path, EVAL_EUROC_FRAMES, kind="euroc_mh", device=dev)
    if name == f"euroc_v101_{EVAL_EUROC_FRAMES}":
        return ev.make_euroc_dataset(path, EVAL_EUROC_FRAMES, kind="euroc_v1", seed=2,
                                     device=dev)
    for n, period in ((QUICK_FRAMES, QUICK_LOOP_PERIOD), (PHASE20_LONG_FRAMES, FULL_LOOP_PERIOD),
                      (FULL_FRAMES, FULL_LOOP_PERIOD)):
        if name == f"tum_long_{n}":
            return ev.make_tum_dataset(path, n, seed=TUM_LONG_SEED, loop_period=period,
                                       device=dev)
    raise ValueError(f"no dataset {name}; the datasets are {EVAL_DATASETS}")


def frames_digest(root: Path) -> str:
    """The first 16 hex digits of a SHA-256 over a dataset's PNG files (their
    paths below `root` and their bytes, in sorted order): which frames a run
    read."""
    h = hashlib.sha256()
    for f in sorted(root.rglob("*.png")):
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def run_loop_config(data_args, config: int, platform: str, table=None,
                    retire_at_once: bool = False, max_frames: int | None = None) -> dict:
    """README config 5, 6 or 7 through the port's CLI in this process, with
    the SlamSystem it builds kept for inspection: ATE, keyframes, loop edges,
    the global BA's line, host time per pipelined frame call, loop closure's
    host time, the exported poses and (with `table`) the kernels' launches
    over the run (counts set to 0 just before). With `retire_at_once` the
    window solves are retired at their dispatch (`ba.asynchronous` off): by
    default a solve lands at the first frame that finds it finished, which
    depends on timing on the card (and is at the next frame on the CPU)."""
    from dataclasses import replace

    from uwslam_tpu_torch import eval as ev
    from uwslam_tpu_torch import system as port_system
    from uwslam_tpu_torch.cli.main import main as cli_main

    made = []

    class Recorded(port_system.SlamSystem):
        def __init__(self, calibration, config, device):
            if retire_at_once:
                config = replace(config, ba=replace(config.ba, asynchronous=False))
            super().__init__(calibration, config, device=device)
            self.frame_marks = []
            made.append(self)

        def process_frame_async(self, *args, **kw):
            out = super().process_frame_async(*args, **kw)
            self.frame_marks.append(time.perf_counter())
            return out

        def run_global_distributed_ba(self, *args, **kw):
            self.global_stats = super().run_global_distributed_ba(*args, **kw)
            return self.global_stats

    argv = data_args + ev.LONG_FLAGS + CONFIG_FLAGS[config] + ["--platform", platform]
    if max_frames is not None:
        argv += ["--max-frames", str(max_frames)]
    buf, err = io.StringIO(), io.StringIO()
    original = port_system.SlamSystem
    port_system.SlamSystem = Recorded
    if table is not None:
        for k in table:
            k["wrapper"].launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
    finally:
        port_system.SlamSystem = original
    if platform == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text, log = buf.getvalue(), err.getvalue()
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+naif-]+) m over (\d+)", text)
    if rc != 0 or m is None or len(made) != 1:
        raise AssertionError(f"config {config} on {platform}: exit {rc}, {text!r} {log[-3000:]!r}")
    system = made[0]
    out = {"ate": float(m.group(1)), "poses_in_ate": int(m.group(2)), "s": round(wall, 1),
           "keyframe_poses_finite": all(np.isfinite(T).all() for T in system._kf_poses.values()),
           "keyframe_poses_rigid": all(rigid_pose(T) for T in system._kf_poses.values()),
           "keyframes": [s.frame_id for s in system.trajectory if s.is_keyframe],
           "statuses": sorted({s.status for s in system.trajectory}),
           "loop_stats": dict(system.loop_stats), "window_ba_runs": system.ba_stats["runs"]}
    loop = ev.LOOP_RE.search(log)
    if config in (5, 6):
        if loop is None:
            raise AssertionError(f"config {config}: no loop-closure line in {log[-2000:]!r}")
        out["loop_edges"] = int(loop.group(1))
    if config in (5, 7):
        d = ev.DBA_RE.search(log)
        if d is None:
            raise AssertionError(f"config {config}: no global-BA line in {log[-2000:]!r}")
        out["dist_ba"] = {"keyframes": int(d.group(1)), "landmarks": int(d.group(2)),
                          "observations": int(d.group(3)), "shards": int(d.group(4)),
                          "iterations": int(d.group(5)), "seconds": float(d.group(6)),
                          "ba_iters_per_sec": float(d.group(7)),
                          "cost": [float(d.group(8)), float(d.group(9))],
                          "applied": d.group(10) is None}
    marks = system.frame_marks
    if len(marks) > LIVE_WARMUP + 2:
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])][LIVE_WARMUP:]
        out["frame_ms"] = {"median": statistics.median(ms), "p90": float(np.percentile(ms, 90)),
                           "max": max(ms), "mean": statistics.mean(ms)}
        out["frames_per_s"] = 1e3 / statistics.mean(ms)
    ls, host_s = system.loop_stats, system.retire_host_s
    if ls["keyframes"]:
        detect_s, pgo_s = host_s.get("loop_detect", 0.0), host_s.get("loop_pgo", 0.0)
        out["host_ms_per_keyframe"] = {
            "loop_detection": 1e3 * detect_s / ls["keyframes"],
            "pgo": 1e3 * pgo_s / ls["keyframes"],
            "pgo_per_solve": 1e3 * pgo_s / max(ls["pgo_runs"], 1)}
    if table is not None:
        out["launches"] = {k["name"]: k["wrapper"].launches for k in table}
    out["_poses"] = system.export_trajectory()[1]
    return out


def start_cpu_config5(root: Path, data_args) -> ProcessRuns:
    """The port's CPU run of config 5 (`_job_config5_quick`) in a process of
    its own at CPU_RUN_THREADS threads, so that it runs while the card's runs
    do."""
    return ProcessRuns(root, "cpu", {"config5_quick": None}, {"quick": data_args},
                       threads=CPU_RUN_THREADS)


def health_checks(config: int, r: dict) -> None:
    """eval.py:597-616's checks that apply to one config's run
    (`uwslam_tpu_torch.eval.health_checks` on a table of this run alone), a
    finite ATE, and every keyframe pose finite and rigid."""
    from uwslam_tpu_torch import eval as ev

    row = {"rc": 0, "ate_rmse_m": r["ate"]}
    if "loop_edges" in r:
        row["loop_edges"] = r["loop_edges"]
    if "dist_ba" in r:
        row.update(dist_ba_obs=r["dist_ba"]["observations"],
                   dist_ba_applied=r["dist_ba"]["applied"])
    with contextlib.redirect_stdout(io.StringIO()):
        failed = ev.health_checks({str(config): row}, quick=True)
    if failed:
        raise AssertionError("; ".join(failed))
    if not np.isfinite(r["ate"]):
        raise AssertionError(f"config {config}: ATE {r['ate']}")
    # The export falls back to the live poses where a keyframe's is not
    # finite, which would hide a map the global BA destroyed.
    if not r["keyframe_poses_finite"]:
        raise AssertionError(f"config {config}: keyframe poses not finite after the run")
    if not r["keyframe_poses_rigid"]:
        raise AssertionError(f"config {config}: a keyframe pose is off SO(3) by more than "
                             f"{RIGID_ATOL} after the run")


def rigid_pose(T) -> bool:
    """A finite rigid motion: R^T R within RIGID_ATOL of I, last row 0 0 0 1.
    Host-side products of corrections once drifted off SO(3) until a
    keyframe pose was singular."""
    T = np.asarray(T, np.float64)
    return bool(np.isfinite(T).all()
                and np.abs(T[:3, :3].T @ T[:3, :3] - np.eye(3)).max() <= RIGID_ATOL
                and np.allclose(T[3], [0, 0, 0, 1], atol=RIGID_ATOL))


def loop_pose_gap(a, b) -> float:
    from uwslam_tpu_torch.lie import se3

    return float((se3.log(torch.from_numpy(a)) - se3.log(torch.from_numpy(b))).abs().max())


def dist_ba_problem(dev, seed: int = 1, num_kf: int = 4, num_lm: int = 96):
    """tests/test_parallel.py's problem, drawn with numpy: 4 keyframes x 96
    landmarks, every landmark in every keyframe, poses perturbed by 0.02 and
    points by 0.05 -> (BAProblem, true T_cw)."""
    from uwslam_tpu_torch.ba.schur import BAProblem
    from uwslam_tpu_torch.camera import PinholeCamera
    from uwslam_tpu_torch.lie import se3

    cam = PinholeCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, num_lm), rng.uniform(-1.0, 1.0, num_lm),
                    rng.uniform(3.0, 6.0, num_lm)], -1).astype(np.float32)
    T_gt = se3.exp(torch.tensor([[0.08 * i, 0.01 * i, 0.0, 0.0, 0.005 * i, 0.0]
                                 for i in range(num_kf)], dtype=torch.float32))
    kf = np.repeat(np.arange(num_kf), num_lm).astype(np.int32)
    lm = np.tile(np.arange(num_lm), num_kf).astype(np.int32)
    uv = cam.project(se3.apply(T_gt[kf], torch.from_numpy(pts)[lm]))
    dT = 0.02 * rng.standard_normal((num_kf, 6)).astype(np.float32)
    dT[0] = 0.0
    T0 = se3.compose(se3.exp(torch.from_numpy(dT)), T_gt)
    pts0 = pts + 0.05 * rng.standard_normal(pts.shape).astype(np.float32)
    problem = BAProblem(T_cw=T0, points=torch.from_numpy(pts0), obs_kf=torch.from_numpy(kf),
                        obs_lm=torch.from_numpy(lm), obs_uv=uv,
                        obs_valid=torch.ones(kf.shape[0], dtype=torch.bool))
    return BAProblem(*(x.to(dev) for x in problem)), T_gt.to(dev), cam


def phase_dist_ba(dev) -> dict:
    """The landmark-sharded solve with 8 shards against `ba.schur`'s
    `bundle_adjust` on the card for the same problem: both within
    DIST_TRUTH_ATOL of the true poses (tests/test_parallel.py's bound), two
    sharded solves bit-equal, direct and pcg."""
    from uwslam_tpu_torch.ba.schur import bundle_adjust
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.parallel import distributed_bundle_adjust, landmark_layout, \
        shard_problem

    problem, T_gt, cam = dist_ba_problem(dev)

    def err(T):
        return float(se3.log(se3.compose(se3.inverse(T_gt), T)).norm(dim=-1).max())

    single = bundle_adjust(problem, cam, max_iters=15, trim_px=None)
    sharded = shard_problem(problem, 8)
    out = {"single_pose_err": err(single.T_cw)}
    for solver in ("direct", "pcg"):
        first = distributed_bundle_adjust(sharded, cam, landmark_layout(8), max_iters=15,
                                          solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second = distributed_bundle_adjust(sharded, cam, landmark_layout(8), max_iters=15,
                                           solver=solver)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"two sharded {solver} solves differ")
        out[solver] = {"pose_err": err(first.T_cw), "iterations": int(first.iterations),
                       "cost": [float(first.initial_cost), float(first.cost)],
                       "ms_per_solve": 1e3 * dt}
        if not out[solver]["pose_err"] < DIST_TRUTH_ATOL:
            raise AssertionError(f"sharded {solver} solve {out[solver]['pose_err']} from the truth")
    if not out["single_pose_err"] < DIST_TRUTH_ATOL:
        raise AssertionError(f"bundle_adjust {out['single_pose_err']} from the truth")
    return out


def strip_poses(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "_poses"}


def card_loop_configs(tmp, quick, dev, table) -> dict:
    """Phase 20's runs on the card: (a) config 5 twice at the quick size with
    the window solves retired at once, bit-equal; (b) configs 6 and 7 the
    same way, under their health checks, and config 5's ATE against config
    6's (`global_ba_check`); (c) config 5 at the full-size path's first
    PHASE20_LONG_FRAMES frames as the CLI runs it, its health checks, ATE
    bar and kernels; (d) the sharded solve and the pose graph."""
    # Configs 6 and 7 in a process of their own while this one runs config 5
    # twice (all retire their solves at once: the same bits beside any load).
    side = ProcessRuns(Path(tmp) / "loop_side", "loop", {c: quick for c in (6, 7)})
    try:
        full = write_tum_sequence(Path(tmp) / "full", PHASE20_LONG_FRAMES, FULL_LOOP_PERIOD,
                                  dev)
        check_digest(Path(tmp) / "full", f"tum_long_{PHASE20_LONG_FRAMES}")
        a, again = (run_loop_config(quick, 5, "cuda", retire_at_once=True) for _ in range(2))
        quick67 = {c: side.result(c)[0] for c in (6, 7)}
    finally:
        side.stop()
    if not (np.array_equal(a["_poses"], again["_poses"])
            and all(a[k] == again[k] for k in ("ate", "keyframes", "loop_edges"))
            and all(a["dist_ba"][k] == again["dist_ba"][k]
                    for k in ("landmarks", "observations", "iterations", "cost"))):
        raise AssertionError("two card runs of config 5 differ")
    health_checks(5, a)
    out = {"a_card": a}
    for config in (6, 7):
        r = quick67[config]
        health_checks(config, r)
        out[f"b_quick_config{config}"] = r
    out["b_global_ba_earns_its_place"] = global_ba_check(a, out["b_quick_config6"])
    r = run_loop_config(full, 5, "cuda", table)
    health_checks(5, r)
    if not r["ate"] <= CONFIG5_LONG_ATE_MAX:
        raise AssertionError(f"config 5, {PHASE20_LONG_FRAMES} frames: ATE {r['ate']} m > "
                             f"{CONFIG5_LONG_ATE_MAX} m")
    r["ate_bar"], r["jax_cpu_ate"] = CONFIG5_LONG_ATE_MAX, JAX_LONG_FRAMES_ATE[5]
    missing = [n for n in ("pyramid", "lm_evaluate", "bilinear_sample") if not r["launches"][n]]
    if missing:
        raise AssertionError(f"kernels not launched on the config-5 path: {missing}")
    out["c_full_config5"] = strip_poses(r)
    out["d_dist_ba"] = phase_dist_ba(dev)
    out["d_pose_graph"] = phase_pose_graph(dev)
    return out


def global_ba_check(a5, a6) -> dict:
    """eval.py:608-614's check that the global BA earns its place (config 5's
    ATE below config 6's, which lacks only the global BA) on the card's
    render of eval.py's quick sequence: asserted when every JAX CLI run of
    the same frames passes it, printed beside their figures when one fails
    it too. On this render the JAX CLI under XLA's default code reads config
    5 0.2069 m against config 6 0.1598 m (AVX2: 0.1624 against 0.1784 m),
    the card 0.2162 against 0.2147 m (H100 80GB HBM3, 700 W)."""
    jax = JAX_QUICK_FRAMES_ATE
    jax_fails = [isa for isa in jax[5] if not jax[5][isa] < jax[6][isa]]
    out = {"ate_config5": a5["ate"], "ate_config6": a6["ate"], "passed": a5["ate"] < a6["ate"],
           "jax_cpu_ate": jax, "failed_by_a_jax_cpu_run_too": jax_fails}
    if not out["passed"] and not jax_fails:
        raise AssertionError(f"config 5 ATE {a5['ate']} not better than config 6's {a6['ate']}, "
                             f"where every JAX CLI run of these frames passes: {jax}")
    return out


def phase_pose_graph(dev) -> dict:
    """A Sim(3) pose graph of the full run's size (128 nodes, 256 edges:
    the buckets of 123 keyframes and their loop edges), solved eagerly and
    with its LM pass as a captured graph (the loop closer's way): bit-equal
    poses, cost and iterations; ms per solve of both."""
    from uwslam_tpu_torch.ba import pose_graph as pg
    from uwslam_tpu_torch.lie import sim3

    M, E = 128, 256
    rng = np.random.default_rng(0)
    S = sim3.exp(torch.from_numpy((0.1 * rng.standard_normal((M, 7))).astype(np.float32)))
    ei = torch.arange(E, dtype=torch.int32) % (M - 1)
    ej = torch.where(torch.arange(E) < M - 1, ei + 1, torch.clamp(ei + 40, max=M - 1))
    noise = sim3.exp(torch.from_numpy((0.01 * rng.standard_normal((E, 7))).astype(np.float32)))
    S_ij = sim3.compose(sim3.compose(sim3.inverse(S[ei.long()]), S[ej.long()]), noise)
    graph = pg.Sim3PoseGraph(*(x.to(dev) for x in (
        S, ei, ej.to(torch.int32), S_ij, torch.full((E,), 100.0), torch.ones(E, dtype=torch.bool))))
    captured: dict = {}
    out = {}
    for name, kw in (("eager", {}), ("graph_first", {"captured": captured}),
                     ("graph", {"captured": captured})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pg.optimize_pose_graph_sim3(graph, **kw)
        iters = int(res.iterations)
        out[name] = {"ms": 1e3 * (time.perf_counter() - t0), "iterations": iters,
                     "cost": [float(res.initial_cost), float(res.cost)]}
        out[name + "_result"] = res
    if not all(torch.equal(a, b) for a, b in zip(out.pop("eager_result"), out["graph_result"])):
        raise AssertionError("the pose graph's captured pass differs from the eager one")
    if not all(torch.equal(a, b) for a, b in zip(out.pop("graph_first_result"),
                                                out.pop("graph_result"))):
        raise AssertionError("two replays of the pose graph differ")
    return out


def phase_loop_configs(table, root: Path) -> tuple[dict, tuple]:
    """Configs 5, 6 and 7 (phase 20) on the card, their sequences rendered
    under `root`, while the port's CPU run of config 5 at the quick size
    goes on in a process of its own -> (the card's results, the CPU run for
    `phase_loop_cpu`). The CPU run is read after the card's phases that
    follow (21-23), so that it runs beside their work too; whoever calls
    this stops it (`ProcessRuns.stop`) if it is still running when they fail."""
    dev = torch.device("cuda", 0)
    quick = write_tum_sequence(root / "quick", QUICK_FRAMES, QUICK_LOOP_PERIOD, dev)
    digest = check_digest(root / "quick", f"tum_long_{QUICK_FRAMES}")
    cpu_run5 = start_cpu_config5(root / "cpu_config5", quick)
    try:
        out = card_loop_configs(root, quick, dev, table)
        a = out.pop("a_card")
        if not a["ate"] <= CONFIG5_QUICK_ATE_MAX:
            raise AssertionError(f"config 5 quick, card: ATE {a['ate']} m > "
                                 f"{CONFIG5_QUICK_ATE_MAX} m")
    except BaseException:
        cpu_run5.stop()
        raise
    out["a_quick_config5"] = {"frames_digest": digest, "ate_bar": CONFIG5_QUICK_ATE_MAX,
                              "jax_cpu_ate": JAX_QUICK_FRAMES_ATE[5], "card": strip_poses(a)}
    return out, (cpu_run5, a["_poses"])


def phase_loop_cpu(loops: dict, cpu: tuple) -> dict:
    """Phase 20's CPU run of config 5 (`phase_loop_configs`), waited for
    once the card's phases beside it are done: eval.py's health checks and
    the ATE bar, and the card's run against it over the CPU's frames,
    reported (the comparisons config 2 is held to do not hold on this path:
    see the note below CPU_RUN_THREADS). Its result goes into `loops`."""
    cpu_run5, card_poses = cpu
    c, _ = cpu_run5.result("config5_quick")
    cpu_run5.stop()
    health_checks(5, c)
    if not c["ate"] <= CONFIG5_QUICK_ATE_MAX:
        raise AssertionError(f"config 5 quick, CPU: ATE {c['ate']} m > {CONFIG5_QUICK_ATE_MAX} m")
    quick = loops["a_quick_config5"]
    n = len(c["_poses"])
    quick.update({
        "cpu": strip_poses(c),
        "card_vs_cpu": {
            "cpu_frames": n,
            "pose_gap_cpu_frames": loop_pose_gap(card_poses[:n], c["_poses"]),
            "keyframes_equal_cpu_frames":
                [k for k in quick["card"]["keyframes"] if k < n] == c["keyframes"]}})
    return quick


def timed(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sequence_sharded(frames, poses, table) -> dict:
    """The bench's 96 frames (2048 points, 5 levels, track levels 3-0,
    max_iters 10) over SEQ_SHARDS sequence shards, batched IC against the
    unsharded `track_sequence_batched` (SHARDED_T_ATOL, inliers equal, ATE
    within ATE_MAX); launches, ms and frames/s. The sequential chunks in FC
    run in a process of their own beside phase 24 (`sharded_fc_check`)."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.parallel import landmark_layout, track_sequence_sharded
    from uwslam_tpu_torch.tracking.sequence import track_sequence_batched

    cam, layout = bench.CAM, landmark_layout(SEQ_SHARDS)
    kw = sharded_kw()
    pairs = frames.shape[0] - 1
    (sharded, _), launches_b = counted(table, "sequence-sharded tracking (batched, IC)", lambda: timed(
        lambda: track_sequence_sharded(frames, cam, layout, mode="ic", **kw)))
    _, s_b = timed(lambda: track_sequence_sharded(frames, cam, layout, mode="ic", **kw))
    whole, s_u = timed(lambda: track_sequence_batched(frames, cam, mode="ic", **kw))
    gap = float((se3.log(sharded[0]) - se3.log(whole[0])).abs().max())
    if not (gap <= SHARDED_T_ATOL and torch.equal(sharded[1], whole[1].to(sharded[1].dtype))):
        raise AssertionError(f"sharded batched tracking differs from the unsharded call: {gap}")
    ate_b = bench.trajectory_ate(sharded[0], poses)
    if not ate_b <= ATE_MAX:
        raise AssertionError(f"sharded batched tracking: ATE {ate_b} m > {ATE_MAX} m")
    return {
        "shards": SEQ_SHARDS, "pairs": pairs,
        "batched_ic": {"launches": launches_b, "vs_unsharded_se3_log": gap,
                       "bit_equal": all(torch.equal(a, b.to(a.dtype))
                                        for a, b in zip(sharded, whole)),
                       "ate": ate_b, "chunk_ms": 1e3 * s_b, "frames_per_s": pairs / s_b,
                       "unsharded_chunk_ms": 1e3 * s_u},
    }


def sharded_fc_check(seq: dict, poses) -> dict:
    """Phase 21's sequential FC chunks (`_side_sharded_fc`) against the JAX
    package's CPU run of the same call."""
    from uwslam_tpu_torch import bench

    ate = bench.trajectory_ate(seq["T"], poses.cpu())
    bar = SHARDED_ATE_RATIO * JAX_SHARDED_FC_ATE
    if not (ate <= bar and bool(torch.isfinite(seq["T"]).all())):
        raise AssertionError(f"sharded sequential tracking: ATE {ate} m > {bar} m")
    pairs = seq["T"].shape[0]
    return {"launches": seq["launches"], "ate": ate, "ate_bar": bar,
            "jax_cpu_ate": JAX_SHARDED_FC_ATE, "s": seq["s"], "frames_per_s": pairs / seq["s"],
            "min_inliers": int(seq["inliers"].min())}


def phase_photo_sharded() -> tuple[dict, dict]:
    """Phase 19's window (10 keyframes, level 1, 2048 points each, joint
    depths, PHOTO_MAX_ITERS passes) solved with its observers over 1, 2 and
    5 shards: each sharded solve against the single shard's within
    tests/test_photometric_ba.py's bar, the cost dropping below
    PHOTO_COST_DROP of the initial one, K3 launched once per shard and
    evaluation, two solves over 5 shards bit-equal, the 5-shard solve as a
    captured graph bit-equal to the eager call; K3 at one shard's shape (2
    observers' texels, 10 x 2048 projections each) against its plain
    version, limit 0, timed beside its bound and `grid_sample`."""
    from uwslam_tpu_torch import ops
    from uwslam_tpu_torch.ba import photometric as pba
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.ops.graph import CapturedStep, tree_clone
    from uwslam_tpu_torch.parallel import distributed_photometric_ba, landmark_layout

    dev = torch.device("cuda", 0)
    prob, cam, _ = photo_window(dev)
    K = prob.inv_depth.shape[0]
    sampler = ops.cuda_bilinear_sample

    def solve(D):
        return distributed_photometric_ba(prob, cam, landmark_layout(D), max_iters=PHOTO_MAX_ITERS)

    out, results = {}, {}
    for D in PHOTO_SHARD_COUNTS:
        sampler.launches = 0
        res, s = timed(lambda: solve(D))
        launches = sampler.launches
        if launches != D * (2 * PHOTO_MAX_ITERS + 1):
            raise AssertionError(f"{D} shards: K3 launched {launches} times")
        if not float(res.cost) < PHOTO_COST_DROP * float(res.initial_cost):
            raise AssertionError(f"{D} shards: cost {float(res.initial_cost)} -> {float(res.cost)}")
        results[D] = res
        out[f"shards_{D}"] = {"ms": 1e3 * s, "k3_launches": launches,
                              "iterations": int(res.iterations),
                              "cost": [float(res.initial_cost), float(res.cost)]}
    one = results[PHOTO_SHARD_COUNTS[0]]
    for D in PHOTO_SHARD_COUNTS[1:]:
        T = results[D].T_cw
        out[f"shards_{D}"]["vs_one_shard_se3_log"] = float(
            se3.log(se3.compose(T, se3.inverse(one.T_cw))).abs().max())
        if not torch.allclose(T, one.T_cw, rtol=PHOTO_SHARD_RTOL, atol=PHOTO_SHARD_ATOL):
            raise AssertionError(f"{D} shards: poses differ from one shard's by "
                                 f"{float((T - one.T_cw).abs().max())}")
    D = PHOTO_SHARD_COUNTS[-1]
    if not all(torch.equal(a, b) for a, b in zip(results[D], solve(D))):
        raise AssertionError(f"two solves over {D} shards differ")
    layout = landmark_layout(D)
    step, capture_s = timed(lambda: CapturedStep(
        lambda *p: distributed_photometric_ba(pba.PhotoBAProblem(*p), cam, layout,
                                              max_iters=PHOTO_MAX_ITERS), tuple(prob)))
    replay, replay_s = timed(lambda: tree_clone(step(*prob)))
    if not all(torch.equal(a, b) for a, b in zip(replay, results[D])):
        raise AssertionError(f"the captured {D}-shard solve differs from the eager one")
    out["graph"] = {"shards": D, "capture_s": capture_s, "replay_ms": 1e3 * replay_s,
                    "kernels_per_replay": dict(zip((k["name"] for k in kernels_table()),
                                                   step.kernel_launches))}

    # K3 at one shard's shape.
    Kj = K // D
    texels = pba.photo_texels(prob)[:Kj].contiguous()
    uv = pba._project(prob, cam, torch.arange(Kj, device=dev))[-1].contiguous()
    k = ops.cuda_bilinear_sample(texels, uv, texels=True)
    err = compare(k, ops.bilinear_sample_texels_plain(texels, uv), SAMPLE_ATOL,
                  "bilinear_sample at a photometric shard's shape")
    planes = ops.unpack_texels(texels).contiguous()
    out["k3"] = {"max_abs_err": err, "shape": [Kj, 3, *prob.images.shape[-2:], uv.shape[1]],
                 "vs_grid_sample": check_grid_sample(k, planes, uv, "photometric shard shape")}
    times = time_pairs(
        {"photo_shard": (lambda: ops.cuda_bilinear_sample(texels, uv, texels=True),
                         lambda: ops.bilinear_sample_texels_plain(texels, uv))},
        {"photo_shard": bound_touched(k[1], uv, tuple(prob.images.shape[-2:]), 16, 3)},
        {"photo_shard": grid_sample_call(planes, uv)})
    return out, times


def trace_kernels(logdir: Path) -> dict:
    """Kernel records by kernel and graph launches in the one Chrome trace
    `--trace` wrote into `logdir`."""
    files = list(logdir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--trace wrote {len(files)} trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"kernel_records": {name: sum(symbol in str(e.get("name")) for e in kernels)
                               for name, symbol in KERNEL_SYMBOLS.items()},
            "all_kernel_records": len(kernels),
            "graph_launches": sum(e.get("name") == "cudaGraphLaunch" for e in events),
            "file_mb": files[0].stat().st_size / 1e6}


def phase_session(frames, poses, table) -> tuple[dict, dict, dict, dict]:
    """The session tooling through the CLI on the card, on phase 8's 8-bit
    dataset of all 96 frames: an uninterrupted run, and a run stopped by
    `--checkpoint` after SESSION_SPLIT frames and continued by `--resume`
    (its first rows equal to the uninterrupted run's within SESSION_T_ATOL,
    its ATE within RESUME_ATE_RATIO of the JAX package's CPU run of the same
    split); `--map-out` on the card and on the CPU (equal vertex counts),
    `--trace` (the trace names `lm_evaluate` and the pyramid kernel),
    `--viz-port 0` (exit 0; a `VizServer` on port 0 answers a GET with the
    SVG); then `entry()` on the card against the CPU's, every kernel against
    its plain version and timed at its shapes, and `dryrun_multichip(8)`.
    The CPU's `--map-out` run and `entry()` go on in a process of their own
    (`ProcessRuns`) beside the card's runs.
    -> (results, entry launches, entry parity errors, entry timings)."""
    import urllib.request

    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.entry import dryrun_multichip, entry
    from uwslam_tpu_torch.image.pyramid import build_pyramid_batched
    from uwslam_tpu_torch.lie import se3
    from uwslam_tpu_torch.tracking.points import topk_gradient_points
    from uwslam_tpu_torch.viz import VizServer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rgb, calib, gt = write_dataset(frames, poses, tmp)
        base = ["-d", str(rgb), "-c", str(calib), "--tum-gt", str(gt), "--levels", "3",
                "--track-levels", "1,0", "--mono-depth", "2.0"]
        card = base + ["--platform", "cuda"]
        short = base + ["--max-frames", str(SESSION_SHORT_FRAMES)]
        plys = {platform: tmp / f"map_{platform}.ply" for platform in ("cuda", "cpu")}
        cpu = ProcessRuns(tmp / "cpu", "cpu", {"map_out": None, "entry": None}, {
            "map_out": short + ["--platform", "cpu", "--map-out", str(plys["cpu"])]})
        try:
            t0 = time.perf_counter()
            ate_whole, _, _ = cli_text(card + ["--trajectory-out", str(tmp / "whole.txt")],
                                       "uninterrupted")
            ck = tmp / "session"
            _, _, err = cli_text(card + ["--max-frames", str(SESSION_SPLIT), "--checkpoint",
                                         str(ck)], "--checkpoint")
            if f"checkpoint -> {ck}" not in err:
                raise AssertionError(f"--checkpoint: {err[-2000:]!r}")
            ate_joined, _, err = cli_text(card + ["--resume", f"{ck}.npz", "--trajectory-out",
                                                  str(tmp / "joined.txt")], "--resume")
            if f"resumed at frame {SESSION_SPLIT}" not in err:
                raise AssertionError(f"--resume: {err[-2000:]!r}")
            whole, joined = np.loadtxt(tmp / "whole.txt"), np.loadtxt(tmp / "joined.txt")
            if joined.shape != whole.shape:
                raise AssertionError(f"--resume: {joined.shape} rows against {whole.shape}")
            first = float(np.abs(joined[:SESSION_SPLIT] - whole[:SESSION_SPLIT]).max())
            bar = RESUME_ATE_RATIO * JAX_RESUME_ATE
            if not (first <= SESSION_T_ATOL and ate_joined <= bar):
                raise AssertionError(f"--resume: first rows {first}, ATE {ate_joined} m > "
                                     f"{bar} m")
            out["checkpoint_resume"] = {
                "frames": len(whole), "split": SESSION_SPLIT, "ate_uninterrupted": ate_whole,
                "ate_joined": ate_joined, "ate_bar": bar, "jax_cpu_ate_joined": JAX_RESUME_ATE,
                "first_rows_max_diff": first, "s": round(time.perf_counter() - t0, 1)}

            errs = {"cuda": cli_text(short + ["--platform", "cuda", "--map-out",
                                              str(plys["cuda"])], "--map-out on cuda")[2],
                    "cpu": cpu.result("map_out")[0]}
            counts = {}
            for platform, err in errs.items():
                m = re.search(r"map: (\d+) points -> ", err)
                head = plys[platform].read_text().splitlines()[:3]
                if m is None or head[2] != f"element vertex {m.group(1)}":
                    raise AssertionError(f"--map-out on {platform}: {err[-2000:]!r} {head}")
                counts[platform] = int(m.group(1))
            if not counts["cuda"] == counts["cpu"] > 100:
                raise AssertionError(f"--map-out: {counts} vertices on the card and the CPU")
            out["map_out"] = {"frames": SESSION_SHORT_FRAMES, "vertices": counts}

            for k in table:
                k["wrapper"].launches = 0
            cli_text(short + ["--platform", "cuda", "--trace", str(tmp / "trace")], "--trace")
            traced = trace_kernels(tmp / "trace")
            traced["launches_counted"] = {k["name"]: k["wrapper"].launches for k in table}
            if not (traced["kernel_records"]["lm_evaluate"]
                    and traced["kernel_records"]["pyramid"]):
                raise AssertionError(f"--trace names neither lm_evaluate nor pyramid: {traced}")
            out["trace"] = traced

            _, _, err = cli_text(short + ["--platform", "cuda", "--viz-port", "0"],
                                 "--viz-port 0")
            m = re.search(r"live view: http://127\.0\.0\.1:(\d+)", err)
            if m is None or int(m.group(1)) == 0:
                raise AssertionError(f"--viz-port 0: {err[-2000:]!r}")
            server = VizServer(port=0)
            try:
                est = se3.inverse(poses.cpu())[:, :3, 3].numpy()
                server.update(est, est)
                with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=10) as r:
                    page = r.read().decode()
            finally:
                server.close()
            if "<svg" not in page or "<polyline" not in page:
                raise AssertionError("VizServer's page holds no trajectory SVG")
            out["viz"] = {"cli_port": int(m.group(1)), "server_page_bytes": len(page)}

            fn, args = entry()
            T, launches = counted(table, "entry()", lambda: fn(*args))
            T_cpu, _ = cpu.result("entry")
        finally:
            cpu.stop()
    gap = float((se3.log(T.cpu()) - se3.log(T_cpu)).abs().max())
    if not (bool(torch.isfinite(T).all()) and gap <= ENTRY_T_ATOL):
        raise AssertionError(f"entry() on the card against the CPU: {gap}")
    dry, dry_s = timed(lambda: dryrun_multichip(8))
    out["entry"] = {"vs_cpu_se3_log": gap, "t": T[:3, 3].tolist(),
                    "dryrun_multichip_8": {"s": dry_s, "ba_cost": float(dry["ba"].cost),
                                           "photo_ba_cost": float(dry["photo_ba"].cost)}}
    cam = bench.CAM
    pyr = build_pyramid_batched(torch.stack(list(args)), levels=5)
    pts = topk_gradient_points(pyr.images[0], pyr.grad_mag[0], cam, num_points=bench.NUM_POINTS,
                               grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0])
    errs = phase_parity(pyr, pts, cam, (3, 2, 1, 0), seed=1)
    times = phase_timing(pyr, pts, cam, T[None].contiguous(), affine=False)
    # entry() builds each frame's pyramid alone: the pyramid kernel at B = 1.
    times.update(time_pairs(*pyramid_calls(args[0][None], 5)))
    return out, launches, errs, times


def run_cli_in_process(argv, table, what: str) -> dict:
    """The port's CLI in this process on the card (`cli_text`), its output
    read by eval.py's patterns (`uwslam_tpu_torch.eval.parse_output`), with
    each kernel's launches over the run (counts set to 0 just before)."""
    from uwslam_tpu_torch import eval as ev

    for k in table:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    _, out, err = cli_text(argv + ["--platform", "cuda"], what)
    torch.cuda.synchronize()
    return {**ev.parse_output(out + err), "wall_s": round(time.perf_counter() - t0, 1),
            "launches": {k["name"]: k["wrapper"].launches for k in table}}


def health_key(message: str) -> str:
    """A health check's message with its ATE figures taken out: which check
    (the config numbers stay)."""
    return re.sub(r"\d+\.\d+(?:e[+-]?\d+)?", "#", message)


# uw-slam's reference mode (configs 0, 8, 9): synchronous frames, no window
# BA, so the same bits whatever runs beside them. Phase 24 runs each in a
# process of its own while this one runs 1, 2, 3 and 10; config 4, whose
# window solves land when the card has them done, runs after them, alone.
SIDE_EVAL_CONFIGS = ((0,), (8,), (9,))
LAST_EVAL_CONFIGS = (4,)


def _side_config2_flat(inp):
    dev = torch.device("cuda", 0)
    system = front_end_system(dev)
    drive(system, inp["scene"].to(dev))
    return RunRecord.record(system)


def _side_reference_mode(inp):
    dev = torch.device("cuda", 0)
    system = front_end_system(dev, reference=True, tracker=live_config().tracker)
    drive(system, inp["plane"][:SCENE_FRAMES].to(dev))
    # The last pair was tracked on patch points if its verified matches
    # reached the front end's minimum (else the top-K selection stands in).
    return {**RunRecord.record(system), "matches": int(system._last_matches[2].sum()),
            "min_matches": system.config.features.min_matches}


def _side_boot_graph_vs_eager(inp):
    return phase_boot_graph_vs_eager(inp["scene"].to(torch.device("cuda", 0)))


def _side_cli_front_end(inp):
    return {name: run_cli(argv, name) for name, argv in inp["cli"].items()}


def _side_config4_without(inp):
    dev = torch.device("cuda", 0)
    system = front_end_system(dev, tracker=live_config().tracker)
    drive(system, inp["plane"].to(dev))
    return RunRecord.record(system)


def _side_live_rgbd(inp):
    """Phase 10's live path with depth images, its launches counted."""
    dev = torch.device("cuda", 0)
    (system, states, _), launches = counted(
        kernels_table(), "the live RGB-D path", lambda: run_live(
            inp["frames"].to(dev), dev, depths=inp["depths"].to(dev), mono_depth=1.0))
    return {**RunRecord.record(system), "graph_replays": system.graph_replays,
            "launches": launches}


def sharded_kw() -> dict:
    """Phase 21's tracking arguments: the bench chunk at SEQ_MAX_ITERS."""
    from uwslam_tpu_torch import bench

    return dict(mono_z=bench.MONO_Z, levels=bench.LEVELS, track_levels=bench.TRACK_LEVELS,
                num_points=bench.NUM_POINTS, max_iters=SEQ_MAX_ITERS)


def _side_sharded_fc(inp):
    """Phase 21's sequential FC chunks over SEQ_SHARDS sequence shards, its
    launches counted."""
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.parallel import landmark_layout, track_sequence_sharded

    frames = inp["frames"].to(torch.device("cuda", 0))
    (seq, s), launches = counted(
        kernels_table(), "sequence-sharded tracking (sequential, FC)", lambda: timed(
            lambda: track_sequence_sharded(frames, bench.CAM, landmark_layout(SEQ_SHARDS),
                                           mode="fc", batched=False, **sharded_kw())))
    return {"T": seq[0].cpu(), "inliers": seq[1].cpu(), "s": s, "launches": launches}


# Runs on the card that a phase reads from a process of its own, each with
# its bars held in the main process: phase 15's run at constant depth and
# uw-slam's reference mode, phase 16a (beside phase 15), phase 17's run
# without BA, phase 10's live path with depth images, phase 21's sequential
# FC chunks (beside phase 24), each synchronous and without window BA (so the
# same bits whatever runs beside them), and phase 18's CLI runs (beside
# phase 15; their bars are 2 cm).
SIDE_SYSTEMS = {"config2_flat": _side_config2_flat, "reference_mode": _side_reference_mode,
                "boot_graph_vs_eager": _side_boot_graph_vs_eager,
                "cli_front_end": _side_cli_front_end,
                "config4_without": _side_config4_without, "live_rgbd": _side_live_rgbd,
                "sharded_fc": _side_sharded_fc}


def run_eval_configs(configs: dict, table, root: Path) -> dict:
    """Phase 24's configs through the port's CLI on the card -> {config:
    `run_cli_in_process`'s result}: each group of SIDE_EVAL_CONFIGS in a
    process of its own beside the others in this one, LAST_EVAL_CONFIGS
    after them."""
    sides = [ProcessRuns(root / f"eval_side{i}", "eval", {c: configs[c]["args"] for c in group})
             for i, group in enumerate(SIDE_EVAL_CONFIGS)]
    beside = [c for c in EVAL_CONFIGS
              if c not in sum(SIDE_EVAL_CONFIGS, ()) + LAST_EVAL_CONFIGS]
    try:
        runs = {c: run_cli_in_process(configs[c]["args"], table, f"config {c}") for c in beside}
        for side, group in zip(sides, SIDE_EVAL_CONFIGS):
            runs.update({c: side.result(c)[0] for c in group})
    finally:
        for side in sides:
            side.stop()
    runs.update({c: run_cli_in_process(configs[c]["args"], table, f"config {c}")
                 for c in LAST_EVAL_CONFIGS})
    return runs


def phase_eval_configs(table) -> dict:
    """eval.py's configs 0-4 and 8-10 at full size on the card: the TUM and
    both EUROC sequences rendered on the card by `uwslam_tpu_torch.eval`,
    each config through the port's CLI with eval.py's flags (`run_eval_configs`).
    The render must be the one the JAX figures were measured on (its
    digests). Per config: ATE within its bar, every frame tracked, fps, warm
    fps, window-BA iterations per second, the kernels' launches. eval.py's
    health checks on the table: those every JAX CLI run of these frames
    passes are asserted, those one fails too printed beside their figures.
    the pyramid kernel, `lm_evaluate` and K3 must have launched over the phase."""
    from uwslam_tpu_torch import eval as ev

    dev = torch.device("cuda", 0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tum, mh01, v101 = (render_eval_dataset(Path(tmp), name, dev) for name in EVAL_DATASETS[:3])
        out["render_s"] = round(time.perf_counter() - t0, 1)
        out["frames_digest"] = {name: check_digest(Path(tmp) / name, name)
                                for name in EVAL_DATASETS[:3]}
        configs = ev.configs(tum, tum, mh01, v101, 0, 0)
        runs = run_eval_configs(configs, table, Path(tmp))
        results, misses = {}, []
        for c in EVAL_CONFIGS:
            r = runs[c]
            n = EVAL_TUM_FRAMES if c <= 2 else EVAL_EUROC_FRAMES
            if not (r.get("frames") == r.get("ate_poses") == n):
                misses.append(f"config {c}: {r.get('frames')} frames tracked, "
                              f"{r.get('ate_poses')} in the ATE, of {n}")
            if not r.get("ate_rmse_m", float("inf")) <= EVAL_ATE_MAX[c]:
                misses.append(f"config {c}: ATE {r.get('ate_rmse_m')} m > {EVAL_ATE_MAX[c]} m")
            results[str(c)] = {"rc": 0, **r}
            out[f"config{c}"] = {
                "ate_m": r["ate_rmse_m"], "ate_bar_m": EVAL_ATE_MAX[c],
                "jax_cpu_ate_m": JAX_CARD_FRAMES_ATE[c],
                "jax_cpu_ate_m_other_draws": JAX_DRAWS_ATE.get(c), "fps": r.get("fps"),
                "fps_warm": r.get("fps_warm"),
                "window_ba_iters_per_sec": r.get("window_ba_iters_per_sec"),
                "window_ba_iters": r.get("window_ba_iters"), "wall_s": r["wall_s"],
                "launches": r["launches"]}
    with contextlib.redirect_stdout(io.StringIO()):
        jax_failed = [m for t in jax_tables(JAX_CARD_FRAMES_ATE)
                      for m in ev.health_checks(t, quick=False)]
        failed = ev.health_checks(results, quick=False)
    jax_keys: dict[str, list[str]] = {}
    for m in jax_failed:
        jax_keys.setdefault(health_key(m), []).append(m)
    asserted = [m for m in failed if health_key(m) not in jax_keys]
    out["health"] = {"failed": failed, "failed_by_a_jax_cpu_run_too": [
        {"port": m, "jax_cpu": jax_keys[health_key(m)]} for m in failed
        if health_key(m) in jax_keys]}
    misses += [f"health check every JAX CLI run of these frames passes: {m}" for m in asserted]
    # Configs 2 and 3 track with affine brightness (--affine, Huber): every LM
    # evaluation after a level's first is one lm_evaluate launch.
    out["affine_configs_launches"] = {
        c: {n: out[f"config{c}"]["launches"][n] for n in ("warp_sample", "lm_evaluate")}
        for c in AFFINE_CONFIGS}
    misses += [f"config {c} (--affine) launched lm_evaluate 0 times" for c in AFFINE_CONFIGS
               if not out["affine_configs_launches"][c]["lm_evaluate"]]
    if misses:
        raise AssertionError(f"phase 24: {json.dumps(out)}; missed: {misses}")
    total = {k["name"]: sum(out[f"config{c}"]["launches"][k["name"]] for c in EVAL_CONFIGS)
             for k in table}
    missing = [n for n in ("pyramid", "lm_evaluate", "bilinear_sample") if not total[n]]
    if missing:
        raise AssertionError(f"kernels not launched over eval.py's configs: {missing}")
    out["launches"] = total
    return out


# Phase 25: the measuring tools.
BUDGET_STAGE_SUM_RTOL = 3e-2   # pyramid + select + track busy against the whole chunk's
# The chunk's kernels: its pyramid is one launch (11,110 when K1 ran on each of
# its 5 levels beside 16 plain operations of the 2x2 means).
CHUNK_LAUNCHES = 11090
# A profile can come back short of a kernel record or two: three profiles of
# the same chunk read 11,110, 11,109 and 11,109 on an H100.
PROFILE_RECORDS_LOST = 3
ATTR_TOTAL_RTOL = 1e-2
ATTR_UNATTRIBUTED_MAX = 0.02   # share of the kernel time
ATTR_CHUNKS = 1                # profiled chunks here (the tool's default is 3)
WRAPPER_FILES = {"pyramid": ("pyramid_kernel", "uwslam_tpu_torch/ops/cuda_pyramid.py", 1),
                 "warp_sample": ("warp_sample_kernel", "uwslam_tpu_torch/ops/cuda_track.py", 5),
                 "bilinear_sample": ("bilinear_sample_kernel",
                                     "uwslam_tpu_torch/ops/cuda_sample.py", 3),
                 "lm_evaluate": ("lm_evaluate_kernel", "uwslam_tpu_torch/ops/cuda_track.py", 32)}
SCALING_RUNS = 1               # solves per shard count here (the tool's default is 3)
SCALING_COST_RTOL = 1e-3       # final cost across a curve's shard counts
BUDGET_REPS = 1                # timed calls per stage here (the tool's default is 10)
RANGE_CHUNKS = 2               # chunks per turn of phase 25(d)
TOOLS_TIMEOUT_S = 300


def phase_tools_fresh() -> dict:
    """Phase 25 in a process of its own (`--tools`, below): in a process that
    has taken many profiles the profiler comes back short of the first
    kernel records of a window (phase 23's trace: 3 Scharr records; phase 25
    run after phase 24 in one process: ~64 records per window, the chunk's
    Scharr launches among them, on an H100), while a fresh process gives
    whole profiles."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "tools.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tools", str(out)],
                              capture_output=True, text=True, timeout=TOOLS_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"phase 25 failed (exit {proc.returncode}):\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-12000:]}")
        return json.loads(out.read_text())


def tools_process(out: str) -> None:
    """Body of the `--tools` process: phase 25 on the bench frames, its
    result to `out`."""
    from uwslam_tpu_torch import bench

    poses = bench.bench_poses(device=torch.device("cuda", 0))
    Path(out).write_text(json.dumps(phase_tools(bench.bench_frames(poses), poses, kernels_table()),
                                    default=str))


def phase_tools(frames, poses, table) -> dict:
    """Phase 25: the three measuring tools on the card, and the cost of the
    launcher's profiler range."""
    from uwslam_tpu_torch import attribute_trace, bench, offline_budget, scaling
    from uwslam_tpu_torch.ops import _lib

    cam = bench.CAM
    out, misses = {}, []
    t0 = time.perf_counter()
    budget = offline_budget.budget(frames, poses, cam, reps=BUDGET_REPS)
    full = budget["budget"][-1]
    gap = budget["stage_sum"]["relative_gap"]
    if not abs(gap) <= BUDGET_STAGE_SUM_RTOL:
        misses.append(f"budget: stages' busy {budget['stage_sum']['stages_busy_ms']} ms against "
                      f"the chunk's {full['device_busy_ms']} ms ({gap:+.4f})")
    if not CHUNK_LAUNCHES - PROFILE_RECORDS_LOST <= full["launches"] <= CHUNK_LAUNCHES:
        misses.append(f"budget: the profile holds {full['launches']} kernels of the chunk, "
                      f"not {CHUNK_LAUNCHES} (less at most {PROFILE_RECORDS_LOST} lost records)")
    if not budget["ate_m"] <= ATE_MAX:
        misses.append(f"budget: chunk ATE {budget['ate_m']} m > {ATE_MAX}")
    stage = budget["budget"][0]
    if not (stage["stage"].startswith("pyramid") and stage["launches"] == 1):
        misses.append(f"budget: the pyramid stage holds {stage['launches']} kernels, not one "
                      "launch of the pyramid kernel")
    out["budget"] = {"rows": [{k: r[k] for k in ("stage", "ms_per_chunk", "device_busy_ms",
                                                 "launches", "idle_share")}
                              for r in budget["budget"]],
                     **{k: budget[k] for k in ("fps_serial", "fps_pipelined", "ate_m",
                                               "stage_sum")},
                     "s": round(time.perf_counter() - t0, 1)}

    t0 = time.perf_counter()
    # A profile can come back without its first kernel records, the chunk's
    # one pyramid launch among them: each profile opens on a chunk it traces
    # and drops (`micro.warm_profile`), and, as phase 11d does, an
    # attribution whose hand-written launches fall short of the wrappers'
    # counts is taken again, up to PROFILE_ATTEMPTS times.
    short = []
    for _ in range(PROFILE_ATTEMPTS):
        attr, launches = counted(table, "attribute_trace", lambda: attribute_trace.attribute(
            frames, cam, chunks=ATTR_CHUNKS))
        per_chunk, wrong = {}, []
        for name, (symbol, wrapper, want) in WRAPPER_FILES.items():
            rows = [r for r in attr["hand_written"]
                    if symbol in r["op"] and r["source"].split(":")[0] == wrapper]
            per_chunk[name] = sum(r["launches"] for r in rows)
            # The warm-up chunk, and each profile's chunk traced and dropped.
            counted_per_chunk = launches[name] / (2 * ATTR_CHUNKS + 1)
            if not per_chunk[name] == want == counted_per_chunk:
                wrong.append(f"attribution: {name} {per_chunk[name]} launches per chunk under "
                             f"{wrapper}, the wrapper counted {counted_per_chunk}, want {want}")
        if not wrong:
            break
        short.append(per_chunk)
    misses += wrong
    total = attr["device_busy_ms_per_chunk"]
    summed = (sum(r["ms_per_chunk"] for r in attr["attribution"])
              + attr["below_row_ms_per_chunk"] + attr["unattributed_ms_per_chunk"])
    if not abs(summed / total - 1.0) <= ATTR_TOTAL_RTOL:
        misses.append(f"attribution: rows sum to {summed} ms, the profiler's total {total} ms")
    if not attr["unattributed_ms_per_chunk"] <= ATTR_UNATTRIBUTED_MAX * total:
        misses.append(f"attribution: {attr['unattributed_ms_per_chunk']} ms unattributed of "
                      f"{total} ms")
    out["attribution"] = {
        "profiles_short_of_records": short,
        "top": attr["attribution"][:12], "hand_written": attr["hand_written"],
        **{k: attr[k] for k in ("device_span_ms_per_chunk", "device_busy_ms_per_chunk",
                                "unattributed_ms_per_chunk", "below_row_ms_per_chunk")},
        "launches_per_chunk": per_chunk, "launches": launches,
        "s": round(time.perf_counter() - t0, 1)}

    t0 = time.perf_counter()
    curves = scaling.curves(torch.device("cuda", 0), runs=SCALING_RUNS)
    for label, curve in curves.items():
        rows = curve["scaling"]
        bad = [r["devices"] for r in rows if r["iterations"] != scaling.MAX_ITERS
               or not all(math.isfinite(r[k]) for k in ("seconds", "cost_initial", "cost_final"))]
        if bad:
            misses.append(f"scaling {label}: shard counts {bad} not {scaling.MAX_ITERS} finite "
                          "iterations")
        if not curve["cost_final_spread"] <= SCALING_COST_RTOL:
            misses.append(f"scaling {label}: final costs spread {curve['cost_final_spread']}")
    out["scaling"] = {label: {"spread": c["cost_final_spread"], "rows": [
        {k: r[k] for k in ("devices", "iterations", "seconds", "iters_per_sec",
                           "work_division_pct", "cost_final", "max_memory_allocated")}
        for r in c["scaling"]]} for label, c in curves.items()}
    out["scaling"]["s"] = round(time.perf_counter() - t0, 1)

    def chunk_ms():
        ms = []
        for _ in range(RANGE_CHUNKS):
            t = time.perf_counter()
            offline_budget.full_chunk(frames, cam)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        return ms

    turns = {"no_ranges": [], "launch_ranges": []}
    for name in ("no_ranges", "launch_ranges", "launch_ranges", "no_ranges"):
        with _lib.launch_ranges() if name == "launch_ranges" else contextlib.nullcontext():
            turns[name] += chunk_ms()
    out["launch_range"] = {name: {"chunk_ms_median": statistics.median(ms),
                                  "chunk_ms_spread": [min(ms), max(ms)],
                                  "host_ms_per_launch": statistics.median(ms) / CHUNK_LAUNCHES}
                           for name, ms in turns.items()}
    if misses:
        # The misses last: a reader of the output's end sees them.
        raise AssertionError(f"phase 25: {json.dumps(out, default=str)}; missed: {misses}")
    return out


def main(stack: contextlib.ExitStack) -> None:
    """All phases; `stack` stops the processes and removes the directories
    that outlive a phase, however the run ends."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is visible; nothing was run")
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.image.pyramid import build_pyramid, build_pyramid_batched
    from uwslam_tpu_torch.ops import _lib
    from uwslam_tpu_torch.tracking.points import topk_gradient_points

    dev = torch.device("cuda", 0)
    gpu = bench.gpu_identity()
    say("1 device", f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, build_s, log = _lib.build()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("2 build", f"{path.name} in {build_s:.2f} s; ptxas: {' | '.join(ptxas)}")

    table = kernels_table()
    cam = bench.CAM
    poses = bench.bench_poses(device=dev)
    frames = bench.bench_frames(poses)
    pyr = build_pyramid_batched(frames, levels=bench.LEVELS)
    pts = topk_gradient_points(
        pyr.images[0], pyr.grad_mag[0], cam, num_points=bench.NUM_POINTS,
        mono_z=bench.MONO_Z, grad_x=pyr.grad_x[0], grad_y=pyr.grad_y[0],
    )
    errs = phase_parity(pyr, pts, cam, bench.TRACK_LEVELS)
    torch.cuda.synchronize()
    say("3 parity", "max abs error vs plain: " + json.dumps(errs))

    tracker = bench.make_tracker(cam)
    t0 = time.perf_counter()
    main_path = phase_main_path(tracker, frames, poses, bench.MONO_Z, table)
    say("4 main path", json.dumps(main_path)
        + f"; first chunk and CPU run {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    chunk_s = statistics.median(bench.time_chunks(tracker, frames, CHUNK_RUNS))
    busy_ms, launches = device_profile(lambda: tracker(frames, mono_z=bench.MONO_Z), 1)
    T_rel, _, _ = tracker(frames, mono_z=bench.MONO_Z)
    times = phase_timing(pyr, pts, cam, T_rel.contiguous())
    fps = (frames.shape[0] - 1) / chunk_s
    if not launches < MAX_LAUNCHES_PER_CHUNK:
        raise AssertionError(f"{launches:.0f} kernel launches per chunk, not below "
                             f"{MAX_LAUNCHES_PER_CHUNK}")
    say("5 timing", f"{fps:.1f} tracked frames/s (median of {CHUNK_RUNS} chunks: "
        f"{chunk_s * 1e3:.2f} ms per {frames.shape[0]}-frame chunk; profiled "
        f"chunk: {busy_ms:.2f} ms device busy, {launches:.0f} kernel launches, "
        f"idle share {1 - busy_ms / (chunk_s * 1e3):.3f}); per call: "
        + json.dumps(times) + f"; {gpu}; {time.perf_counter() - t0:.1f} s")

    # The CPU comparison runs of phases 6-19 go on in a process of their own
    # from here (`ProcessRuns`); the depth frames of phase 10, the scene of
    # phases 15-16 and the photometric window of phase 19 are made for it.
    from uwslam_tpu_torch.ba.photometric import PhotoBAProblem

    noisy = with_noise_frame(frames)
    depths = tum_depth(cam, poses)
    scene, scene_poses = scene_sequence(dev)
    window = photo_window(dev)
    jobs_dir = Path(stack.enter_context(tempfile.TemporaryDirectory())) / "cpu_jobs"
    worker = ProcessRuns(jobs_dir, "cpu", dict.fromkeys(WORKER_JOBS), {
        "frames": frames.cpu(), "noisy": noisy.cpu(), "depths": depths.cpu(),
        "scene": scene.cpu(),
        "photo_window": (PhotoBAProblem(*(t.cpu() for t in window[0])), window[1])})
    stack.callback(worker.stop)

    lcfg = live_config().tracker
    live_pyrs = [build_pyramid(frames[i], levels=lcfg.pyramid_levels) for i in (0, 1)]
    live_pts = topk_gradient_points(live_pyrs[0].images[0], live_pyrs[0].grad_mag[0], cam,
                                    num_points=lcfg.num_points, mono_z=lcfg.mono_depth)
    errs_live, live_calls = phase_parity_live(*live_pyrs, live_pts, cam, lcfg.track_levels,
                                              "B=1")
    del live_pyrs
    torch.cuda.synchronize()
    say("3b parity (live shapes)", "max abs error vs plain: " + json.dumps(errs_live))
    errs_euroc, euroc_times = phase_euroc_pyramid(dev)
    say("3c the rectified EUROC shape", json.dumps(errs_euroc) + "; per call: "
        + json.dumps(euroc_times) + f"; {gpu}")

    t0 = time.perf_counter()
    cpu_states = []

    def live_cpu_states():
        states, s = worker.result("live_noisy")
        cpu_states.extend(states)
        live_cpu_states.s = s
        return states[:NOISE_FRAME]

    live, frame_ms = phase_live(frames, poses, table, live_cpu_states)
    say("6 live path", json.dumps(live) + f"; card run {time.perf_counter() - t0:.1f} s, "
        f"the CPU worker's run of the {noisy.shape[0]} frames of phase 7 "
        f"{live_cpu_states.s:.1f} s")
    t0 = time.perf_counter()
    reloc = phase_reloc(noisy, poses, cpu_states)
    say("7 relocalization", json.dumps(reloc) + f"; {time.perf_counter() - t0:.1f} s")
    say("8 cli", json.dumps(phase_cli(frames, poses)))
    t0 = time.perf_counter()
    live_times = phase_live_timing(frames, live_calls, frame_ms)
    say("9 live timing", json.dumps(live_times) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not live_times["launches_per_frame"] < MAX_LAUNCHES_PER_FRAME:
        raise AssertionError(f"{live_times['launches_per_frame']:.0f} kernel launches per "
                             f"live frame, not below {MAX_LAUNCHES_PER_FRAME}")

    t0 = time.perf_counter()
    depth_errs, depth_times = phase_depth_kernel(depths, pts)
    say("10 depth (kernel)", json.dumps(depth_errs) + "; per call: " + json.dumps(depth_times)
        + f"; {gpu}")
    seq_pyrs = [build_pyramid(frames[i], levels=bench.LEVELS) for i in (0, 1)]
    seq_pts = topk_gradient_points(seq_pyrs[0].images[0], seq_pyrs[0].grad_mag[0], cam,
                                   depth_image=depths[:1], num_points=bench.NUM_POINTS,
                                   mono_z=1.0)
    errs_seq, _ = phase_parity_live(*seq_pyrs, seq_pts, cam, bench.TRACK_LEVELS,
                                    "track_sequence B=1", describe=False)
    del seq_pyrs
    say("10 depth (parity at track_sequence's shapes: B = 1, 5 levels, FC)",
        "max abs error vs plain: " + json.dumps(errs_seq))
    depth_paths = phase_depth_paths(frames, poses, depths, table, worker)
    say("10 depth (paths)", json.dumps(depth_paths) + f"; {time.perf_counter() - t0:.1f} s")
    del depths

    t0 = time.perf_counter()
    say("11a graph vs eager", json.dumps(phase_graph_vs_eager(frames)))
    pipelined, pipe_ms = phase_pipelined(frames, poses, table, live["ate"], worker)
    say("11b pipelined loop", json.dumps(pipelined))
    say("11c pipelined relocalization", json.dumps(phase_pipelined_reloc(noisy, poses, worker)))
    pipe_times = phase_pipelined_timing(frames, pipe_ms, live_times, table)
    say("11d pipelined timing", json.dumps(pipe_times) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rectified = phase_rectification(poses, table)
    say("12 rectification", json.dumps(rectified) + f"; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    say("13 bundle adjustment", json.dumps(phase_ba(gpu)) + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    refine_errs, refine_times = phase_refine_kernel(frames, live_pts, cam)
    say("14 K3 at the depth-refinement shape", json.dumps(refine_errs) + "; per call: "
        + json.dumps(refine_times) + f"; {gpu}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # Phase 18's CLI runs in a process of their own beside phases 15-16a.
    cli_dir = Path(stack.enter_context(tempfile.TemporaryDirectory()))
    cli_runs = ProcessRuns(cli_dir / "runs", "system", {"cli_front_end": None},
                           {"cli": cli_front_end_argv(frames, poses, cli_dir)})
    stack.callback(cli_runs.stop)
    config2, boot_system = phase_config2(scene, scene_poses, frames, poses, table, worker)
    boot_vs_eager = config2.pop("boot_graph_vs_eager")
    say("15 config 2 (synchronous)", json.dumps(config2) + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    say("16a bootstrap graph vs eager (beside phase 15)", json.dumps(boot_vs_eager))
    cli_front_end = cli_front_end_check(cli_runs.result("cli_front_end")[0])
    cli_runs.stop()
    say("18 cli (configs 2 and 4, --photo-ba; beside phases 15-16a)", json.dumps(cli_front_end))
    config2_pipe = phase_config2_pipelined(scene, scene_poses, table, boot_system)
    say("16b config 2 (pipelined)", json.dumps(config2_pipe) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    del scene, boot_system
    t0 = time.perf_counter()
    config4 = phase_config4(frames, poses, table, pipe_ms, worker)
    say("17 config 4 (window BA)", json.dumps(config4) + f"; {gpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    photo, photo_times = phase_photo_ba(frames, poses, table, window, worker)
    worker.stop()
    say("19 photometric window BA", json.dumps(photo) + "; per call: " + json.dumps(photo_times)
        + f"; {gpu}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as loop_tmp:
        loops, cpu_config5_run = phase_loop_configs(table, Path(loop_tmp))
        try:
            say("20 configs 5-7 (loop closure, global BA)", json.dumps(loops)
                + f"; {gpu}; {time.perf_counter() - t0:.1f} s")
            # Phases 21-23 on the card while the CPU's run of config 5 goes on.
            sharded = phase_sequence_sharded(frames, poses, table)
            say("21 sequence-sharded tracking (batched IC)", json.dumps(sharded) + f"; {gpu}")
            photo_sharded, photo_shard_times = phase_photo_sharded()
            say("22 observer-sharded photometric BA", json.dumps(photo_sharded) + "; per call: "
                + json.dumps(photo_shard_times) + f"; {gpu}")
            session, entry_launches, entry_errs, entry_times = phase_session(frames, poses,
                                                                             table)
            say("23 session tooling and the entry", json.dumps(session) + "; entry() launches: "
                + json.dumps(entry_launches) + "; parity at entry()'s shapes: "
                + json.dumps(entry_errs) + "; per call at entry()'s shapes: "
                + json.dumps(entry_times) + f"; {gpu}")
            say("20 (the CPU's run of config 5, beside phases 20-23)",
                json.dumps(phase_loop_cpu(loops, cpu_config5_run)))
        finally:
            cpu_config5_run[0].stop()
    # Phase 21's sequential FC chunks in a process of their own beside phase 24.
    sharded_fc = ProcessRuns(Path(stack.enter_context(tempfile.TemporaryDirectory())) / "fc",
                             "system", {"sharded_fc": None}, {"frames": frames.cpu()})
    stack.callback(sharded_fc.stop)
    evaluated = phase_eval_configs(table)
    say("24 eval.py's configs 0-4 and 8-10 (full size)", json.dumps(evaluated) + f"; {gpu}")
    sharded["sequential_fc"] = sharded_fc_check(sharded_fc.result("sharded_fc")[0], poses)
    sharded_fc.stop()
    say("21 sequence-sharded tracking (sequential FC, beside phase 24)",
        json.dumps(sharded["sequential_fc"]) + f"; {gpu}")
    tools = phase_tools_fresh()
    say("25 measuring tools", json.dumps(tools) + f"; {gpu}")

    live_k = live_times["kernels_at_live_shapes"]
    depth_launches = {k["name"]: sum(depth_paths[path]["launches"][k["name"]]
                                     for path in depth_paths) for k in table}
    kernels = [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "on_path": k["name"] in PATH_KERNELS,
         "launches": main_path["launches"][k["name"]],
         "launches_live": live["launches"][k["name"]],
         "launches_depth": depth_launches[k["name"]],
         "launches_pipelined": pipelined["launches"][k["name"]],
         "launches_rectified": rectified["launches"][k["name"]],
         "launches_bootstrap": config2["launches"][k["name"]],
         "launches_bootstrap_pipelined": config2_pipe["launches"][k["name"]],
         "launches_window_ba": config4["launches"][k["name"]],
         "launches_photo_ba": photo["live"]["launches"][k["name"]],
         "launches_config5": loops["c_full_config5"]["launches"][k["name"]],
         "launches_sharded_batched": sharded["batched_ic"]["launches"][k["name"]],
         "launches_sharded_sequential": sharded["sequential_fc"]["launches"][k["name"]],
         "launches_entry": entry_launches[k["name"]],
         "launches_eval": {c: evaluated[f"config{c}"]["launches"][k["name"]]
                           for c in EVAL_CONFIGS},
         "launches_attribute_trace": tools["attribution"]["launches"][k["name"]],
         "max_abs_err": max(e.get(k["name"], 0.0) for e in (
             errs, errs_live, errs_seq, rectified["parity_max_abs_err"], entry_errs,
             errs_euroc)),
         "ms": times[k["name"]]["device_ms"],
         "plain_ms": times[k["name"]]["plain_device_ms"],
         "bound_ms": times[k["name"]]["bound_ms"],
         "bound_by": times[k["name"]]["bound_by"],
         "library_ms": times[k["name"]]["library_ms"],
         "ms_live": live_k[k["name"]]["device_ms"],
         "plain_ms_live": live_k[k["name"]]["plain_device_ms"],
         "bound_ms_live": live_k[k["name"]]["bound_ms"],
         "library_ms_live": live_k[k["name"]]["library_ms"],
         "ms_entry": entry_times[k["name"]]["device_ms"],
         "plain_ms_entry": entry_times[k["name"]]["plain_device_ms"],
         "bound_ms_entry": entry_times[k["name"]]["bound_ms"],
         "library_ms_entry": entry_times[k["name"]]["library_ms"]}
        for k in table
    ]
    for k in kernels:
        if k["name"] in euroc_times:   # the pyramid, K1 alone and lm_evaluate at 1 x 480 x 736
            t = euroc_times[k["name"]]
            k.update({"ms_euroc": t["device_ms"], "plain_ms_euroc": t["plain_device_ms"],
                      "bound_ms_euroc": t["bound_ms"], "library_ms_euroc": t["library_ms"]})
    # lm_evaluate with affine brightness (configs 2 and 3): IC at the offline
    # shape, FC at the live and the rectified EUROC shapes.
    lm = next(k for k in kernels if k["name"] == "lm_evaluate")
    for shape, t in (("affine", times), ("live_affine", live_k), ("euroc_affine", euroc_times)):
        t = t["lm_evaluate_affine"]
        lm.update({f"ms_{shape}": t["device_ms"], f"plain_ms_{shape}": t["plain_device_ms"],
                   f"bound_ms_{shape}": t["bound_ms"], f"library_ms_{shape}": t["library_ms"]})
    sampler = next(k for k in kernels if k["name"] == "bilinear_sample")
    sampler["max_abs_err"] = max(sampler["max_abs_err"], depth_errs["live"],
                                 depth_errs["offline"])
    for shape, t in depth_times.items():       # K3 with C = 1 on depth images
        sampler.update({f"ms_depth_{shape}": t["device_ms"],
                        f"plain_ms_depth_{shape}": t["plain_device_ms"],
                        f"bound_ms_depth_{shape}": t["bound_ms"],
                        f"library_ms_depth_{shape}": t["library_ms"]})
    # K3 with C = 3 texels at the depth-refinement shape (1 x 480 x 640, 2048).
    sampler["max_abs_err"] = max(sampler["max_abs_err"], refine_errs["max_abs_err"])
    sampler.update({"ms_refine": refine_times["device_ms"],
                    "plain_ms_refine": refine_times["plain_device_ms"],
                    "bound_ms_refine": refine_times["bound_ms"],
                    "library_ms_refine": refine_times["library_ms"]})
    # K3 in the photometric solve: texels (10 x 240 x 320, 10 x 20,480 points)
    # and the reference intensity (C = 1, 10 x 2048 points).
    sampler["max_abs_err"] = max(sampler["max_abs_err"], photo["k3"]["max_abs_err"])
    for shape, t in (("photo", photo_times["photo"]), ("photo_ref", photo_times["photo_ref"])):
        sampler.update({f"ms_{shape}": t["device_ms"], f"plain_ms_{shape}": t["plain_device_ms"],
                        f"bound_ms_{shape}": t["bound_ms"],
                        f"library_ms_{shape}": t["library_ms"]})
    sampler["launches_per_photo_solve"] = photo["solve"]["k3_launches_per_solve"]
    # K3 at one observer shard's shape (2 observers of phase 22's 5 shards).
    t = photo_shard_times["photo_shard"]
    sampler["max_abs_err"] = max(sampler["max_abs_err"], photo_sharded["k3"]["max_abs_err"])
    sampler.update({"ms_photo_shard": t["device_ms"], "plain_ms_photo_shard": t["plain_device_ms"],
                    "bound_ms_photo_shard": t["bound_ms"],
                    "library_ms_photo_shard": t["library_ms"],
                    "launches_photo_sharded": {
                        D: photo_sharded[f"shards_{D}"]["k3_launches"]
                        for D in PHOTO_SHARD_COUNTS}})
    say("total", f"phases 1-25 passed; {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--runs"]:
        runs_process(sys.argv[2])
    elif sys.argv[1:2] == ["--tools"]:
        tools_process(sys.argv[2])
    else:
        with contextlib.ExitStack() as exit_stack:
            main(exit_stack)
