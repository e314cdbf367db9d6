"""The evaluation on the port: eval.py's eleven staged configs through the
port's CLI (`python -m uwslam_tpu_torch`).

    python -m uwslam_tpu_torch.eval [--quick] [--configs 0,1,...] [--real ROOT]
                                    [--ba-value] [--round N] [--platform cuda|cpu]

Counterpart of the repository's `eval.py` (the JAX package's evaluation),
which it leaves alone. It renders the same synthetic stand-ins (the
multi-plane occluding scenes, the smooth camera paths, gain and bias drift
and sensor noise, the TUM and EUROC on-disk formats with the real EUROC
radtan coefficients) on the evaluation's device, under the same directory
names and `DONE` marker below `$UWSLAM_EVAL_DATA` (default
`<temp dir>/uwslam_eval`), so that frames eval.py rendered there are
reused as they are. The port writes its name into `DONE`, and every result
records which renderer made its frames. The sensor noise comes from a
`torch.Generator` seeded as eval.py seeds its keys (`jax.random` itself
cannot be reproduced), so the port's frames differ from eval.py's in the
noise draw alone.

Every config runs `python -m uwslam_tpu_torch` with `--platform` of this
run: configs 5-7 included, whose `--platform cpu` in eval.py is the JAX
package's way to get 8 host devices; here `--host-devices 8` makes 8
landmark shards of one process on the chosen device. Results go to the
port's own files beside eval.py's, never over them: `RESULTS_TORCH_r<N>.json`,
`RESULTS_TORCH.md` and (`--ba-value`) `BA_VALUE_TORCH_r<N>.json`, headed by
the card's name and power limit. The health checks of eval.py are printed as
`HEALTH CHECK FAILED` lines and do not set the exit code.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = str(Path(__file__).resolve().parent.parent)
DATA_ROOT = os.environ.get("UWSLAM_EVAL_DATA", os.path.join(tempfile.gettempdir(),
                                                            "uwslam_eval"))
RENDERER = "uwslam_tpu_torch"
JAX_RENDERER = "uwslam_tpu (eval.py)"   # an empty DONE: eval.py's marker

TUM_CAMERA = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
EUROC_CAMERA = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480)
EUROC_DISTORTION = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
EUROC_OUT = (736, 480)   # calibrationEUROC.xml's rectified size


# --------------------------------------------------------------------- scenes

def scene(kind: str):
    """eval.py:_scene: deep multi-plane occluding scenes (depth ratio ~3.5)
    with broadband textures (4 octaves) for `tum`, `euroc_mh` and
    `euroc_v1`."""
    from .utils.synthetic import make_plane

    if kind == "tum":
        return (
            make_plane((0.0, 0.0, 5.0), normal=(0.05, -0.02, -1.0), seed=3, detail=0.9,
                       octaves=4),
            make_plane((-0.9, 0.1, 2.4), normal=(0.35, 0.1, -1.0), extent=(1.1, 1.4), seed=7,
                       detail=1.2, octaves=4),
            make_plane((0.5, -0.2, 1.4), normal=(-0.1, 0.05, -1.0), extent=(0.5, 0.55),
                       seed=11, detail=1.5, octaves=4),
            make_plane((-0.15, 0.6, 1.8), normal=(0.0, -0.3, -1.0), extent=(0.9, 0.3), seed=5,
                       detail=1.3, octaves=4),
        )
    if kind == "euroc_mh":   # machine-hall-like: deeper, wider structures
        return (
            make_plane((0.0, 0.2, 6.0), normal=(-0.03, -0.05, -1.0), seed=13, detail=0.8,
                       octaves=4),
            make_plane((1.0, -0.1, 3.2), normal=(-0.3, 0.05, -1.0), extent=(1.3, 1.2),
                       seed=17, detail=1.1, octaves=4),
            make_plane((-0.8, 0.3, 2.0), normal=(0.2, -0.1, -1.0), extent=(0.6, 0.8), seed=19,
                       detail=1.4, octaves=4),
            make_plane((0.1, -0.7, 2.6), normal=(0.0, 0.25, -1.0), extent=(1.0, 0.35),
                       seed=23, detail=1.2, octaves=4),
        )
    if kind == "euroc_v1":   # vicon-room-like: closer walls
        return (
            make_plane((0.0, 0.0, 4.2), normal=(0.02, 0.04, -1.0), seed=29, detail=1.0,
                       octaves=4),
            make_plane((-0.7, -0.2, 2.2), normal=(0.3, -0.05, -1.0), extent=(0.9, 1.0),
                       seed=31, detail=1.3, octaves=4),
            make_plane((0.6, 0.25, 1.6), normal=(-0.15, -0.1, -1.0), extent=(0.5, 0.5),
                       seed=37, detail=1.5, octaves=4),
        )
    raise ValueError(kind)


def trajectory(n: int, scale: float = 1.0, loop_period: int | None = None,
               device="cpu") -> torch.Tensor:
    """eval.py:_trajectory: a smooth path rich in parallax, 2-4 px of motion
    between frames at the TUM design point -> (n, 4, 4) camera-from-world
    poses. With `loop_period` every sinusoid's frequency is a multiple of
    2 pi / loop_period, so pose(i + loop_period) == pose(i): a true revisit."""
    from .lie import se3

    if loop_period is not None:
        w0 = 2.0 * math.pi / loop_period
        freqs = (w0, w0, w0, w0, 2 * w0, w0)
    else:
        freqs = (0.045, 0.032, 0.026, 0.040, 0.033, 0.050)
    amps = (0.30 * scale, 0.12 * scale, 0.10 * scale, 0.030, 0.045, 0.020)
    phases = (0.0, 0.7, 1.9, 0.3, 2.1, 1.1)
    xi = torch.tensor([[a * math.sin(f * i + p) - a * math.sin(p)
                        for a, f, p in zip(amps, freqs, phases)] for i in range(n)],
                      dtype=torch.float32, device=device)
    return se3.exp(xi)


# ------------------------------------------------------------------- datasets

def write_tum_calib(path, fx, fy, cx, cy, w, h, dist=(0, 0, 0, 0), out_w=None, out_h=None):
    """eval.py:_write_tum_calib: a calibration XML in the reference's schema."""
    out_w = out_w or w
    out_h = out_h or h
    with open(path, "w") as f:
        f.write(f"""<?xml version="1.0"?><opencv_storage>
<in_width>{w}</in_width><in_height>{h}</in_height>
<out_width>{out_w}</out_width><out_height>{out_h}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{fx} {fy} {cx} {cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{dist[0]} {dist[1]} {dist[2]} {dist[3]}</data>
</rectification></opencv_storage>""")


def save_gray_png(path, img: torch.Tensor) -> None:
    """eval.py:_save_gray_png: clipped to [0, 255], truncated to 8 bits. The
    PNG is written at zlib level 1 (the same pixels; PIL's default level
    takes ~5x as long on a 640 x 480 frame, ~90 ms)."""
    from PIL import Image

    Image.fromarray(np.clip(img.cpu().numpy(), 0, 255).astype(np.uint8)).save(
        path, compress_level=1)


def renderer_of(root) -> str | None:
    """Who rendered the dataset under `root`: the name in its DONE marker
    (eval.py leaves the marker empty), None while it is not finished."""
    done = Path(root) / "DONE"
    if not done.exists():
        return None
    return done.read_text().strip() or JAX_RENDERER


def _wc_quaternion_translation(poses: torch.Tensor):
    """Ground-truth rows of camera-from-world poses: T_wc's quaternion
    [w, x, y, z] and translation, on the host."""
    from .lie import se3

    q, t = se3.to_quaternion_translation(se3.inverse(poses))
    return q.cpu().numpy(), t.cpu().numpy()


def make_tum_dataset(root: str, n_frames: int, seed: int = 0, noise_sigma: float = 1.5,
                     loop_period: int | None = None, device="cpu") -> dict:
    """eval.py:make_tum_dataset: TUM format, 640 x 480 at fx = fy = 525
    (calibrationTUM.xml), rgb/<ts>.png at 30 Hz, groundtruth.txt and the
    calibration XML, rendered on `device`. Frame i's noise comes from a
    generator seeded seed * 10007 + i (eval.py's key)."""
    from .camera import PinholeCamera
    from .utils.synthetic import apply_photometric, render_scene_view

    out = {"root": root, "gt": os.path.join(root, "groundtruth.txt"),
           "calib": os.path.join(root, "calib.xml"), "rgb": os.path.join(root, "rgb")}
    if renderer_of(root) is None:
        os.makedirs(out["rgb"], exist_ok=True)
        cam = PinholeCamera(**TUM_CAMERA)
        planes = scene("tum")
        poses = trajectory(n_frames, loop_period=loop_period, device=device)
        for i in range(n_frames):
            gen = torch.Generator(device).manual_seed(seed * 10007 + i)
            img = apply_photometric(render_scene_view(cam, poses[i], planes), gen,
                                    noise_sigma=noise_sigma,
                                    gain=float(1.0 + 0.04 * np.sin(0.11 * i)),
                                    bias=float(3.0 * np.sin(0.07 * i + 1.0)))
            save_gray_png(os.path.join(out["rgb"], f"{i / 30.0:012.6f}.png"), img)
        q, t = _wc_quaternion_translation(poses)
        with open(out["gt"], "w") as f:
            f.write("# ground truth trajectory\n# synthetic multi-plane scene\n"
                    "# ts tx ty tz qx qy qz qw\n")
            for i in range(n_frames):
                f.write(f"{i / 30.0:.6f} {t[i, 0]:.6f} {t[i, 1]:.6f} {t[i, 2]:.6f} "
                        f"{q[i, 1]:.6f} {q[i, 2]:.6f} {q[i, 3]:.6f} {q[i, 0]:.6f}\n")
        write_tum_calib(out["calib"], 525.0, 525.0, 319.5, 239.5, 640, 480)
        Path(root, "DONE").write_text(RENDERER + "\n")
    return {**out, "renderer": renderer_of(root)}


def make_euroc_dataset(root: str, n_frames: int, kind: str = "euroc_mh", seed: int = 1,
                       noise_sigma: float = 1.5, device="cpu") -> dict:
    """eval.py:make_euroc_dataset: EUROC format, 752 x 480 with the real MAV0
    cam0 radtan distortion (calibrationEUROC.xml), <root>/cam0/data/<ns>.png
    at 20 Hz, the state ground-truth CSV and the calibration XML (rectified
    to 736 x 480), rendered on `device`. Frame i's noise comes from a
    generator seeded seed * 20011 + i (eval.py's key)."""
    from .camera import PinholeCamera
    from .utils.synthetic import apply_photometric, render_scene_view_distorted

    gt = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
    out = {"root": root, "gt": gt, "calib": os.path.join(root, "calib.xml")}
    if renderer_of(root) is None:
        data = os.path.join(root, "cam0", "data")
        os.makedirs(data, exist_ok=True)
        os.makedirs(os.path.dirname(gt), exist_ok=True)
        k1, k2, p1, p2 = EUROC_DISTORTION
        cam = PinholeCamera(**EUROC_CAMERA, k1=k1, k2=k2, p1=p1, p2=p2)
        planes = scene(kind)
        poses = trajectory(n_frames, scale=1.2, device=device)
        stamps = [int(round(i / 20.0 * 1e9)) for i in range(n_frames)]
        for i in range(n_frames):
            gen = torch.Generator(device).manual_seed(seed * 20011 + i)
            img = apply_photometric(render_scene_view_distorted(cam, poses[i], planes), gen,
                                    noise_sigma=noise_sigma,
                                    gain=float(1.0 + 0.05 * np.sin(0.09 * i + 0.4)),
                                    bias=float(4.0 * np.sin(0.06 * i)))
            save_gray_png(os.path.join(data, f"{stamps[i]:019d}.png"), img)
        q, t = _wc_quaternion_translation(poses)
        with open(gt, "w") as f:
            f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
            for i in range(n_frames):
                f.write(f"{stamps[i]},{t[i, 0]:.6f},{t[i, 1]:.6f},{t[i, 2]:.6f},"
                        f"{q[i, 0]:.6f},{q[i, 1]:.6f},{q[i, 2]:.6f},{q[i, 3]:.6f}\n")
        write_tum_calib(out["calib"], *EUROC_CAMERA.values(), dist=EUROC_DISTORTION,
                        out_w=EUROC_OUT[0], out_h=EUROC_OUT[1])
        Path(root, "DONE").write_text(RENDERER + "\n")
    return {**out, "renderer": renderer_of(root)}


def real_datasets(root: str):
    """eval.py:real_datasets: real TUM and EUROC downloads in
    scripts/fetch_tum_euroc.sh's layout, with the reference calibrations
    written beside each sequence where absent (TUM 640 x 480 at fx = fy =
    525, undistorted; EUROC with the real cam0 radtan coefficients)."""

    def tum(dirname):
        d = os.path.join(root, dirname)
        calib = os.path.join(d, "calib.xml")
        if os.path.isdir(d) and not os.path.exists(calib):
            write_tum_calib(calib, 525.0, 525.0, 319.5, 239.5, 640, 480)
        return {"root": d, "gt": os.path.join(d, "groundtruth.txt"), "calib": calib,
                "rgb": os.path.join(d, "rgb"), "renderer": "real"}

    def euroc(dirname):
        d = os.path.join(root, dirname)
        mav = os.path.join(d, "mav0")
        calib = os.path.join(d, "calib.xml")
        if os.path.isdir(d) and not os.path.exists(calib):
            write_tum_calib(calib, *EUROC_CAMERA.values(), dist=EUROC_DISTORTION,
                            out_w=EUROC_OUT[0], out_h=EUROC_OUT[1])
        return {"root": mav, "gt": os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
                "calib": calib, "renderer": "real"}

    sets = (tum("tum_seq01"), tum("tum_long"), euroc("euroc_mh01"), euroc("euroc_v101"))
    missing = [t["root"] for t in sets if not os.path.isdir(t["root"])]
    if missing:
        print("WARNING: missing real sequences (run scripts/fetch_tum_euroc.sh): "
              f"{missing}", file=sys.stderr)
    return sets


# ------------------------------------------------------------------ execution

# eval.py:308-324's patterns for the CLI's lines.
ATE_RE = re.compile(r"ATE RMSE \(Sim3-aligned\): ([0-9.naife+-]+) m over (\d+)")
FPS_RE = re.compile(r"tracked (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps")
WARM_RE = re.compile(r"steady state: (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps warm")
WBA_RE = re.compile(r"window BA: (\d+) LM iters over (\d+) runs in ([0-9.]+)s "
                    r"\(([0-9.]+) iters/s\)")
DBA_RE = re.compile(r"dist BA: (\d+) kfs, (\d+) landmarks, (\d+) obs over (\d+) devices: "
                    r"(\d+) iters in ([0-9.]+)s \(([0-9.]+) iters/s\), cost "
                    r"([0-9.eE+-]+) -> ([0-9.eE+-]+)( \(not applied\))?")
DBA_SKIP_RE = re.compile(r"dist BA: map too small, skipped")
LOOP_RE = re.compile(r"loop closure: (\d+) edges accepted")
DROP_RE = re.compile(r"ate_rmse dropping (\d+)/(\d+) non-finite")

# eval.py:438-447's flags of the long sequence, its data and platform aside.
LONG_FLAGS = ["--levels", "4", "--mono-depth", "2.5", "--features", "--ba",
              "--depth-bootstrap", "--kf-max-gap", "6", "--kp-per-level", "768",
              "--host-devices", "8"]


def parse_output(out: str) -> dict:
    """eval.py:run_cli's reading of the CLI's output: ATE, frames, fps, warm
    fps, window-BA and global-BA figures, loop edges."""
    res: dict = {}
    m = ATE_RE.search(out)
    if m:
        res["ate_rmse_m"] = float(m.group(1))
        res["ate_poses"] = int(m.group(2))
    m = DROP_RE.search(out)
    if m:
        res["ate_dropped_pairs"] = int(m.group(1))
        res["ate_total_pairs"] = int(m.group(2))
    m = FPS_RE.search(out)
    if m:
        res["frames"] = int(m.group(1))
        res["fps"] = float(m.group(3))
    m = WARM_RE.search(out)
    if m:
        res["fps_warm"] = float(m.group(3))
        res["warm_frames"] = int(m.group(1))
    m = WBA_RE.search(out)
    if m:
        res["window_ba_iters"] = int(m.group(1))
        res["window_ba_iters_per_sec"] = float(m.group(4))
    m = LOOP_RE.search(out)
    if m:
        res["loop_edges"] = int(m.group(1))
    if DBA_SKIP_RE.search(out):
        res["dist_ba_skipped"] = True
    m = DBA_RE.search(out)
    if m:
        res["dist_ba_keyframes"] = int(m.group(1))
        res["dist_ba_landmarks"] = int(m.group(2))
        res["dist_ba_obs"] = int(m.group(3))
        res["dist_ba_devices"] = int(m.group(4))
        res["dist_ba_iters_per_sec"] = float(m.group(7))
        res["dist_ba_cost_initial"] = float(m.group(8))
        res["dist_ba_cost_final"] = float(m.group(9))
        res["dist_ba_applied"] = m.group(10) is None
    return res


def run_cli(cli_args: list[str], platform: str, timeout: int = 3600) -> dict:
    """eval.py:run_cli: the port's CLI in a subprocess on `platform`; its
    figures parsed."""
    cmd = [sys.executable, "-m", "uwslam_tpu_torch"] + cli_args + ["--platform", platform]
    print(f"  $ {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    res: dict = {"rc": proc.returncode, "wall_s": round(time.perf_counter() - t0, 1)}
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        res["error"] = out[-2000:]
        return res
    return {**res, **parse_output(out)}


def configs(tum: dict, tum_long: dict, mh01: dict, v101: dict, n_long: int,
            loop_period: int) -> dict[int, dict]:
    """eval.py:449-558: the eleven configs, their names, what each stands
    for, their datasets and CLI flags (without `--platform`)."""
    long_args = ["-d", tum_long["rgb"], "-c", tum_long["calib"], "--tum-gt",
                 tum_long["gt"]] + LONG_FLAGS
    tum_args = ["-d", tum["rgb"], "-c", tum["calib"], "--tum-gt", tum["gt"]]

    def euroc(ds):
        return ["-d", ds["root"], "--euroc", "-c", ds["calib"], "--euroc-gt", ds["gt"]]

    v101_ba = euroc(v101) + ["--levels", "5", "--mono-depth", "2.5", "--features",
                             "--depth-bootstrap"]
    out = {
        0: ("REFERENCE-SEMANTICS baseline (parity anchor)",
            "reference active pipeline re-measured: <=200 matched keypoints x patches, "
            "identity weights, level-0 GN, 10 iters, z=1, no BA",
            "tum_seq01 (same frames as config 1)", tum, tum_args + ["--reference-mode"]),
        1: ("TUM mono direct tracking (3-level pyramid, no BA)",
            "TUM mono seq01 direct tracking, 3-level pyramid, GN on SE(3), no BA",
            "tum_seq01 (synthetic multi-plane stand-in)", tum,
            tum_args + ["--levels", "3", "--mono-depth", "2.5"]),
        2: ("TUM mono + features/keyframes + depth bootstrap",
            "TUM mono with feature detection + patch matching and keyframe selection",
            "tum_seq01 (same frames as config 1)", tum,
            tum_args + ["--levels", "3", "--mono-depth", "2.5", "--features",
                        "--depth-bootstrap", "--affine", "--bootstrap-shrink", "0.25"]),
        3: ("EUROC MH01 rectified LM tracking (5-level, affine)",
            "EUROC MAV MH_01 with distortion rectification + LM photometric tracking, "
            "5-level pyramid",
            "euroc_mh01 (radtan-distorted synthetic stand-in)", mh01,
            euroc(mh01) + ["--levels", "5", "--mono-depth", "3.0", "--affine",
                           "--depth-bootstrap"]),
        4: ("EUROC V101 sliding-window Schur BA",
            "Keyframe sliding-window bundle adjustment (Schur complement) on EUROC V1_01",
            "euroc_v101 (radtan-distorted synthetic stand-in)", v101, v101_ba + ["--ba"]),
        5: ("Long TUM + loop closure + global distributed BA (8 landmark shards)",
            "Full multi-host run: partitioned keyframe map + distributed pose-graph BA on "
            "long TUM sequence",
            f"tum_long ({n_long} frames, exact revisit at frame {loop_period}; 8 landmark "
            "shards of one process, landmark-sharded Schur BA with summed pose blocks)",
            tum_long, long_args + ["--loop-closure", "--dist-ba"]),
        6: ("ABLATION of 5: no distributed BA (odometry+loop only)",
            "config 5 minus --dist-ba — the dist-BA ATE delta",
            "tum_long (same frames as config 5)", tum_long, long_args + ["--loop-closure"]),
        7: ("ABLATION of 5: no loop closure (odometry+dist-BA only)",
            "config 5 minus --loop-closure — the loop ATE delta",
            "tum_long (same frames as config 5)", tum_long, long_args + ["--dist-ba"]),
        8: ("EUROC MH01 REFERENCE-SEMANTICS anchor",
            "reference active pipeline on the EUROC scene (rectification + level-0 GN, "
            "identity weights, z=1) — the parity bar for config 3",
            "euroc_mh01 (same frames as config 3)", mh01, euroc(mh01) + ["--reference-mode"]),
        9: ("EUROC V101 REFERENCE-SEMANTICS anchor",
            "reference active pipeline on the EUROC V101 scene — the parity bar for config 4",
            "euroc_v101 (same frames as config 4)", v101, euroc(v101) + ["--reference-mode"]),
        10: ("ABLATION of 4: no window BA",
             "config 4 minus --ba — the window-BA ATE delta",
             "euroc_v101 (same frames as config 4)", v101, v101_ba),
    }
    return {i: {"name": n, "baseline": b, "dataset": d, "renderer": ds.get("renderer"),
                "args": a} for i, (n, b, d, ds, a) in out.items()}


def health_checks(results: dict, quick: bool) -> list[str]:
    """eval.py:590-676's checks on a table of results: the failures, each
    also printed as a `HEALTH CHECK FAILED` line."""
    health = []

    def check(cond, msg):
        if not cond:
            health.append(msg)
            print(f"HEALTH CHECK FAILED: {msg}", flush=True)

    for idx in ("5", "7"):
        r = results.get(idx)
        if r is None or r.get("rc") != 0:
            continue
        check(not r.get("dist_ba_skipped"),
              f"config {idx}: distributed BA skipped (map too small)")
        check(r.get("dist_ba_obs", 0) >= 100,
              f"config {idx}: dist BA ran on {r.get('dist_ba_obs', 0)} observations "
              "(needs a real problem)")
        check(r.get("dist_ba_applied", False), f"config {idx}: dist BA result was not applied")
    if "5" in results and "6" in results:
        a5 = results["5"].get("ate_rmse_m")
        a6 = results["6"].get("ate_rmse_m")
        if a5 is not None and a6 is not None:
            check(a5 < a6, f"config 5 ATE ({a5}) not better than no-dist-BA ablation ({a6})")
    if "5" in results:
        check(results["5"].get("loop_edges", 0) > 0,
              "config 5: no loop-closure edges accepted on the revisit trajectory")
    r5 = results.get("5")
    if r5 is not None and r5.get("rc") == 0 and not quick:
        check(r5.get("dist_ba_keyframes", 0) >= 50,
              f"config 5: only {r5.get('dist_ba_keyframes', 0)} keyframes in the global BA "
              "(needs >= 50: distribution-worthy scale)")
        check(r5.get("dist_ba_landmarks", 0) >= 3000,
              f"config 5: only {r5.get('dist_ba_landmarks', 0)} landmarks (needs >= 3000)")
        check(r5.get("dist_ba_obs", 0) >= 10000,
              f"config 5: only {r5.get('dist_ba_obs', 0)} observations (needs >= 10^4)")
    a4 = results.get("4", {}).get("ate_rmse_m")
    a10 = results.get("10", {}).get("ate_rmse_m")
    if a4 is not None and a10 is not None:
        check(a4 < a10, f"config 4 ATE ({a4}) not better than its no-window-BA ablation "
                        f"({a10}) — window BA does not earn its cost")
    for cfg_i, anchor_i in (("3", "8"), ("4", "9")):
        ai = results.get(cfg_i, {}).get("ate_rmse_m")
        aa = results.get(anchor_i, {}).get("ate_rmse_m")
        if ai is not None and aa is not None:
            check(ai < aa, f"config {cfg_i} ATE ({ai}) does not beat its EUROC reference "
                           f"anchor (config {anchor_i}: {aa})")
    a0 = results.get("0", {}).get("ate_rmse_m")
    a12 = [results[k]["ate_rmse_m"] for k in ("1", "2")
           if k in results and "ate_rmse_m" in results[k]]
    if a0 is not None and a12:
        check(min(a12) < a0, f"configs 1-2 (best ATE {min(a12)}) do not beat the "
                             f"reference-semantics anchor (config 0 ATE {a0})")
    a1 = results.get("1", {}).get("ate_rmse_m")
    a2 = results.get("2", {}).get("ate_rmse_m")
    if a1 is not None and a2 is not None:
        check(a2 <= a1 * 1.1, f"config 2 ATE ({a2}) loses to plain direct tracking (config 1: "
                              f"{a1}) — the feature/bootstrap stack subtracts accuracy")
    for idx, r in results.items():
        if idx.startswith("_") or not isinstance(r, dict):
            continue
        drop = r.get("ate_dropped_pairs", 0)
        total = r.get("ate_total_pairs", 0)
        if total:
            check(drop <= 0.02 * total,
                  f"config {idx}: ATE dropped {drop}/{total} non-finite pose pairs (> 2%)")
    return health


def device_identity(platform: str) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU's thread count."""
    if platform == "cuda":
        from .bench import gpu_identity

        return gpu_identity()
    return f"cpu ({torch.get_num_threads()} torch threads)"


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                              capture_output=True, text=True).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def datasets(quick: bool, device) -> tuple[dict, dict, dict, dict]:
    """eval.py:402-436's synthetic datasets (their roots carry the frame
    count) -> (tum, tum_long, mh01, v101)."""
    n_tum, n_euroc, n_long, loop_period = sizes(quick)
    tum = make_tum_dataset(os.path.join(DATA_ROOT, f"tum_seq01_{n_tum}"), n_tum, device=device)
    tum_long = make_tum_dataset(os.path.join(DATA_ROOT, f"tum_long_{n_long}"), n_long, seed=4,
                                loop_period=loop_period, device=device)
    mh01 = make_euroc_dataset(os.path.join(DATA_ROOT, f"euroc_mh01_{n_euroc}"), n_euroc,
                              kind="euroc_mh", device=device)
    v101 = make_euroc_dataset(os.path.join(DATA_ROOT, f"euroc_v101_{n_euroc}"), n_euroc,
                              kind="euroc_v1", seed=2, device=device)
    return tum, tum_long, mh01, v101


def sizes(quick: bool) -> tuple[int, int, int, int]:
    """eval.py:402-412: frames of the TUM, EUROC and long sequences, and the
    long sequence's loop period."""
    return (60, 50, 80, 56) if quick else (150, 120, 640, 160)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=9,
                    help="round number of the RESULTS_TORCH_r<N>.json file name")
    ap.add_argument("--quick", action="store_true", help="shorter sequences")
    ap.add_argument("--configs", default="0,1,2,3,4,5,6,7,8,9,10",
                    help="comma-separated subset to run")
    ap.add_argument("--real", default=None, metavar="ROOT",
                    help="real TUM/EUROC downloads under ROOT (scripts/fetch_tum_euroc.sh's "
                         "layout) instead of the synthetic stand-ins")
    ap.add_argument("--ba-value", action="store_true",
                    help="only the window-BA value study: config 4 with and without --ba "
                         "over 3 dataset seeds -> BA_VALUE_TORCH_r<N>.json")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device of the renders and of every CLI run (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("error: --platform cuda (the default) needs a CUDA card and none is visible; "
              "pass --platform cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")
    if args.ba_value:
        return run_ba_value_study(args, device)
    which = sorted({int(c) for c in args.configs.split(",")})
    if args.real:
        print(f"using real datasets under {args.real}", flush=True)
        tum, tum_long, mh01, v101 = real_datasets(args.real)
    else:
        print("generating datasets...", flush=True)
        tum, tum_long, mh01, v101 = datasets(args.quick, device)
    _, _, n_long, loop_period = sizes(args.quick)
    table = configs(tum, tum_long, mh01, v101, n_long, loop_period)
    identity = device_identity(args.platform)
    commit = _commit()
    measured_at = time.strftime("%Y-%m-%dT%H:%M:%S")

    results = {}
    for idx in which:
        cfg = table[idx]
        print(f"config {idx}: {cfg['name']}", flush=True)
        res = run_cli(cfg["args"], args.platform)
        res.update({"name": cfg["name"], "baseline_config": cfg["baseline"],
                    "dataset": cfg["dataset"], "renderer": cfg["renderer"],
                    "platform": args.platform, "device": identity, "commit": commit,
                    "measured_at": measured_at})
        results[str(idx)] = res
        shown = {k: v for k, v in res.items()
                 if k not in ("name", "baseline_config", "dataset", "error")}
        print(f"  -> {json.dumps(shown)}", flush=True)
        if "error" in res:
            print(res["error"], flush=True)
    health = health_checks(results, args.quick)
    if health:
        results["_health"] = {"failed": health}
    results["_device"] = identity

    out_json = os.path.join(REPO, f"RESULTS_TORCH_r{args.round:02d}.json")
    if os.path.exists(out_json):   # a partial run merges into the table
        with open(out_json) as f:
            prev = json.load(f)
        for k, v in prev.items():
            if not k.startswith("_") and k not in results:
                if isinstance(v, dict) and v.get("commit") != commit:
                    print(f"WARNING: merged config {k} was measured at commit "
                          f"{v.get('commit', 'unknown')} (this run: {commit})", file=sys.stderr)
                results[k] = v
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    write_results_md(results, os.path.join(REPO, "RESULTS_TORCH.md"), identity)
    print(f"wrote {out_json} and RESULTS_TORCH.md")
    return 0


def run_ba_value_study(args, device) -> int:
    """eval.py:run_ba_value_study: config 4's flags with --ba, with --ba and a
    soft pose prior (--ba-prior-weight 1e3), and without --ba, on three
    EUROC V101 stand-ins of different seeds; each seed's ATEs and the mean
    improvement 1 - ATE with / ATE without."""
    n_euroc = sizes(args.quick)[1]
    rows = []
    for seed in (2, 12, 22):
        ds = make_euroc_dataset(os.path.join(DATA_ROOT, f"euroc_v101_{n_euroc}_s{seed}"),
                                n_euroc, kind="euroc_v1", seed=seed, device=device)
        base = ["-d", ds["root"], "--euroc", "-c", ds["calib"], "--euroc-gt", ds["gt"],
                "--levels", "5", "--mono-depth", "2.5", "--features", "--depth-bootstrap"]
        print(f"seed {seed}: with BA", flush=True)
        with_ba = run_cli(base + ["--ba"], args.platform)
        print(f"seed {seed}: with BA, soft prior", flush=True)
        with_soft = run_cli(base + ["--ba", "--ba-prior-weight", "1e3"], args.platform)
        print(f"seed {seed}: without BA", flush=True)
        without = run_cli(base, args.platform)
        rows.append({"seed": seed, "renderer": ds["renderer"],
                     "ate_with_ba": with_ba.get("ate_rmse_m"),
                     "ate_with_ba_soft_prior": with_soft.get("ate_rmse_m"),
                     "ate_without_ba": without.get("ate_rmse_m"),
                     "fps_warm_with_ba": with_ba.get("fps_warm"),
                     "fps_warm_without_ba": without.get("fps_warm"),
                     "ba_iters": with_ba.get("window_ba_iters")})
        print(f"  -> {json.dumps(rows[-1])}", flush=True)
    ok = [r for r in rows if r["ate_with_ba"] is not None and r["ate_without_ba"] is not None]
    imp = [1.0 - r["ate_with_ba"] / r["ate_without_ba"] for r in ok]
    imp_soft = [1.0 - r["ate_with_ba_soft_prior"] / r["ate_without_ba"] for r in ok
                if r["ate_with_ba_soft_prior"] is not None]
    out = {
        "device": device_identity(args.platform),
        "note": "config-4 flags +/- --ba over 3 dataset seeds (EUROC V101 stand-in geometry, "
                "different texture/noise/photometric draws); improvement = 1 - ate_with / "
                "ate_without; soft_prior arm: --ba-prior-weight 1e3 (default 1e5).",
        "rows": rows,
        "improvement_mean": round(float(sum(imp) / max(len(imp), 1)), 4),
        "improvement_min": round(min(imp), 4) if imp else None,
        "improvement_max": round(max(imp), 4) if imp else None,
        "improvement_soft_prior_mean":
            round(float(sum(imp_soft) / len(imp_soft)), 4) if imp_soft else None,
    }
    path = os.path.join(REPO, f"BA_VALUE_TORCH_r{args.round:02d}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}: mean improvement {100 * out['improvement_mean']:.1f}% over "
          f"{len(ok)} seeds")
    return 0


def write_results_md(results: dict, path: str, identity: str) -> None:
    """eval.py:write_results_md for the port's table."""
    lines = [
        "# RESULTS_TORCH — eval.py's staged configs on the PyTorch/CUDA port",
        "",
        f"Produced by `python -m uwslam_tpu_torch.eval` on {identity} (nvidia-smi's name "
        "and power limit). Every config runs the port's CLI on that one device; configs "
        "5-7 hold 8 landmark shards of the global BA in one process (`--host-devices 8`).",
        "",
        "fps columns: `fps` times the whole run including the kernels' first build and "
        "graph captures (cold); `warm fps` excludes the first 15 frames. Config 0 is the "
        "reference-semantics anchor; configs 6 and 7 are ablations of config 5. Window-BA "
        "iters/s divides the solves' LM iterations by their host time.",
        "",
        "Datasets: the synthetic stand-ins of eval.py (multi-plane occluding scenes, sensor "
        "noise, brightness drift, exact ground truth, the TUM and EUROC formats with the "
        "real radtan coefficients); the renderer column says which package drew the frames.",
        "",
        "| # | Config | ATE RMSE (m) | fps | warm fps | BA iters/s | renderer | notes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for idx in sorted((k for k in results if not k.startswith("_")), key=int):
        r = results[idx]
        ate = f"{r['ate_rmse_m']:.4f}" if "ate_rmse_m" in r else "—"
        fps = f"{r['fps']:.1f}" if "fps" in r else "—"
        warm = f"{r['fps_warm']:.1f}" if "fps_warm" in r else "—"
        if "dist_ba_iters_per_sec" in r:
            ba = f"{r['dist_ba_iters_per_sec']:.1f} (dist, {r.get('dist_ba_devices', '?')} shards)"
        elif "window_ba_iters_per_sec" in r:
            ba = f"{r['window_ba_iters_per_sec']:.1f} (window)"
        else:
            ba = "—"
        notes = []
        if "frames" in r:
            notes.append(f"{r['frames']} frames")
        if "dist_ba_landmarks" in r:
            notes.append(f"{r['dist_ba_landmarks']} landmarks/{r['dist_ba_obs']} obs global BA"
                         + ("" if r.get("dist_ba_applied") else " NOT APPLIED"))
        if r.get("dist_ba_skipped"):
            notes.append("dist BA SKIPPED")
        if "loop_edges" in r:
            notes.append(f"{r['loop_edges']} loop edges")
        if r.get("rc") != 0:
            notes.append("FAILED")
        lines.append(f"| {idx} | {r['baseline_config']} | {ate} | {fps} | {warm} | {ba} | "
                     f"{r.get('renderer', '?')} | {'; '.join(notes)} |")
    lines += ["", "ATE is Sim(3)-aligned (monocular scale is known only up to gauge).", ""]
    if "_health" in results:
        lines += ["## HEALTH CHECK FAILURES", ""]
        lines += [f"- {m}" for m in results["_health"]["failed"]]
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    raise SystemExit(main())
