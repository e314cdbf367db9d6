"""eval.py's config 0 (uw-slam's reference mode) through the port's CLI on
one device, with every frame's stages fingerprinted: where two runs of the
same PNG files part.

Config 0 matches features and runs F-RANSAC on every frame, synchronously:
ingest -> pyramid (K1) -> corners and descriptors -> ratio-tested matches ->
F-RANSAC inliers -> patch points -> tracking -> pose. For each frame this
records, per stage, a SHA-256 of the stage's tensors (bit-exact identity)
beside readable summaries (keypoints, matches, inliers, the pose, status and
keyframe flag).

    python scripts/config0_frames.py run DATASET_DIR --platform cuda|cpu --out FILE.json
        [--threads N] [--unfused]
    python scripts/config0_frames.py compare A.json B.json

DATASET_DIR is one of eval.py's TUM datasets (`rgb/`, `calib.xml`,
`groundtruth.txt`): eval.py's `make_tum_dataset` render or the port's.
`compare` prints the first frame at which each stage's fingerprint differs,
the first frame whose matches, inliers, keyframe flag or status differ, and
the largest |se3.log| gap of the poses up to and after that frame.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = ("image", "pyramid", "keypoints", "descriptors", "matches", "ransac", "patch_points",
          "pose")


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().contiguous()
        h.update(str(a.dtype).encode())
        h.update(a.numpy().tobytes() if a.dtype != torch.bool else a.to(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def run(data: Path, platform: str, threads: int | None, unfused: bool = False) -> dict:
    if threads:
        torch.set_num_threads(threads)
    from uwslam_tpu_torch import system as port_system
    from uwslam_tpu_torch.cli.main import main as cli_main
    from uwslam_tpu_torch.tracking import photometric

    # With `unfused` every LM evaluation takes K2 and the plain normal
    # equations (summed by torch.einsum) instead of `lm_evaluate`, whose
    # block sums run in another order: how far that order moves the run.
    saved_kinds = photometric.FUSED_KINDS
    if unfused:
        photometric.FUSED_KINDS = ()

    frames: list[dict] = []
    cur: dict = {}
    original = {n: getattr(port_system, n) for n in ("match_descriptors", "fundamental_ransac",
                                                      "patch_points")}

    def match_descriptors(*a, **kw):
        m = original["match_descriptors"](*a, **kw)
        cur["matches"] = {"sha": _sha(m.idx_a, m.idx_b, m.valid), "n": int(m.valid.sum()),
                          "score_sha": _sha(m.score)}
        return m

    def fundamental_ransac(*a, **kw):
        r = original["fundamental_ransac"](*a, **kw)
        cur["ransac"] = {"sha": _sha(r.F, r.inliers), "F": r.F.double().cpu().tolist(),
                         "inliers_sha": _sha(r.inliers), "n": int(r.inliers.sum()),
                         "ok": bool(r.ok)}
        return r

    def patch_points(*a, **kw):
        p = original["patch_points"](*a, **kw)
        cur["patch_points"] = {"sha": _sha(p.uv, p.p3d, p.valid), "n": int(p.valid.sum())}
        return p

    class Recorded(port_system.SlamSystem):
        def _ingest_pyramid(self, image):
            pyr = super()._ingest_pyramid(image)
            cur["image"] = {"sha": _sha(pyr.images[0])}
            cur["pyramid"] = {"sha": _sha(*pyr.images, *pyr.grad_x, *pyr.grad_y, *pyr.grad_mag)}
            return pyr

        def _detect_features(self, pyr):
            kps, desc = super()._detect_features(pyr)
            cur["keypoints"] = {"sha": _sha(kps.uv, kps.level, kps.valid),
                                "n": int(kps.valid.sum())}
            cur["descriptors"] = {"sha": _sha(desc)}
            return kps, desc

        def process_frame(self, *a, **kw):
            cur.clear()
            state = super().process_frame(*a, **kw)
            rec = {k: dict(v) for k, v in cur.items()}
            rec["pose"] = {"sha": _sha(torch.from_numpy(np.ascontiguousarray(state.T_wc)))}
            rec.update(frame=state.frame_id, status=state.status, keyframe=state.is_keyframe,
                       tracked_inliers=state.tracked_inliers,
                       track_error=float(state.track_error),
                       T_wc=np.asarray(state.T_wc, np.float64).tolist())
            frames.append(rec)
            return state

    argv = ["-d", str(data / "rgb"), "-c", str(data / "calib.xml"),
            "--tum-gt", str(data / "groundtruth.txt"), "--reference-mode",
            "--platform", platform]
    for n, fn in (("match_descriptors", match_descriptors),
                  ("fundamental_ransac", fundamental_ransac), ("patch_points", patch_points)):
        setattr(port_system, n, fn)
    saved = port_system.SlamSystem
    port_system.SlamSystem = Recorded
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
    finally:
        port_system.SlamSystem = saved
        photometric.FUSED_KINDS = saved_kinds
        for n, fn in original.items():
            setattr(port_system, n, fn)
    m = re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.eE+naif-]+) m", buf.getvalue())
    if rc != 0 or m is None:
        raise SystemExit(f"config 0 failed: exit {rc}\n{buf.getvalue()}\n{err.getvalue()[-3000:]}")
    device = (torch.cuda.get_device_name(0) if platform == "cuda"
              else f"cpu, {torch.get_num_threads()} threads")
    return {"platform": platform, "device": device, "torch": torch.__version__,
            "lm_evaluation": "K2 + einsum" if unfused else "lm_evaluate",
            "ate": float(m.group(1)), "seconds": round(time.perf_counter() - t0, 1),
            "data": str(data), "frames": frames}


def _log_gap(A, B) -> float:
    from uwslam_tpu_torch.lie import se3

    d = se3.log(se3.compose(se3.inverse(torch.tensor(A)), torch.tensor(B)))
    return float(d.abs().max())


def compare(a: dict, b: dict) -> dict:
    fa, fb = a["frames"], b["frames"]
    n = min(len(fa), len(fb))
    first = {}
    for s in STAGES:
        first[s] = next((fa[i]["frame"] for i in range(n)
                         if s in fa[i] and s in fb[i] and fa[i][s]["sha"] != fb[i][s]["sha"]), None)
    counts = {}
    for key, get in (("matches", lambda r: r.get("matches", {}).get("n")),
                     ("inlier_set", lambda r: r.get("ransac", {}).get("inliers_sha")),
                     ("inliers", lambda r: r.get("ransac", {}).get("n")),
                     ("keyframe", lambda r: r["keyframe"]), ("status", lambda r: r["status"])):
        counts[key] = next((fa[i]["frame"] for i in range(n) if get(fa[i]) != get(fb[i])), None)
    gaps = [_log_gap(fa[i]["T_wc"], fb[i]["T_wc"]) for i in range(n)]
    k = first["pose"]
    return {"a": [a["device"], a["ate"]], "b": [b["device"], b["ate"]], "frames": n,
            "first_frame_differing_by_stage": first, "first_frame_differing": counts,
            "pose_gap_before_first_pose_difference": max(gaps[:k], default=0.0) if k else 0.0,
            "pose_gap_max": max(gaps, default=0.0),
            "pose_gap_at": {str(fa[i]["frame"]): gaps[i] for i in range(n)
                            if i % 10 == 0 or i == n - 1},
            "first_differing_frame_detail": None if k is None else
            {"a": {s: fa[k].get(s) for s in STAGES}, "b": {s: fb[k].get(s) for s in STAGES}}}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("data", type=Path)
    r.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    r.add_argument("--threads", type=int, default=None)
    r.add_argument("--unfused", action="store_true",
                   help="evaluate LM steps by K2 and einsum, not lm_evaluate")
    r.add_argument("--out", type=Path, required=True)
    c = sub.add_parser("compare")
    c.add_argument("a", type=Path)
    c.add_argument("b", type=Path)
    args = p.parse_args()
    if args.cmd == "run":
        if args.platform == "cuda" and not torch.cuda.is_available():
            raise SystemExit("config0_frames: no CUDA card is visible")
        out = run(args.data, args.platform, args.threads, args.unfused)
        args.out.write_text(json.dumps(out))
        print(json.dumps({k: v for k, v in out.items() if k != "frames"}))
    else:
        print(json.dumps(compare(json.loads(args.a.read_text()), json.loads(args.b.read_text())),
                         indent=1))


if __name__ == "__main__":
    main()
