"""Config 5 at full size (`chip_smoke.py` phase 20(c)) run again and again,
with every pose that enters the loop closer, the keyframe poses or the live
corrections checked to be a rigid motion.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_config5_repeat.py [SECONDS]` (~90 s per run on
an H100). It prints the card's name and power limit, then one line per run:
its host-side jitter (a random sleep of up to that many ms before each frame
call, which moves the frame a window solve lands on), ok or FAILED, its
seconds, ATE, keyframes, loop edges, window solves, pose-graph solves, the
global BA's line and frames/s. A pose whose rotation block is off SO(3) by
more than 1e-4 (the largest entry of R^T R - I), or that is not finite, stops
the run with the place it entered. No run starts after SECONDS (default 560).
"""
from __future__ import annotations

import random
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from uwslam_tpu_torch import bench  # noqa: E402
from uwslam_tpu_torch import system as port_system  # noqa: E402
from uwslam_tpu_torch.map import loop_closure as lc  # noqa: E402
from uwslam_tpu_torch.ops import _lib  # noqa: E402

RIGID_ATOL = 1e-4
JITTER_MS = (0.0, 4.0, 0.0, 8.0, 2.0, 0.0, 6.0)
EVENTS: list = []


def not_rigid(T) -> str | None:
    T = np.asarray(T, np.float64)
    if not np.isfinite(T).all():
        return "not finite"
    off = float(np.abs(T[:3, :3].T @ T[:3, :3] - np.eye(3)).max())
    if off > RIGID_ATOL or not np.allclose(T[3], [0, 0, 0, 1], atol=RIGID_ATOL):
        return f"R^T R - I off by {off}, last row {T[3]}"
    return None


def check(where: str, T, what: str = "") -> None:
    why = not_rigid(T)
    if why:
        raise AssertionError(f"{where} {what}: {why}\n{np.asarray(T)}")


def wrap(cls, name, before=None, after=None):
    original = getattr(cls, name)

    def wrapped(self, *args, **kw):
        if before:
            before(self, *args, **kw)
        out = original(self, *args, **kw)
        if after:
            after(self, out, *args, **kw)
        return out

    setattr(cls, name, wrapped)


def install_checks() -> None:
    S, L = port_system.SlamSystem, lc.LoopCloser
    wrap(L, "add_keyframe", before=lambda self, kf: (
        check("add_keyframe", lc._host(kf.T_wc), f"frame {kf.frame_id}"),
        self.history and check("history", self.history[-1].T_wc)))
    wrap(L, "update_poses", after=lambda self, out, refined: [
        check("update_poses", r.T_wc, f"frame {r.frame_id}") for r in self.history])
    wrap(L, "optimize", after=lambda self, out: (
        EVENTS.append("pgo"), [check("optimize", T, f"frame {f}") for f, T in out.items()]))
    wrap(S, "_push_correction", before=lambda self, C: check("correction", C))
    wrap(S, "_retire_solve",
         before=lambda self, wait=False: EVENTS.append(self._ba_inflight is not None),
         after=lambda self, out, wait=False: (
             EVENTS.append("solve" if EVENTS.pop() and self._ba_inflight is None else None),
             [check("window BA write-back", T, f"frame {f}") for f, T in self._kf_poses.items()]))
    wrap(S, "_retire_pipelined", after=lambda self, st, *a, **k: (
        st.status == "ok" and check("retired frame", st.T_wc, f"frame {st.frame_id}")))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_config5_repeat: no CUDA card is visible")
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 560.0
    t_start = time.perf_counter()
    print(bench.gpu_identity(), flush=True)
    _lib.build()
    install_checks()
    jitter = {"ms": 0.0}
    original = port_system.SlamSystem.process_frame_async

    def jittered(self, *args, **kw):
        if jitter["ms"]:
            time.sleep(random.random() * jitter["ms"] / 1e3)
        return original(self, *args, **kw)

    port_system.SlamSystem.process_frame_async = jittered
    dev = torch.device("cuda", 0)
    table = cs.kernels_table()
    with tempfile.TemporaryDirectory() as tmp:
        full = cs.write_tum_sequence(Path(tmp) / "full", cs.FULL_FRAMES, cs.FULL_LOOP_PERIOD, dev)
        for i, ms in enumerate(JITTER_MS):
            if time.perf_counter() - t_start > budget:
                break
            jitter["ms"] = ms
            random.seed(i)
            EVENTS.clear()
            t0 = time.perf_counter()
            try:
                r = cs.run_loop_config(full, 5, "cuda", table)
                print(f"run {i} jitter {ms} ms: ok {time.perf_counter() - t0:.1f} s "
                      f"ATE {r['ate']} keyframes {len(r['keyframes'])} "
                      f"loop edges {r.get('loop_edges')} window solves {EVENTS.count('solve')} "
                      f"pose graphs {EVENTS.count('pgo')} global BA {r.get('dist_ba')} "
                      f"frames/s {r.get('frames_per_s')}", flush=True)
            except Exception:
                print(f"run {i} jitter {ms} ms: FAILED {time.perf_counter() - t0:.1f} s\n"
                      f"{traceback.format_exc()[-4000:]}", flush=True)
    print(f"done {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
