"""Phase 20's runs one by one, as the CLI runs them, with the port's CPU run
of config 5 at two thread counts and an eager pose-graph solve timed.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: `python scripts/chip_phase20_parts.py` (~13 minutes on an H100,
most of it the two CPU runs). Each part prints its name, ok or FAILED, its
seconds and its JSON result; a failing part does not stop the next. The
parts: the kernels' build; the 8-shard solve (`chip_smoke.phase_dist_ba`);
a Sim(3) pose graph of 48 x 64 and of 128 x 256 nodes x edges solved
eagerly; config 5 at the quick size twice on the card, configs 6 and 7,
config 5 at full size (all with the CLI's own window-BA retirement); config
5 at the quick size on the CPU with the default thread count and with 2
threads, each against the first card run.
"""
from __future__ import annotations

import json
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
from uwslam_tpu_torch.ops import _lib  # noqa: E402


def part(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        print(f"[{name}] ok {time.perf_counter() - t0:.1f} s {json.dumps(out, default=str)}",
              flush=True)
        return out
    except Exception:
        print(f"[{name}] FAILED {time.perf_counter() - t0:.1f} s\n{traceback.format_exc()}",
              flush=True)
        return None


def pose_graph_timing(dev) -> dict:
    """Eager Sim(3) pose-graph solves of two bucket shapes: s and passes."""
    from uwslam_tpu_torch.ba import pose_graph as pg
    from uwslam_tpu_torch.lie import sim3

    out = {}
    for M, E in ((48, 64), (128, 256)):
        rng = np.random.default_rng(0)
        S = sim3.exp(torch.from_numpy((0.1 * rng.standard_normal((M, 7))).astype(np.float32)))
        ei = torch.arange(E, dtype=torch.int32) % (M - 1)
        noise = sim3.exp(torch.from_numpy((0.01 * rng.standard_normal((E, 7))).astype(np.float32)))
        S_ij = sim3.compose(sim3.compose(sim3.inverse(S[ei.long()]), S[(ei + 1).long()]), noise)
        graph = pg.Sim3PoseGraph(*(x.to(dev) for x in (
            S, ei, ei + 1, S_ij, torch.full((E,), 100.0), torch.ones(E, dtype=torch.bool))))
        pg.optimize_pose_graph_sim3(graph, max_iters=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pg.optimize_pose_graph_sim3(graph)
        out[f"{M}x{E}"] = {"s": time.perf_counter() - t0, "iterations": int(res.iterations)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase20_parts: no CUDA card is visible")
    print(bench.gpu_identity(), flush=True)
    part("build", lambda: [str(x) for x in _lib.build()[:2]])
    dev = torch.device("cuda", 0)
    table = cs.kernels_table()
    part("d dist ba", lambda: cs.phase_dist_ba(dev))
    part("pose graph timing", lambda: pose_graph_timing(dev))
    runs = {}

    def run(name, *args):
        runs[name] = cs.run_loop_config(*args)
        return cs.strip_poses(runs[name])

    def cpu(threads):
        old = torch.get_num_threads()
        torch.set_num_threads(threads or old)
        try:
            return run(f"cpu{threads}", quick, 5, "cpu")
        finally:
            torch.set_num_threads(old)

    def against_card(name):
        a, c = runs["a5"], runs[name]
        return {"pose_gap": cs.loop_pose_gap(a["_poses"], c["_poses"]),
                "keyframes_equal": a["keyframes"] == c["keyframes"],
                "ate": [a["ate"], c["ate"]], "dist_ba": [a["dist_ba"], c["dist_ba"]]}

    with tempfile.TemporaryDirectory() as tmp:
        quick = cs.write_tum_sequence(Path(tmp) / "quick", cs.QUICK_FRAMES,
                                      cs.QUICK_LOOP_PERIOD, dev)
        part("a card 5", lambda: run("a5", quick, 5, "cuda"))
        part("a card 5 again", lambda: run("a5b", quick, 5, "cuda"))
        part("b card 6", lambda: run("b6", quick, 6, "cuda"))
        part("b card 7", lambda: run("b7", quick, 7, "cuda"))
        full = cs.write_tum_sequence(Path(tmp) / "full", cs.FULL_FRAMES, cs.FULL_LOOP_PERIOD, dev)
        part("c card 5 full", lambda: run("c5", full, 5, "cuda", table))
        part("a cpu 5", lambda: cpu(0))
        part("compare", lambda: {"card_bit_equal": bool(np.array_equal(
            runs["a5"]["_poses"], runs["a5b"]["_poses"])), **against_card("cpu0")})
        part("a cpu 5 (2 threads)", lambda: cpu(2))
        part("compare 2 threads", lambda: against_card("cpu2"))


if __name__ == "__main__":
    main()
