"""The landmark-sharded global BA at a fixed budget over 1, 2, 4 and 8 shards
of one process on one card.

    python -m uwslam_tpu_torch.scaling [--out SCALING_TORCH_r10.json] [--solver auto|direct|pcg]
                                       [--platform cuda|cpu]

Counterpart of `benchmarks/scaling.py` (the JAX package's, which ran the
shards on an 8-virtual-device CPU mesh). Here the shards are a tensor axis
of one process (`parallel.runtime.landmark_layout(n)`), solved by
`parallel.dist_ba.distributed_bundle_adjust(..., full_budget=True)`: every
row runs exactly `MAX_ITERS` LM iterations, so the shard counts compare like
for like. Two curves, the JAX script's: "wide" (16 poses x 16,384
landmarks) and "session-map" (64 x 8,192), each problem from
`make_problem` (the JAX script's numpy draws in its order; the initial poses
through the port's `lie.se3`).

Per row, the JAX script's keys (`devices` is its name for the shard count)
and these: `seconds` is the median of `RUNS` solves after a warm-up solve
(CUDA events on a card, the host's clock on the CPU); `shard_compute_s` the
same for shard 0 alone as a one-shard problem (`shard_slice`), the per-shard
anchor; `work_division_pct` = T_shard(1) / (n T_shard(n)), how evenly the
sharded solve divides its work; `efficiency_pct_one_card_tensor_axis`
(the JAX script's `efficiency_pct_virtual_substrate`) what one card gains
from its shard axis; `comm_bytes_per_iter` the analytic payload of the sum
over the shards by the JAX formulas for `direct` and `pcg` (in one process
no all-reduce crosses processes: the sum is a tensor reduction);
`max_memory_allocated` the card's peak bytes over the row. The result names
the card and its power limit. It is one card's shard-count curve: no
multi-GPU figure. A card is the default and there is no fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .ba.schur import BAProblem
from .camera.model import PinholeCamera
from .lie import se3
from .parallel import distributed_bundle_adjust, landmark_layout, shard_problem

MAX_ITERS = 30
RUNS = 3
SHARD_COUNTS = (1, 2, 4, 8)
CURVES = ((16, 16384, "wide"), (64, 8192, "session-map"))
CAM = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def make_problem(M: int, L: int, obs_per_lm: int = 6, seed: int = 0, device="cpu"):
    """Synthetic global-BA problem -> (BAProblem on `device`, camera,
    observations): cameras on an arc looking inward, landmarks in the
    volume, observations perturbed by 0.5 px noise and the poses by
    odometry-like drift. `benchmarks/scaling.py:make_problem`'s draws."""
    rng = np.random.default_rng(seed)
    T_cw_gt = []
    for i in range(M):
        a = 2 * np.pi * i / M * 0.25  # quarter arc: neighbors co-visible
        C = np.array([4 * np.sin(a), 0.2 * np.sin(3 * a), -4 * np.cos(a)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=1)
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ C
        T_cw_gt.append(T)
    T_cw_gt = np.stack(T_cw_gt)

    pts = rng.uniform([-1.5, -1.0, -1.5], [1.5, 1.0, 1.5], (L, 3))

    obs_kf, obs_lm, obs_uv = [], [], []
    for lm in range(L):
        base = rng.integers(0, M)
        for k in range(obs_per_lm):
            m = (base + k) % M
            pc = T_cw_gt[m][:3, :3] @ pts[lm] + T_cw_gt[m][:3, 3]
            if pc[2] < 0.5:
                continue
            u = 525.0 * pc[0] / pc[2] + 319.5 + rng.normal(0, 0.5)
            v = 525.0 * pc[1] / pc[2] + 239.5 + rng.normal(0, 0.5)
            if 0 <= u < 640 and 0 <= v < 480:
                obs_kf.append(m)
                obs_lm.append(lm)
                obs_uv.append((u, v))
    O = len(obs_kf)

    xis = []
    for i in range(M):
        drift = 0.02 * i / M
        xis.append(np.concatenate([
            rng.normal(0, drift, 3), rng.normal(0, drift * 0.3, 3)
        ]).astype(np.float32))
    T_cw0 = se3.compose(se3.exp(torch.from_numpy(np.stack(xis))),
                        torch.from_numpy(T_cw_gt.astype(np.float32)))
    pts0 = pts + rng.normal(0, 0.05, pts.shape)

    problem = BAProblem(
        T_cw=T_cw0,
        points=torch.from_numpy(pts0.astype(np.float32)),
        obs_kf=torch.tensor(obs_kf, dtype=torch.int64),
        obs_lm=torch.tensor(obs_lm, dtype=torch.int64),
        obs_uv=torch.tensor(np.array(obs_uv), dtype=torch.float32),
        obs_valid=torch.ones(O, dtype=torch.bool),
    )
    return BAProblem(*(t.to(device) for t in problem)), CAM, O


def shard_slice(sharded: BAProblem, n: int) -> BAProblem:
    """Shard 0 of an n-shard problem as a problem of its own (same M, L/n
    landmarks, O/n observations): the per-shard compute anchor."""
    L = sharded.points.shape[0] // n
    O = sharded.obs_kf.shape[0] // n
    return BAProblem(T_cw=sharded.T_cw, points=sharded.points[:L], obs_kf=sharded.obs_kf[:O],
                     obs_lm=sharded.obs_lm[:O], obs_uv=sharded.obs_uv[:O],
                     obs_valid=sharded.obs_valid[:O])


def comm_bytes(M: int, solver: str) -> tuple[int, str]:
    """The JAX script's analytic f32 payload of the sum over the shards per
    LM iteration, and its note."""
    if solver == "pcg":
        return 4 * (M * 36 + M * 6 + M * 36 + M * 6 + 4), (
            "per LM iter, + M*24 B per CG step (<=64 steps); analytic payload of the shard sum")
    return 4 * (M * M * 36 + M * 36 + 2 * M * 6 + 4), (
        "per LM iter (S_red dominates, O(M^2)); analytic payload of the shard sum")


def timed_solve(problem: BAProblem, n: int, cam, solver: str, runs: int, max_iters: int):
    """(result, iterations, seconds) of the median of `runs` solves of an
    n-shard problem after a warm-up solve."""
    cuda = problem.T_cw.device.type == "cuda"

    def run():
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = distributed_bundle_adjust(problem, cam, landmark_layout(n), max_iters=max_iters,
                                        huber_delta=2.0, num_fixed_poses=2, full_budget=True,
                                        solver=solver)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        return out, int(out.iterations), seconds

    run()
    results = sorted((run() for _ in range(runs)), key=lambda r: r[2])
    return results[len(results) // 2]


def run_curve(problem, cam, O, M, L, label, solver="auto", runs=RUNS,
              shard_counts=SHARD_COUNTS, max_iters=MAX_ITERS) -> list[dict]:
    print(f"[{label}] {M} poses, {L} landmarks, {O} observations", file=sys.stderr)
    cuda = problem.T_cw.device.type == "cuda"
    comm, comm_note = comm_bytes(M, solver)
    rows = []
    for n in shard_counts:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sharded = shard_problem(problem, n)
        out, iters, dt = timed_solve(sharded, n, cam, solver, runs, max_iters)
        _, _, dt_shard = timed_solve(shard_problem(shard_slice(sharded, n), 1), 1, cam, solver,
                                     runs, max_iters)
        ips = iters / max(dt, 1e-9)
        if not rows:
            ips1, tshard1 = ips, dt_shard
        rows.append({
            "devices": n,
            "iterations": iters,
            "seconds": dt,
            "iters_per_sec": ips,
            "speedup_vs_1dev": ips / ips1,
            "efficiency_pct_one_card_tensor_axis": ips / (ips1 * n) * 100.0,
            "shard_compute_s": dt_shard,
            "work_division_pct": tshard1 / (n * dt_shard) * 100.0,
            "solver": "pcg" if solver == "pcg" else "direct",
            "comm_bytes_per_iter": comm,
            "comm_note": comm_note,
            "cost_initial": float(out.initial_cost),
            "cost_final": float(out.cost),
            "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None,
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def curves(device, solver: str = "auto", runs: int = RUNS, sizes=CURVES) -> dict:
    out = {}
    for M, L, label in sizes:
        problem, cam, O = make_problem(M, L, device=device)
        rows = run_curve(problem, cam, O, M, L, label, solver=solver, runs=runs)
        costs = [r["cost_final"] for r in rows]
        out[label] = {"problem": {"poses": M, "landmarks": L, "observations": O,
                                  "max_iters": MAX_ITERS},
                      "scaling": rows,
                      "cost_final_spread": (max(costs) - min(costs)) / min(costs)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="SCALING_TORCH_r10.json")
    ap.add_argument("--solver", default="auto", choices=("auto", "direct", "pcg"))
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) times on the card; cpu on the host's clock")
    args = ap.parse_args(argv)
    cuda = args.platform == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("scaling: --platform cuda (the default) needs a CUDA card and none "
                         "is visible")
    from .offline_budget import identity

    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    out = {
        "device": identity(cuda),
        "note": ("One H100, the landmark shards a tensor axis of one process: "
                 "efficiency_pct_one_card_tensor_axis is what one card gains from its shard "
                 "axis, work_division_pct how evenly the shards divide the work, "
                 "comm_bytes_per_iter the analytic payload of the shard sum. No multi-GPU "
                 f"figure. Every row runs {MAX_ITERS} LM iterations (full_budget); seconds "
                 f"are the median of {RUNS} solves." if cuda else
                 "CPU run: host clock, shards a tensor axis of one process."),
        "curves": curves(dev, solver=args.solver),
    }
    text = json.dumps(out, indent=2)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)
    print(f"wrote {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
