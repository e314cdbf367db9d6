"""The JAX CLI's README configs 5 and 6 on the CPU, under several XLA
instruction sets: how far the JAX package's own runs of one input part,
beside the port's CLI on the same files at several thread counts.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/jax_config5_spread.py [--configs 5,6]
        [--isas default,AVX2,AVX,SSE4_2] [--port-threads 8,2] [--frames 80]
        [--loop-period 56] [--jobs 3] [--out FILE.json]

It renders eval.py's `tum_long` sequence with eval.py's own maker (default
its quick size: 80 frames, loop period 56, seed 4) under `$UWSLAM_EVAL_DATA`
(default /tmp/uwslam_eval) as `tum_long_<frames>`. A directory there that
already holds a dataset (its DONE marker) is read as it is, so the same runs
can be made on frames another renderer drew: the port's render on a card
(`python scripts/chip_phases.py frames DIR`). Then it runs the JAX CLI on it
with eval.py:439-447's flags plus config 5's `--loop-closure --dist-ba` or
config 6's `--loop-closure` (`--platform cpu --host-devices 8`), once under
each instruction set (`XLA_FLAGS=--xla_cpu_max_isa=...`; "default" is XLA's
own choice); with `--port-threads` also the port's CLI (`uwslam_tpu_torch`,
`--platform cpu`, 8 landmark shards) on the same files with torch at each
thread count. Every run is a process of its own, `--jobs` of them at a time,
and the port's never imports JAX. For each run it prints one JSON line: the
ATE (m, Sim(3)-aligned, unrounded), the keyframes, the loop edges accepted,
the global BA's LM iterations, cost, landmarks and observations, and the
seconds the run took; the last line holds every run.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

QUICK_FRAMES = 80
QUICK_LOOP_PERIOD = 56
SEED = 4                                  # eval.py's tum_long seed
CONFIG_FLAGS = {5: ["--loop-closure", "--dist-ba"], 6: ["--loop-closure"]}


def long_args(ds: dict, config: int = 5) -> list[str]:
    """eval.py:438-447's flags for the long sequence, then the config's."""
    return ["-d", ds["rgb"], "-c", ds["calib"], "--tum-gt", ds["gt"], "--levels", "4",
            "--mono-depth", "2.5", "--features", "--ba", "--depth-bootstrap",
            "--kf-max-gap", "6", "--kp-per-level", "768", "--platform", "cpu",
            "--host-devices", "8", *CONFIG_FLAGS[config]]


def child(argv: list[str], port_threads: int | None = None) -> None:
    """One run of the JAX CLI (or, given `port_threads`, of the port's) in
    this process, with its system and its ATE recorded: one JSON line."""
    if port_threads is None:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import uwslam_tpu.io as jio
        import uwslam_tpu.system as jsystem
        from uwslam_tpu.cli.main import main as cli_main
    else:
        import torch

        torch.set_num_threads(port_threads)
        import uwslam_tpu_torch.io as jio
        import uwslam_tpu_torch.system as jsystem
        from uwslam_tpu_torch.cli.main import main as cli_main

    made, ate, stats = [], [], []
    original_ate = jio.ate_rmse

    def recorded_ate(*a, **kw):
        ate.append(float(original_ate(*a, **kw)))
        return ate[-1]

    class Recorded(jsystem.SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def run_global_distributed_ba(self, *a, **kw):
            stats.append(super().run_global_distributed_ba(*a, **kw))
            return stats[-1]

    jio.ate_rmse = recorded_ate
    jsystem.SlamSystem = Recorded
    t0 = time.perf_counter()
    rc = cli_main(argv)
    system = made[0]
    g = stats[0] if stats and stats[0] is not None else {}
    print(json.dumps({
        "rc": rc, "ate_m": ate[0] if ate else None,
        "keyframes": [s.frame_id for s in system.trajectory if s.is_keyframe],
        "loop_edges": len(system._loops.loop_edges) if system._loops is not None else None,
        "global_ba_iterations": g.get("iterations"),
        "global_ba_cost": [g.get("initial_cost"), g.get("final_cost")],
        "global_ba_landmarks": g.get("landmarks"),
        "global_ba_observations": g.get("observations"),
        "seconds": round(time.perf_counter() - t0, 1),
    }))


def run(job, ds) -> dict:
    """One child process: (name, config, instruction set or None, mode)."""
    name, config, isa, mode = job
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if isa and isa != "default":
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + f" --xla_cpu_max_isa={isa}").strip()
    proc = subprocess.run([sys.executable, __file__, *mode, *long_args(ds, config)], env=env,
                          cwd=REPO, capture_output=True, text=True)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
    out = json.loads(line) if proc.returncode == 0 else {
        "rc": proc.returncode, "error": proc.stderr[-2000:]}
    print(json.dumps({"run": name, **out}), flush=True)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default="5", help="comma-separated: 5 and / or 6")
    p.add_argument("--isas", default="default,AVX2",
                   help="comma-separated XLA instruction sets of the JAX runs (none: '')")
    p.add_argument("--port-threads", default="",
                   help="comma-separated torch thread counts of the port's runs")
    p.add_argument("--frames", type=int, default=QUICK_FRAMES)
    p.add_argument("--loop-period", type=int, default=QUICK_LOOP_PERIOD)
    p.add_argument("--jobs", type=int, default=1, help="runs at a time")
    p.add_argument("--out", default=None, help="also write the runs to this JSON file")
    args = p.parse_args()

    import eval as jeval

    root = os.path.join(jeval.DATA_ROOT, f"tum_long_{args.frames}")
    ds = jeval.make_tum_dataset(root, args.frames, seed=SEED, loop_period=args.loop_period)
    renderer = Path(root, "DONE").read_text().strip() or "uwslam_tpu (eval.py)"
    jobs = []
    for c in (int(x) for x in args.configs.split(",")):
        jobs += [(f"config {c} jax {isa}", c, isa, ["--child"])
                 for isa in args.isas.split(",") if isa]
        jobs += [(f"config {c} port {n} threads", c, None, ["--port-child", n])
                 for n in args.port_threads.split(",") if n]
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda job: run(job, ds), jobs))
    runs = {job[0]: r for job, r in zip(jobs, done)}
    out = {"frames": args.frames, "loop_period": args.loop_period, "data": root,
           "renderer": renderer, "runs": runs}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2:])
    elif sys.argv[1:2] == ["--port-child"]:
        child(sys.argv[3:], port_threads=int(sys.argv[2]))
    else:
        main()
