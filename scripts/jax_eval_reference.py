"""The JAX CLI on eval.py's own frames, on the CPU: the reference figures of
configs 0-4 and 8-10 that `chip_smoke.py` phase 24 and the port's
evaluation (`python -m uwslam_tpu_torch.eval`) are compared with.

Run from the repository root:

    JAX_PLATFORMS=cpu UWSLAM_EVAL_DATA=DIR python scripts/jax_eval_reference.py \
        [--configs 0,1,2,3,4,8,9,10] [--quick] [--seed-offset K] --out FILE.json

It renders the datasets with eval.py's own makers (`make_tum_dataset`,
`make_euroc_dataset`, called directly, so eval.py's `main()` never runs and
writes no RESULTS file) under `$UWSLAM_EVAL_DATA` (default
/tmp/uwslam_eval): 150 TUM frames and 120 frames of each EUROC scene, or
eval.py's quick sizes (60 / 50) with `--quick`. Each config then runs
through the JAX CLI (`python -m uwslam_tpu`, eval.py's `run_cli`) with
eval.py:449-558's flags plus `--platform cpu`, one process per config, and
its parsed figures (ATE, frames, fps, warm fps, window-BA iterations) go to
`--out` and to stdout, one JSON line per config. The port's evaluation run
with `--platform cpu` under the same `$UWSLAM_EVAL_DATA` reads the same
PNG files. `--seed-offset K` renders the same sequences with every dataset's
noise seed moved by K (eval.py's `--ba-value` study draws its seeds so) into
roots named `..._s<seed>`: the JAX package's own spread over noise draws.
A root that already holds a dataset (its DONE marker) is read as it is, as
eval.py reads it: under a `$UWSLAM_EVAL_DATA` holding the port's render on a
card (`python scripts/chip_phases.py frames DIR`) the JAX CLI runs on the
very frames `chip_smoke.py` phase 24 runs. The output names each dataset's
renderer (the name in its DONE marker; eval.py leaves it empty).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def config_args(tum: dict, mh01: dict, v101: dict) -> dict[int, list[str]]:
    """eval.py:449-558's flags of the configs that run on one device."""
    tum_base = ["-d", tum["rgb"], "-c", tum["calib"], "--tum-gt", tum["gt"]]

    def euroc(ds):
        return ["-d", ds["root"], "--euroc", "-c", ds["calib"], "--euroc-gt", ds["gt"]]

    v101_ba = euroc(v101) + ["--levels", "5", "--mono-depth", "2.5", "--features",
                             "--depth-bootstrap"]
    return {
        0: tum_base + ["--reference-mode"],
        1: tum_base + ["--levels", "3", "--mono-depth", "2.5"],
        2: tum_base + ["--levels", "3", "--mono-depth", "2.5", "--features",
                       "--depth-bootstrap", "--affine", "--bootstrap-shrink", "0.25"],
        3: euroc(mh01) + ["--levels", "5", "--mono-depth", "3.0", "--affine",
                          "--depth-bootstrap"],
        4: v101_ba + ["--ba"],
        8: euroc(mh01) + ["--reference-mode"],
        9: euroc(v101) + ["--reference-mode"],
        10: v101_ba,
    }


def renderer(ds: dict) -> str:
    """Who drew a dataset: the name in its DONE marker, or eval.py's maker."""
    return Path(ds["root"], "DONE").read_text().strip() or "uwslam_tpu (eval.py)"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default="0,1,2,3,4,8,9,10")
    p.add_argument("--quick", action="store_true", help="eval.py's quick sizes")
    p.add_argument("--seed-offset", type=int, default=0,
                   help="move each dataset's noise seed by this much (0: eval.py's own)")
    p.add_argument("--out", required=True, help="JSON file for the results")
    args = p.parse_args()

    import eval as jeval

    n_tum, n_euroc = (60, 50) if args.quick else (150, 120)
    off = args.seed_offset

    def root(name, seed):
        return os.path.join(jeval.DATA_ROOT, name + (f"_s{seed}" if off else ""))

    t0 = time.perf_counter()
    tum = jeval.make_tum_dataset(root(f"tum_seq01_{n_tum}", off), n_tum, seed=off)
    mh01 = jeval.make_euroc_dataset(root(f"euroc_mh01_{n_euroc}", 1 + off), n_euroc,
                                    kind="euroc_mh", seed=1 + off)
    v101 = jeval.make_euroc_dataset(root(f"euroc_v101_{n_euroc}", 2 + off), n_euroc,
                                    kind="euroc_v1", seed=2 + off)
    print(json.dumps({"rendered_s": round(time.perf_counter() - t0, 1),
                      "data": jeval.DATA_ROOT}), flush=True)
    table = config_args(tum, mh01, v101)
    results = {}
    for idx in (int(c) for c in args.configs.split(",")):
        res = jeval.run_cli(table[idx] + ["--platform", "cpu"])
        results[str(idx)] = res
        print(json.dumps({"config": idx, **{k: v for k, v in res.items() if k != "error"}}),
              flush=True)
        if "error" in res:
            print(res["error"], file=sys.stderr, flush=True)
        Path(args.out).write_text(json.dumps(
            {"frames": {"tum": n_tum, "euroc": n_euroc}, "data": jeval.DATA_ROOT,
             "seeds": {"tum": off, "euroc_mh": 1 + off, "euroc_v1": 2 + off},
             "renderer": {name: renderer(ds) for name, ds in
                          (("tum", tum), ("euroc_mh", mh01), ("euroc_v1", v101))},
             "cli": "python -m uwslam_tpu --platform cpu",
             "results": results}, indent=1))


if __name__ == "__main__":
    main()
