"""Readings the output check's limits are set from, on the card.

    python3 slambench/calibrate.py --workload <cell> --seconds <s> --seeds <n,n,...>
                                   [--control] [--out FILE]

For each seed, in one process: a run of the cell (set-up, a window of
`--seconds`, the sample checked against the reference at float32 with TF32
off), and with `--control` the control: the reference itself put in the
program's place with TF32 on, on the same sampled frames. One JSON line
per seed and side with the reference's numbers over the sample and the
largest of each per-frame number (`<name>_max`) (the lower reading is the
largest the program gives over the seeds, the upper the smallest the
control gives), printed and appended to `--out`.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from slambench import spec
    from slambench.run import measure, reference_rows

    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        m = measure(cell, seed, args.seconds, False, device, time.perf_counter())
        sides = [("program", False)] + ([("control", True)] if args.control else [])
        for side, tf32 in sides:
            rows = reference_rows(m, cell, device, tf32=tf32)
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "compared": len(rows), "sampled": m.sampled,
                    "frames": len(m.window.handed), **cell.reference.summarize(rows),
                    **{f"{k}_max": max(r[k] for r in rows) for k in (rows[0] if rows else ())}}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
