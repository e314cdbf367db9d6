"""`chip_smoke.py` on a loaded host: the script run from a given tree while
four worker processes keep four host cores busy (each repeats a 256 x 256
matrix product), to see how close a loaded host brings it to its time limit.

Run from the repository root on a machine with a CUDA card:
`python scripts/chip_smoke_loaded.py [TREE]` (TREE: a directory holding the
repository, default this one). It passes the script's output through,
prints its exit code and seconds, stops the workers and exits with the
script's code.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

WORKERS = 4


def burn() -> None:
    import numpy as np

    a = np.random.default_rng(0).random((256, 256))
    while True:
        a = np.tanh(a @ a.T / 256.0)


def main() -> int:
    tree = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parent.parent)
    ctx = mp.get_context("spawn")
    workers = [ctx.Process(target=burn, daemon=True) for _ in range(WORKERS)]
    for w in workers:
        w.start()
    t0 = time.perf_counter()
    try:
        rc = subprocess.call([sys.executable, "chip_smoke.py"], cwd=tree,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
    finally:
        for w in workers:
            w.kill()
            w.join()
    print(f"chip_smoke.py beside {WORKERS} busy workers: exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
