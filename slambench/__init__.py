"""The benchmark of `uwslam_tpu_torch`: closed-loop live replay of recorded
camera frames through the pipelined SLAM loop, one cell per run.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from `BENCHMARK.json`: the
configuration `slambench/configs/<config>.json`, the traffic mix
`slambench/traffic/<traffic>.json`, each metric's reader
`slambench/metrics/<metric>.py`, the limits of the output check
`slambench/reference/limits/<config>.json` and the plain reference the
check runs through, `slambench/reference/<module>.py`, which the
configuration names by its key `"reference"`. A new cell, configuration,
reference or metric is new files and a new entry there, and no edit of
what is here.
"""
