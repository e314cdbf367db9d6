"""Where a cell's parts live, found by name from `BENCHMARK.json`.

Nothing here imports torch or the program, so the tests can read every
part of the benchmark without a card.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One entry of `workloads` with its configuration, its traffic mix, its
    metrics (the `end_to_end` ones without a trace, the `per_layer` ones
    with) and the limits of its output check."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    limits: dict

    def metrics(self, traced: bool) -> tuple[dict, ...]:
        return self.per_layer if traced else self.end_to_end


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json; raises KeyError for a
    name it does not list."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf_entry["file"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
        limits=_json(bench_dir / "reference" / "limits" / f"{entry['config']}.json"),
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of `metrics/<name>.py` (names hold dots, so
    the file is loaded by its path, not imported by a dotted name)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
