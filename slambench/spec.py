"""Where a cell's parts live, found by name from `BENCHMARK.json`.

Nothing here imports torch or the program itself, so the tests can read
every part of the benchmark without a card; `load_cell` loads the cell's
reference module, which imports torch.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One entry of `workloads` with its configuration, its traffic mix, its
    metrics (the `end_to_end` ones without a trace, the `per_layer` ones
    with), the limits of its output check and the reference module that
    check runs through (the contract in `reference/__init__.py`)."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    limits: dict
    reference: ModuleType

    def metrics(self, traced: bool) -> tuple[dict, ...]:
        return self.per_layer if traced else self.end_to_end


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reference(config: dict, limits: dict, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module `reference/<module>.py` that the configuration names by its
    key `"reference"`, loaded by its path as a submodule of
    `slambench.reference` (so its relative imports resolve). Raises
    ValueError where the configuration names none, or a module that is not
    there, where the limits do not name exactly the module's `NUMBERS` and
    `min_compared`, or where the module's `settings` refuses the
    configuration's flags."""
    module = config.get("reference")
    if not isinstance(module, str) or not module.isidentifier():
        raise ValueError(f"configuration {config.get('name')!r} names no reference module: "
                         f"its key 'reference' is {module!r}")
    path = bench_dir / "reference" / f"{module}.py"
    if not path.is_file():
        raise ValueError(f"configuration {config.get('name')!r} names the reference "
                         f"{module!r}, but there is no {path}")
    spec = importlib.util.spec_from_file_location(f"slambench.reference.{module}", path)
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    want, got = set(reference.NUMBERS) | {"min_compared"}, set(limits)
    if want != got:
        raise ValueError(f"the limits of {config.get('name')!r} must name exactly "
                         f"{module}.NUMBERS and min_compared; they lack {sorted(want - got)} "
                         f"and name {sorted(got - want)} besides")
    reference.settings(config)
    return reference


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json; raises KeyError for a
    name it does not list, and ValueError as `load_reference` does."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf_entry["file"])
    limits = _json(bench_dir / "reference" / "limits" / f"{entry['config']}.json")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
        limits=limits,
        reference=load_reference(config, limits, bench_dir),
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of `metrics/<name>.py` (names hold dots, so
    the file is loaded by its path, not imported by a dotted name)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
