"""A configuration names its plain reference, and the output check runs
through that module alone: a new reference is new files and new entries,
with no edit of a file the benchmark has, and a configuration that its
reference cannot check, a reference that is not there, or limits that do
not name exactly the reference's numbers are refused when the cell is
loaded, before any set-up."""
import dataclasses
import hashlib
import json
import shutil
import time

import pytest
import torch

from conftest import small
from slambench import check, spec
from slambench.run import execute

CONFIG = json.loads((spec.BENCH_DIR / "configs" / "tum_mono_direct.json").read_text())
LIMITS = json.loads((spec.BENCH_DIR / "reference" / "limits" / "tum_mono_direct.json").read_text())

# A reference made of direct's parts under numbers of its own: Select left
# out, and the largest translation gap beside its 90th percentile.
SANS_SELECT = '''"""Direct tracking, checked without Select."""
from .direct import answer, compare, keep, reference, settings
from .direct import summarize as _summarize

NUMBERS = ("ingest_gap", "track_gap_t_p90", "track_gap_r_p90", "track_gap_t_max")


def summarize(rows):
    numbers = _summarize(rows)
    numbers["track_gap_t_max"] = max((r["track_gap_t"] for r in rows), default=float("nan"))
    return {k: numbers[k] for k in NUMBERS}
'''


def _copy(tmp_path) -> dict:
    shutil.copytree(spec.BENCH_DIR, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def _hashes(root) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _add_cell(tmp_path, bench: dict, config: dict, limits: dict) -> spec.Cell:
    """The configuration `config` with its limits and a cell on the replay
    mix, as new files and entries of the copy; -> the cell, loaded."""
    name = config["name"]
    (tmp_path / f"slambench/configs/{name}.json").write_text(json.dumps(config))
    (tmp_path / f"slambench/reference/limits/{name}.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": name, "source": config["source"],
                             "file": f"slambench/configs/{name}.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": f"{name}.replay", "config": name, "traffic": "replay",
                               "chips": 1, "why": "a new cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.load_cell(f"{name}.replay", root=tmp_path, bench_dir=tmp_path / "slambench")


def test_a_new_reference_is_new_files_only(tmp_path):
    bench = _copy(tmp_path)
    before = _hashes(tmp_path / "slambench")
    (tmp_path / "slambench/reference/direct_sans_select.py").write_text(SANS_SELECT)
    limits = dict({k: v for k, v in LIMITS.items() if k != "select_miss"},
                  track_gap_t_max=0.01)
    cell = _add_cell(tmp_path, bench,
                     dict(CONFIG, name="tum_mono_sans_select", reference="direct_sans_select"),
                     limits)
    assert cell.reference.__name__ == "slambench.reference.direct_sans_select"
    # Every frame of the short window is sampled, so that the 90th
    # percentile spares one chaotic frame (frame 24 of this seed) as it does
    # in a full run's 64; of 6 it would be the largest.
    cell = small(cell)
    cell = dataclasses.replace(cell, config=dict(
        cell.config, bench=dict(cell.config["bench"], check_frames=64)))
    result, _ = execute(cell, 2**31 + 171, 1.5, False, torch.device("cpu"), time.perf_counter())
    check_ = result["check"]
    assert list(check_) == [*cell.reference.NUMBERS, "compared_share"]
    assert result["correct"], check_
    assert check_["track_gap_t_max"]["number"] >= check_["track_gap_t_p90"]["number"]
    assert result["attempted"] > 0 and result["failed"] == 0
    after = _hashes(tmp_path / "slambench")
    assert {p: after.get(p) for p in before} == before


def test_the_sample_hands_keep_the_record_dispatched_before():
    class System:
        def _dispatch_pipelined(self, image, ts):
            return {"frame_id": ts}

    system = System()
    sample = check.Sample(system, 8, 2**31 + 5, lambda rec, prev: prev)
    for k in range(200):
        sample.active = k >= 50          # frame 50's predecessor came before the window
        system._dispatch_pipelined(None, k)
    assert sample.seen == 150 and len(sample.kept) == 8
    assert all(prev["frame_id"] == i - 1 for i, prev in sample.kept.items())
    assert sample.last == {"frame_id": 199}


def _with_features(config, limits):
    return dict(config, flags=config["flags"] + ["--features"]), limits, "--features"


def _without_key(config, limits):
    return {k: v for k, v in config.items() if k != "reference"}, limits, "'reference'"


def _no_such_module(config, limits):
    return dict(config, reference="direct_nowhere"), limits, "direct_nowhere"


def _limits_lack_a_number(config, limits):
    return config, {k: v for k, v in limits.items() if k != "select_miss"}, "select_miss"


def _limits_name_one_more(config, limits):
    return config, dict(limits, track_gap_t_max=1e-3), "track_gap_t_max"


@pytest.mark.parametrize("fault", [_with_features, _without_key, _no_such_module,
                                   _limits_lack_a_number, _limits_name_one_more])
def test_load_cell_refuses_what_the_reference_cannot_check(tmp_path, fault):
    bench = _copy(tmp_path)
    config, limits, named = fault(dict(CONFIG, name="tum_mono_refused"), dict(LIMITS))
    with pytest.raises(ValueError, match=named):
        _add_cell(tmp_path, bench, config, limits)


def test_each_configuration_s_limits_name_its_reference_s_numbers():
    for c in spec.load_benchmark()["configs"]:
        config = json.loads((spec.ROOT / c["file"]).read_text())
        limits = json.loads(
            (spec.BENCH_DIR / "reference" / "limits" / f"{c['name']}.json").read_text())
        reference = spec.load_reference(config, limits)
        assert set(limits) == set(reference.NUMBERS) | {"min_compared"}
        assert [k for k in limits if k != "min_compared"] == list(reference.NUMBERS)
