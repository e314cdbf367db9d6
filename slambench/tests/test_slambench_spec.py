"""BENCHMARK.json keeps to its format's names, units and lengths, and the
harness finds every part of a cell by name, so a new cell, configuration or
metric is new files and entries and no edit."""
import json
import re
import shutil

import pytest

from slambench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(spec.metric_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert {"setup_s"} < reported
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a configuration, its
    limits, a metric and a cell by new files and new entries only; the
    harness lists and parses them unchanged."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "slambench")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((spec.BENCH_DIR / "traffic" / "replay.json").read_text())
    (tmp_path / "slambench/traffic/replay_stride3.json").write_text(
        json.dumps(dict(mix, stride=3)))
    conf = json.loads((spec.BENCH_DIR / "configs" / "tum_mono_direct.json").read_text())
    (tmp_path / "slambench/configs/tum_mono_iters8.json").write_text(
        json.dumps(dict(conf, name="tum_mono_iters8", flags=conf["flags"] + ["--gn-iters", "8"])))
    (tmp_path / "slambench/reference/limits/tum_mono_iters8.json").write_text(
        (spec.BENCH_DIR / "reference/limits/tum_mono_direct.json").read_text())
    (tmp_path / "slambench/metrics/frames.count.py").write_text(
        "def read(run):\n    return float(run.window.retired_in_window)\n")
    bench["configs"].append({"name": "tum_mono_iters8", "source": conf["source"],
                             "file": "slambench/configs/tum_mono_iters8.json", "reduced": [],
                             "why": "8 LM iterations per level"})
    bench["workloads"].append({"name": "tum_mono_iters8.replay_stride3",
                               "config": "tum_mono_iters8",
                               "traffic": "replay_stride3", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "live loop", "moves": "live_fps",
                               "workloads": ["tum_mono_iters8.replay_stride3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tum_mono_iters8.replay_stride3", root=tmp_path,
                          bench_dir=tmp_path / "slambench")
    assert cell.traffic["stride"] == 3 and cell.reference.settings(cell.config).iters == 8
    assert "frames.count" in [m["name"] for m in cell.per_layer]
    old = spec.load_cell("tum_mono_direct.replay", root=tmp_path, bench_dir=tmp_path / "slambench")
    assert "frames.count" not in [m["name"] for m in old.per_layer]
    read = spec.metric_reader("frames.count", bench_dir=tmp_path / "slambench")

    class Window:
        retired_in_window = 7

    class Run:
        window = Window()

    assert read(Run()) == 7.0
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell", root=tmp_path, bench_dir=tmp_path / "slambench")
