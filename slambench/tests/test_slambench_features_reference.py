"""The `features` reference (eval.py config 2's bootstrap megastep) against
the program on the CPU, at test size, where the megastep runs eagerly:
every stage of the sound program agrees within its limit (the exact ones
exactly), and the program broken underneath reads `correct` false, once
for each fault: the RANSAC uniforms drawn from another seed, the prior not
refreshed, the brightness (a, b) dropped from the LM, one keypoint moved by
a pixel, a NaN cell in the refreshed prior. A program whose records lack
the step's pose and uniforms, or whose row lacks the counts, is not
comparable. The reference's copy of the descriptor projection is the
package's. Marked `cuda`: the TF32 control fails on the card where the
program passes, at the cell's own size."""
import time

import numpy as np
import pytest
import torch

from conftest import small
from slambench import check, spec
from slambench.run import measure, reference_rows

CELL = "tum_mono_features.replay"
SEED = 2**31 + 101
EXACT = ("ingest_gap", "detect_miss", "uniforms_gap", "select_miss", "match_count_gap",
         "depth_gap_p90")


def _cell():
    return small(spec.load_cell(CELL))


def _measure(cell, seed=SEED):
    return measure(cell, seed, 1.5, False, torch.device("cpu"), time.perf_counter())


def _judge(cell, m):
    rows = reference_rows(m, cell, torch.device("cpu"))
    return check.judge(cell.reference.summarize(rows), len(rows), m.sampled, cell.limits)


def test_the_eager_megastep_agrees_with_the_reference():
    cell = _cell()
    m = _measure(cell)
    assert m.answers and all(a["counts"] is not None and a["uniforms"] is not None
                             for a in m.answers)
    ok, table = _judge(cell, m)
    assert ok, table
    assert list(table) == [*cell.reference.NUMBERS, "compared_share"]
    for name in EXACT + ("inlier_count_gap_p90",):
        assert table[name][0] == 0.0, (name, table[name])
    assert all(s.status == "ok" for s in m.window.retired)


def _uniforms_reseeded(monkeypatch):
    from uwslam_tpu_torch.system import SlamSystem

    draw = SlamSystem._ransac_uniforms
    monkeypatch.setattr(SlamSystem, "_ransac_uniforms",
                        lambda self, n, seed: draw(self, n, seed + 1))


def _boot_step_output(monkeypatch, change):
    """The bootstrap megastep with `change(inputs, outputs)` applied to its
    outputs where it produces them."""
    from uwslam_tpu_torch.system import SlamSystem

    build = SlamSystem._build_step_boot

    def broken_build(self):
        step = build(self)

        def broken(*inputs):
            return tuple(change(inputs, list(step(*inputs))))
        return broken

    monkeypatch.setattr(SlamSystem, "_build_step_boot", broken_build)


def _prior_not_refreshed(monkeypatch):
    def stale(inputs, out):
        out[5] = inputs[6]               # the prior the step was given
        return out
    _boot_step_output(monkeypatch, stale)


def _affine_dropped(monkeypatch):
    from uwslam_tpu_torch import system

    track = system.track
    monkeypatch.setattr(system, "track", lambda *a, **k: track(*a, **dict(k, affine=False)))


def _keypoint_moved(monkeypatch):
    def moved(inputs, out):
        kps = out[1]
        uv = kps.uv.clone()
        uv[int(torch.nonzero(kps.valid)[0]), 0] += 1.0
        out[1] = kps._replace(uv=uv)
        return out
    _boot_step_output(monkeypatch, moved)


@pytest.mark.parametrize("fault,fails", [
    (_uniforms_reseeded, "uniforms_gap"),
    (_prior_not_refreshed, "prior_gap_p90"),
    (_affine_dropped, "track_gap_t_p90"),
    (_keypoint_moved, "detect_miss"),
])
def test_a_broken_megastep_is_not_correct(monkeypatch, fault, fails):
    fault(monkeypatch)
    cell = _cell()
    ok, table = _judge(cell, _measure(cell))
    assert not ok
    number, limit = table[fails]
    assert number > limit, table


def _prior_with_a_nan_cell(monkeypatch):
    def nan_cell(inputs, out):
        inv = out[5].inv_depth.clone()
        inv[inv.shape[0] // 2, inv.shape[1] // 2] = float("nan")
        out[5] = out[5]._replace(inv_depth=inv)
        return out
    _boot_step_output(monkeypatch, nan_cell)


def test_a_nan_cell_in_the_refreshed_prior_is_not_correct(monkeypatch):
    _prior_with_a_nan_cell(monkeypatch)
    cell = _cell()
    m = _measure(cell)
    ok, table = _judge(cell, m)
    assert not ok
    assert m.answers and np.isnan(table["prior_gap_p90"][0]), table


def _record_without(monkeypatch, *keys):
    from uwslam_tpu_torch.system import SlamSystem

    dispatch = SlamSystem._dispatch_pipelined

    def older(self, image, ts):
        rec = dispatch(self, image, ts)
        for k in keys:
            rec.pop(k, None)
        return rec

    monkeypatch.setattr(SlamSystem, "_dispatch_pipelined", older)


@pytest.mark.parametrize("keys", [("T_rel", "uniforms"), ("T_rel",), ("uniforms",)])
def test_a_record_without_the_step_s_fields_is_not_comparable(monkeypatch, keys):
    """A program whose records do not hold the step's relative pose or its
    uniforms (before they were kept) has no comparable frame, so it is not
    correct, whatever its other numbers read."""
    _record_without(monkeypatch, *keys)
    cell = _cell()
    m = _measure(cell)
    assert m.sampled > 0 and not m.answers
    ok, table = _judge(cell, m)
    assert not ok and table["compared_share"][0] == 0.0
    assert all(np.isnan(table[k][0]) for k in cell.reference.NUMBERS)


def test_a_row_without_counts_is_not_comparable():
    """A boot row that ends after the plain 26 floats (and its stage times)
    has no counts: the frame is not comparable."""
    ref = _cell().reference

    class State:
        step_ms = None

    assert ref._counts(np.zeros(26, np.float32), State()) is None
    State.step_ms = dict.fromkeys("abcdefg", 1.0)
    assert ref._counts(np.zeros(33, np.float32), State()) is None
    assert ref._counts(np.arange(35, dtype=np.float32), State()) == (26.0, 27.0)
    numbers = ref.summarize([dict.fromkeys(
        ("ingest_gap", "detect_miss", "desc_gap", "uniforms_gap", "match_count_gap",
         "inlier_count_gap", "track_gap_t", "track_gap_r", "prior_gap", "select_miss",
         "depth_gap"), 0.0)])
    assert numbers == dict.fromkeys(ref.NUMBERS, 0.0)
    row = dict.fromkeys(("ingest_gap", "detect_miss", "desc_gap", "uniforms_gap",
                         "match_count_gap", "inlier_count_gap", "track_gap_t", "track_gap_r",
                         "select_miss", "depth_gap"), 0.0)
    numbers = ref.summarize([dict(row, prior_gap=0.0), dict(row, prior_gap=float("inf"))])
    assert np.isnan(numbers["prior_gap_p90"])


def test_the_projection_is_the_package_s():
    from uwslam_tpu_torch.features.descriptors import PROJECTION_FILE

    ours, theirs = np.load(spec.BENCH_DIR / "reference" / "data" / "descriptor_projection.npy"), \
        np.load(PROJECTION_FILE)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (64, 64)
    assert np.array_equal(ours, theirs)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 311, 2**31 + 312, 2**31 + 313])
def test_tf32_control_fails_where_the_program_passes(seed, cuda_device):
    cell = spec.load_cell(CELL)
    m = measure(cell, seed, 2.0, False, cuda_device, time.perf_counter())
    program = reference_rows(m, cell, cuda_device)
    control = reference_rows(m, cell, cuda_device, tf32=True)
    summarize = cell.reference.summarize
    ok, table = check.judge(summarize(program), len(program), m.sampled, cell.limits)
    assert ok, table
    ok, table = check.judge(summarize(control), len(control), m.sampled, cell.limits)
    assert not ok, table
