"""The output check on the CPU, at test size: a sound run of the program is
correct, and a run with the timed path broken underneath is not, once for
each fault a one-chip tracking cell can have (there is no exchange between
chips to leave out)."""
import time

import pytest
import torch

from conftest import small
from slambench import spec
from slambench.run import execute

CELLS = ["tum_mono_direct.replay", "tum_mono_direct.replay_stride2"]


def _run(cell_name, seed=2**31 + 101):
    cell = small(spec.load_cell(cell_name))
    result, _ = execute(cell, seed, 1.5, False, torch.device("cpu"), time.perf_counter())
    return result


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    r = _run(cell_name)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["check"]["ingest_gap"]["number"] == 0.0
    assert r["check"]["select_miss"]["number"] == 0.0
    assert list(r["check"])[-1] == "compared_share"


def _state_unchanged(step):
    """The frame's step hands back the pose it was given: no motion."""
    def broken(img, prev_pyr, prev_pts, T_init, T_wc, T_ref, corr):
        pyr, pts, T_rel, T_wc_new, diag = step(img, prev_pyr, prev_pts, T_init, T_wc, T_ref, corr)
        diag = diag.clone()
        diag[4:20] = T_wc.reshape(-1)
        return pyr, pts, torch.eye(4), T_wc.clone(), diag
    return broken


def _half_points(step):
    """Half of the frame's points left out of its selection."""
    def broken(*args):
        pyr, pts, T_rel, T_wc_new, diag = step(*args)
        n = pts.valid.shape[1]
        valid = pts.valid.clone()
        valid[:, n // 2:] = False
        return pyr, pts._replace(valid=valid), T_rel, T_wc_new, diag
    return broken


def _pose_altered(step):
    """Each frame's pose moved by 2 mm where the step produces it."""
    def broken(*args):
        pyr, pts, T_rel, T_wc_new, diag = step(*args)
        T = T_wc_new.clone()
        T[0, 3] += 2e-3
        diag = diag.clone()
        diag[4:20] = T.reshape(-1)
        return pyr, pts, T_rel, T, diag
    return broken


def _pyramid_altered(step):
    """One gradient of the frame's pyramid changed where it is produced."""
    def broken(*args):
        pyr, pts, T_rel, T_wc_new, diag = step(*args)
        gx = list(pyr.grad_x)
        gx[1] = gx[1].clone()
        gx[1][0, 10, 10] += 1.0
        return pyr._replace(grad_x=tuple(gx)), pts, T_rel, T_wc_new, diag
    return broken


@pytest.mark.parametrize("fault,fails", [
    (_state_unchanged, "track_gap_t_p90"),
    (_half_points, "select_miss"),
    (_pose_altered, "track_gap_t_p90"),
    (_pyramid_altered, "ingest_gap"),
])
def test_a_broken_step_is_not_correct(monkeypatch, fault, fails):
    from uwslam_tpu_torch.system import SlamSystem

    build = SlamSystem._build_step_plain
    monkeypatch.setattr(SlamSystem, "_build_step_plain", lambda self: fault(build(self)))
    r = _run(CELLS[0])
    assert not r["correct"]
    number = r["check"][fails]
    assert number["number"] > number["limit"]
