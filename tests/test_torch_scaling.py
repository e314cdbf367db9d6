"""The port's shard-count curve (`python -m uwslam_tpu_torch.scaling`) against
the JAX package's `benchmarks/scaling.py` on the CPU, at a small problem.

- `make_problem(8, 512)` gives the JAX script's problem: the same numpy draws,
  the initial poses through each package's se3 (within 1e-6).
- The port's `distributed_bundle_adjust` over 1, 2, 4 and 8 landmark shards
  in one process, `full_budget`, 5 iterations, two poses fixed (the script's
  call), against the JAX package's on the 8-device CPU mesh of
  tests/conftest.py at the same shard counts: tests/test_torch_dist_ba.py's
  tolerances (poses 2e-5, points 1e-4, costs 1e-3 relative). Measured at
  every shard count under the host's default XLA code generator and under
  `XLA_FLAGS=--xla_cpu_max_isa=AVX2`, `AVX` and `SSE4_2`: poses within
  4.8e-7, points 7.2e-7, costs 6.3e-7 relative; the problems' poses 6e-8.
- `comm_bytes_per_iter` is the JAX formula for `direct` and `pcg`, and a
  curve's rows carry the JAX script's keys, all at the full budget.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from uwslam_tpu.parallel import AXIS  # noqa: E402
from uwslam_tpu.parallel import distributed_bundle_adjust as jax_dba  # noqa: E402
from uwslam_tpu.parallel import shard_problem as jax_shard  # noqa: E402
from uwslam_tpu_torch import scaling  # noqa: E402
from uwslam_tpu_torch.parallel import (  # noqa: E402
    distributed_bundle_adjust,
    landmark_layout,
    shard_problem,
)

REPO = Path(__file__).resolve().parent.parent
ITERS = 5


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_scaling", REPO / "benchmarks/scaling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def problems(jax_script):
    return scaling.make_problem(8, 512), jax_script.make_problem(8, 512)


def test_make_problem_equals_the_jax_script(problems):
    (got, cam, O), (want, jcam, O_j) = problems
    assert O == O_j
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height) == (
        jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.width, jcam.height)
    for name in ("T_cw", "points", "obs_uv"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
    for name in ("obs_kf", "obs_lm", "obs_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_solve_matches_jax_mesh(problems, shards):
    (got_p, cam, _), (want_p, jcam, _) = problems
    kw = dict(max_iters=ITERS, huber_delta=2.0, num_fixed_poses=2, full_budget=True)
    got = distributed_bundle_adjust(shard_problem(got_p, shards), cam, landmark_layout(shards),
                                    **kw)
    mesh = Mesh(np.array(jax.devices()[:shards]), (AXIS,))
    want = jax_dba(jax_shard(want_p, shards), jcam, mesh, **kw)
    assert int(got.iterations) == int(want.iterations) == ITERS
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=2e-5)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
    for a, b in ((got.cost, want.cost), (got.initial_cost, want.initial_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-7)
    assert float(got.cost) < float(got.initial_cost)


def test_comm_bytes_are_the_jax_formulas():
    for M in (16, 64):
        assert scaling.comm_bytes(M, "auto")[0] == 4 * (M * M * 36 + M * 36 + 2 * M * 6 + 4)
        assert scaling.comm_bytes(M, "direct")[0] == scaling.comm_bytes(M, "auto")[0]
        assert scaling.comm_bytes(M, "pcg")[0] == 4 * (M * 36 + M * 6 + M * 36 + M * 6 + 4)


def test_curve_rows_carry_the_jax_keys_at_the_full_budget(problems):
    (problem, cam, O), _ = problems
    rows = scaling.run_curve(problem, cam, O, 8, 512, "small", runs=1, shard_counts=(1, 2),
                             max_iters=3)
    jax_keys = {"devices", "iterations", "seconds", "iters_per_sec", "speedup_vs_1dev",
                "shard_compute_s", "work_division_pct", "solver", "comm_bytes_per_iter",
                "comm_note", "cost_initial", "cost_final"}
    for n, row in zip((1, 2), rows):
        assert jax_keys | {"efficiency_pct_one_card_tensor_axis", "max_memory_allocated"} \
            == set(row)
        assert row["devices"] == n and row["iterations"] == 3
        assert all(np.isfinite(row[k]) for k in ("seconds", "cost_initial", "cost_final"))
    assert rows[0]["speedup_vs_1dev"] == 1.0
    assert rows[1]["cost_final"] == pytest.approx(rows[0]["cost_final"], rel=1e-3)


def test_the_default_platform_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        scaling.main(["--out", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()
