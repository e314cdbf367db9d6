"""Parity of the port's landmark-sharded bundle adjustment
(`uwslam_tpu_torch.parallel`) with the JAX package's on the 8-device CPU
mesh of tests/conftest.py, on tests/test_parallel.py's problems.

- `shard_problem` is host numpy in both packages: equal arrays.
- `distributed_bundle_adjust` with 8 shards in one process, `direct` and
  `pcg`, against the JAX package's on 8 devices, every pass live
  (`full_budget`, so where a solve stops at its noise floor does not
  enter) and two poses fixed as the global BA fixes them: poses within
  2e-5 and points within 1e-4 (f32 Schur LM, sums in another order;
  measured 6.6e-7 and 1.8e-5), costs within 1e-3 relative. With one fixed
  pose the scale is free and drifts with the summation order (2e-4 in the
  poses between the packages, measured). Without the full budget both
  converge to the truth within 5e-3, as tests/test_parallel.py holds the
  JAX package.
- The JAX package's `pcg` against its `direct` on the same problem (the
  reference has no test of `pcg`): CG stops at 1e-5 of the right-hand
  side's norm, so ten LM passes take slightly other steps: poses within
  1e-3 (measured 2.5e-4 and 3.3e-4 with one and two fixed poses), costs
  within 1e-4 relative.
- Two processes of 4 shards each over gloo give the bits of one process
  of 8 shards (a fixed pairwise tree over the shards, a two-value
  all-reduce); each worker has its own time limit.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from uwslam_tpu.ba import BAProblem as JaxProblem  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.parallel import AXIS  # noqa: E402
from uwslam_tpu.parallel import distributed_bundle_adjust as jax_dba  # noqa: E402
from uwslam_tpu.parallel import shard_problem as jax_shard  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.interop import ba_problem_from_numpy  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.parallel import (  # noqa: E402
    ShardLayout,
    distributed_bundle_adjust,
    landmark_layout,
    shard_problem,
)

REPO = Path(__file__).resolve().parent.parent
JCAM = JaxCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)
CAM = PinholeCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)


def make_problem(seed, num_kf=4, num_lm=96, pose_noise=0.02, point_noise=0.05, pix_noise=0.0,
                 skew=False):
    """tests/test_parallel.py:make_problem (its PRNG draws), plus optional
    pixel noise and tracks of skewed length (some landmarks seen by fewer
    keyframes)."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(jax.random.PRNGKey(seed), 6)
    pts_gt = jnp.stack([
        jax.random.uniform(k1, (num_lm,), minval=-1.5, maxval=1.5),
        jax.random.uniform(k2, (num_lm,), minval=-1.0, maxval=1.0),
        jax.random.uniform(k3, (num_lm,), minval=3.0, maxval=6.0)], axis=-1)
    T_gt = jnp.stack([jse3.exp(jnp.asarray([0.08 * i, 0.01 * i, 0.0, 0.0, 0.005 * i, 0.0]))
                      for i in range(num_kf)])
    kf_idx = jnp.repeat(jnp.arange(num_kf), num_lm).astype(jnp.int32)
    lm_idx = jnp.tile(jnp.arange(num_lm), num_kf).astype(jnp.int32)
    uv = JCAM.project(jse3.apply(T_gt[kf_idx], pts_gt[lm_idx]))
    uv = uv + pix_noise * jax.random.normal(k6, uv.shape)
    valid = jnp.ones_like(kf_idx, dtype=bool)
    if skew:
        valid = (lm_idx % 5 >= kf_idx) | (kf_idx < 2)
    dT = (pose_noise * jax.random.normal(k4, (num_kf, 6))).at[0].set(0.0)
    T_init = jax.vmap(lambda T, d: jse3.compose(jse3.exp(d), T))(T_gt, dT)
    pts_init = pts_gt + point_noise * jax.random.normal(k5, pts_gt.shape)
    return JaxProblem(T_cw=T_init, points=pts_init, obs_kf=kf_idx, obs_lm=lm_idx, obs_uv=uv,
                      obs_valid=valid), T_gt


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), (AXIS,))


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
def test_shard_problem_equals_jax(skew):
    problem, _ = make_problem(0, skew=skew)
    got = shard_problem(ba_problem_from_numpy(problem, "cpu"), 8)
    want = jax_shard(problem, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


def _pose_err(T, T_gt):
    return float(torch.linalg.vector_norm(
        se3.log(se3.compose(se3.inverse(torch.from_numpy(np.asarray(T_gt))), T)), dim=-1).max())


@pytest.mark.parametrize("solver", ["direct", "pcg"])
def test_eight_shards_match_jax_mesh(solver, mesh):
    problem, _ = make_problem(1, pix_noise=0.3)
    sharded = jax_shard(problem, 8)
    kw = dict(max_iters=12, full_budget=True, solver=solver, num_fixed_poses=2)
    got = distributed_bundle_adjust(ba_problem_from_numpy(sharded, "cpu"), CAM,
                                    landmark_layout(8), **kw)
    want = jax_dba(sharded, JCAM, mesh, **kw)
    assert int(got.iterations) == int(want.iterations) == 12
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=2e-5)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
    for a, b in ((got.cost, want.cost), (got.initial_cost, want.initial_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-7)
    assert float(got.cost) < float(got.initial_cost)


def test_converges_like_jax_and_jax_pcg_agrees_with_direct(mesh):
    """tests/test_parallel.py:test_matches_single_device_result's bound for
    both packages; the JAX package's pcg held to its direct solve."""
    problem, T_gt = make_problem(1)
    sharded = jax_shard(problem, 8)
    got = distributed_bundle_adjust(ba_problem_from_numpy(sharded, "cpu"), CAM,
                                    landmark_layout(8), max_iters=15)
    want = jax_dba(sharded, JCAM, mesh, max_iters=15)
    assert _pose_err(got.T_cw, T_gt) < 5e-3
    assert _pose_err(torch.from_numpy(np.asarray(want.T_cw)), T_gt) < 5e-3
    assert float(got.cost) < float(got.initial_cost) * 1e-2
    noisy, _ = make_problem(2, pix_noise=0.3, skew=True)
    noisy = jax_shard(noisy, 8)
    kw = dict(max_iters=10, full_budget=True)
    direct = jax_dba(noisy, JCAM, mesh, solver="direct", **kw)
    pcg = jax_dba(noisy, JCAM, mesh, solver="pcg", **kw)
    np.testing.assert_allclose(np.asarray(pcg.T_cw), np.asarray(direct.T_cw), atol=1e-3)
    np.testing.assert_allclose(float(pcg.cost), float(direct.cost), rtol=1e-4)


def test_solve_repeats_bit_for_bit_and_validates_layout():
    problem, _ = make_problem(3, pix_noise=0.3)
    sharded = shard_problem(ba_problem_from_numpy(problem, "cpu"), 8)
    a = distributed_bundle_adjust(sharded, CAM, landmark_layout(8), max_iters=6)
    b = distributed_bundle_adjust(sharded, CAM, landmark_layout(8), max_iters=6)
    assert torch.equal(a.T_cw, b.T_cw) and torch.equal(a.points, b.points)
    with pytest.raises(ValueError, match="shard_problem"):
        distributed_bundle_adjust(ba_problem_from_numpy(problem, "cpu"), CAM,
                                  ShardLayout(local=5, world=1, rank=0))


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from uwslam_tpu_torch.ba.schur import BAProblem
from uwslam_tpu_torch.camera import PinholeCamera
from uwslam_tpu_torch.parallel import (distributed_bundle_adjust, init_distributed,
                                       landmark_layout, primary_only_io)

rank, port, src, out, solver = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
init_distributed(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
d = np.load(src)
problem = BAProblem(*(torch.from_numpy(d[k]) for k in BAProblem._fields))
cam = PinholeCamera(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)
layout = landmark_layout(4)
assert (layout.world, layout.rank, list(layout.shards)) == (2, rank, list(range(4 * rank, 4 * rank + 4)))
res = distributed_bundle_adjust(problem, cam, layout, max_iters=8, solver=solver)
with primary_only_io() as primary:
    if primary:
        np.savez(out, **{k: getattr(res, k).numpy() for k in res._fields})
# Leave the group before the interpreter exits: gloo's threads torn down with
# the process abort it ("terminate called without an active exception").
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("solver", ["direct", "pcg"])
def test_two_gloo_processes_of_four_shards_equal_one_of_eight(solver, tmp_path):
    problem, _ = make_problem(4, pix_noise=0.3, skew=True)
    sharded = shard_problem(ba_problem_from_numpy(problem, "cpu"), 8)
    src, out = tmp_path / "problem.npz", tmp_path / "result.npz"
    np.savez(src, **{k: getattr(sharded, k).numpy() for k in sharded._fields})
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(src),
                               str(out), solver], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a gloo worker did not finish within 120 s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    two = np.load(out)
    one = distributed_bundle_adjust(sharded, CAM, landmark_layout(8), max_iters=8, solver=solver)
    for k in one._fields:
        np.testing.assert_array_equal(two[k], getattr(one, k).numpy(), err_msg=k)
    assert int(one.iterations) >= 2 and float(one.cost) < float(one.initial_cost)


def test_step_to_a_non_finite_state_is_refused(monkeypatch):
    """A step whose solve comes back non-finite leaves no observation valid,
    so its mean cost reads 0 and the JAX package's accept test takes it
    (a full-size chip run of config 5 ended with every keyframe pose
    non-finite that way); the port refuses it and keeps the state."""
    problem, _ = make_problem(5, pix_noise=0.3)
    sharded = shard_problem(ba_problem_from_numpy(problem, "cpu"), 8)
    solve_ex = torch.linalg.solve_ex

    def nan_solve(A, B, **kw):
        out = solve_ex(A, B, **kw)
        return SimpleNamespace(result=torch.full_like(out.result, float("nan")), info=out.info)

    monkeypatch.setattr(torch.linalg, "solve_ex", nan_solve)
    out = distributed_bundle_adjust(sharded, CAM, landmark_layout(8), max_iters=1,
                                    num_fixed_poses=2)
    assert torch.isfinite(out.T_cw).all() and torch.isfinite(out.points).all()
    assert torch.equal(out.T_cw, sharded.T_cw) and int(out.iterations) == 1
    np.testing.assert_allclose(float(out.cost), float(out.initial_cost), rtol=1e-6)
