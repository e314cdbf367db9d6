"""Parity of the port's observer-sharded photometric BA
(`uwslam_tpu_torch.parallel.distributed_photometric_ba`) with the JAX
package's on the 8-device CPU mesh of tests/conftest.py, on
tests/test_photometric_ba.py's two cases: seed 3, 4 shards, poses only
(level 1, poses perturbed by 0.01, 10 passes); seed 4, the two-plane
scene, 2 shards, joint depths (level 0, inverse depths perturbed by 4%,
15 passes). Both packages solve the same problem: the JAX package builds
the window and `photo_ba_problem_from_numpy` carries it over.

Tolerances:
- port against JAX, poses only: poses within 1e-4 (largest |se3.log| of
  T_port T_jax^-1; measured 1.2e-6), costs within 1e-3 relative (measured
  1.5e-4): the port samples with the gather (kernel K3's plain version),
  the JAX package with its dense one-hot form, which agree to f32 rounding
  in the interior (7.6e-5 gray levels); at ground truth the residuals are
  ~0.06 gray levels of interpolation noise, so that is 1e-4 to 1e-3 of the
  cost (tests/test_torch_photometric_ba.py holds the single-device solves
  to the same 1e-3). Iterations equal (10).
- port against JAX, joint depths: the solve ends where f32 rounding moves
  the poses along directions the photometric cost hardly sees. The JAX
  package's own reduction orders part there: its sharded solve over 1, 2
  and 4 devices against its single-device one differs by 4.4e-4 to 4.9e-4
  in the poses and 1.3e-4 to 2.4e-3 in the cost (15 passes; 3.7e-4 to
  4.4e-4 and up to 2.7e-3 when both run until they stop by themselves,
  28 to 38 passes; removing a fitted scale leaves 2.8e-4 to 5.2e-4). So
  the port is held to 1e-3 in the poses (measured 3.2e-4) and 1e-2 in the
  cost (measured 7.0e-4 under the default ISA, 3.6e-3 under AVX and
  SSE4_2, where the JAX package's cost moves), iterations equal (15, the
  limit).
- D = 4 and D = 2 against D = 1: poses only, the JAX package's own bar
  (tests/test_photometric_ba.py:240-243: rtol 1e-3, atol 1e-4 on T_cw;
  measured 3.2e-8 on se3.log); joint depths, 2e-3 on se3.log (measured
  1.0e-3; the JAX package's own spread above).
- D = 1 is `photometric_bundle_adjust` bit for bit; a shard's observations
  are the columns of the full observation grid bit for bit.
- Two gloo processes of two shards each give the bits of one of four.
The tolerances hold under XLA's default ISA on this AVX-512 CPU and under
`--xla_cpu_max_isa=AVX2`, `AVX` and `SSE4_2`.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from uwslam_tpu.ba import photometric as jpba  # noqa: E402
from uwslam_tpu.parallel import PHOTO_AXIS as JAX_PHOTO_AXIS  # noqa: E402
from uwslam_tpu.parallel import distributed_photometric_ba as jax_dpba  # noqa: E402
from uwslam_tpu_torch.ba import photometric as pba  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax, photo_ba_problem_from_numpy  # noqa: E402
from uwslam_tpu_torch.parallel import (  # noqa: E402
    ShardLayout,
    distributed_photometric_ba,
    landmark_layout,
)
from test_torch_photometric_ba import JCAM, _gap, _make_window, _perturbed  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _poses_case():
    T_gt, pyrs, pts, rng = _make_window(seed=3)
    prob = jpba.photo_ba_problem_from_keyframes(pyrs, _perturbed(T_gt, rng, 0.01), pts, level=1)
    return prob, JCAM.scaled(1), dict(max_iters=10, optimize_depths=False), 4


def _joint_case():
    T_gt, pyrs, pts, rng = _make_window(seed=4, two_plane=True)
    prob = jpba.photo_ba_problem_from_keyframes(pyrs, T_gt, pts, level=0)
    noise = jnp.asarray(rng.normal(scale=0.04, size=prob.inv_depth.shape), jnp.float32)
    prob = prob._replace(inv_depth=prob.inv_depth * (1.0 + noise))
    return prob, JCAM, dict(max_iters=15, optimize_depths=True), 2


# name -> (build, port vs JAX: poses on se3.log, cost relative; D vs D = 1 on
# se3.log or None for the JAX package's allclose bar); see the docstring.
CASES = {"poses-4-shards": (_poses_case, 1e-4, 1e-3, None),
         "joint-2-shards": (_joint_case, 1e-3, 1e-2, 2e-3)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    build, *bars = CASES[request.param]
    prob, jcam, kw, shards = build()
    mesh = Mesh(np.array(jax.devices()[:shards]), (JAX_PHOTO_AXIS,))
    want = jax_dpba(prob, jcam, mesh, **kw)
    return (photo_ba_problem_from_numpy(prob, "cpu"), camera_from_jax(jcam), kw, shards, want,
            bars)


def test_sharded_solve_matches_jax(case):
    prob, cam, kw, shards, want, (pose_tol, cost_rtol, _) = case
    got = distributed_photometric_ba(prob, cam, landmark_layout(shards), **kw)
    assert _gap(got.T_cw.numpy(), want.T_cw) < pose_tol
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost), rtol=1e-3)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=cost_rtol)
    assert int(got.iterations) == int(want.iterations)
    # tests/test_photometric_ba.py's own assertion, on the port's result.
    assert float(got.cost) < 0.2 * float(got.initial_cost)


def test_shard_counts_agree(case):
    prob, cam, kw, _, _, (_, _, shards_tol) = case
    one = distributed_photometric_ba(prob, cam, landmark_layout(1), **kw)
    for shards in (2, 4):
        out = distributed_photometric_ba(prob, cam, landmark_layout(shards), **kw)
        if shards_tol is None:
            np.testing.assert_allclose(out.T_cw.numpy(), one.T_cw.numpy(), rtol=1e-3, atol=1e-4)
        else:
            assert _gap(out.T_cw.numpy(), one.T_cw.numpy()) < shards_tol
        assert float(out.cost) < 0.2 * float(out.initial_cost)
    # One shard is the single-device solve, bit for bit.
    single = pba.photometric_bundle_adjust(prob, cam, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, single))


def test_shard_observations_are_columns_of_the_full_grid(case):
    prob, cam, *_ = case
    full = pba._observations(prob, cam)
    texels = pba.photo_texels(prob)
    active = torch.tensor([True, True, False, True])
    full_active = pba._observations(prob, cam, active=active)
    for idx in (torch.tensor([0, 1]), torch.tensor([2, 3]), torch.tensor([3])):
        part = pba._observations(prob, cam, texels[idx], observer_idx=idx)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:, idx])
        part = pba._observations(prob, cam, texels[idx], active=active, observer_idx=idx)
        for a, b in zip(part, full_active):
            assert torch.equal(a, b[:, idx])


def test_window_must_divide_over_the_shards(case):
    prob, cam, kw, *_ = case
    with pytest.raises(ValueError, match="divide"):
        distributed_photometric_ba(prob, cam, landmark_layout(3), **kw)
    with pytest.raises(ValueError, match="divide"):
        distributed_photometric_ba(prob, cam, ShardLayout(local=3, world=1, rank=0), **kw)


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from uwslam_tpu_torch.ba.photometric import PhotoBAProblem
from uwslam_tpu_torch.camera import PinholeCamera
from uwslam_tpu_torch.parallel import (distributed_photometric_ba, init_distributed,
                                       landmark_layout, primary_only_io)

rank, port, src, out, depths = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                sys.argv[5] == "1")
init_distributed(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
d = np.load(src)
problem = PhotoBAProblem(*(torch.from_numpy(d[k]) for k in PhotoBAProblem._fields))
cam = PinholeCamera(*(float(x) for x in d["cam"][:4]), width=int(d["cam"][4]),
                    height=int(d["cam"][5]))
res = distributed_photometric_ba(problem, cam, landmark_layout(2), max_iters=int(d["iters"]),
                                 optimize_depths=depths)
with primary_only_io() as primary:
    if primary:
        np.savez(out, **{k: getattr(res, k).numpy() for k in res._fields})
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_of_two_shards_equal_one_of_four(case, tmp_path):
    prob, cam, kw, *_ = case
    src, out = tmp_path / "problem.npz", tmp_path / "result.npz"
    np.savez(src, cam=np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height]),
             iters=kw["max_iters"], **{k: getattr(prob, k).numpy() for k in prob._fields})
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(src),
                               str(out), "1" if kw["optimize_depths"] else "0"], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
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
    one = distributed_photometric_ba(prob, cam, landmark_layout(4), **kw)
    for k in one._fields:
        np.testing.assert_array_equal(two[k], getattr(one, k).numpy(), err_msg=k)
