"""Parity of the port's sequence-sharded tracker
(`uwslam_tpu_torch.parallel.track_sequence_sharded`) with the JAX
package's on the 8-device CPU mesh of tests/conftest.py, on
tests/test_parallel.py's case: 9 frames of 160 x 120, 4 shards, 4 levels,
track levels (2, 1, 0), 512 points, 12 LM iterations, FC (both packages'
default), both chunk flavours.

Tolerances: relative poses within 1e-4 on se3.log, inliers equal, errors
within 1e-3 relative (those of tests/test_torch_sequence.py and
tests/test_torch_fc.py for `track_sequence(_batched)`: f32 sums in another
order); the sharded batched run equals the port's unsharded call bit for
bit on the CPU (every pair depends on its two frames only); two gloo
processes of two shards each give the bits of one process of four.
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

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.io import ate_rmse  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.parallel import SEQ_AXIS as JAX_SEQ_AXIS  # noqa: E402
from uwslam_tpu.parallel import track_sequence_sharded as jax_sharded  # noqa: E402
from uwslam_tpu.tracking import compose_trajectory as jax_compose  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.parallel import (  # noqa: E402
    AXIS,
    PHOTO_AXIS,
    SEQ_AXIS,
    ShardLayout,
    grid_mesh,
    landmark_layout,
    track_sequence_sharded,
)
from uwslam_tpu_torch.tracking import sequence  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
N_FRAMES = 9
CONFIG = dict(mono_z=2.0, levels=4, track_levels=(2, 1, 0), num_points=512, max_iters=12)


@pytest.fixture(scope="module")
def scene():
    poses = [jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i,
                                   0.003 * i], jnp.float32)) for i in range(N_FRAMES)]
    frames = np.stack([np.asarray(render_plane_view(JCAM, T, 2.0)) for T in poses])
    gt_wc = np.stack([np.asarray(jse3.inverse(T)) for T in poses])
    return frames, gt_wc


@pytest.fixture(scope="module")
def jax_runs(scene):
    frames, _ = scene
    mesh = Mesh(np.array(jax.devices()[:4]), (JAX_SEQ_AXIS,))
    return {batched: [np.asarray(x) for x in jax_sharded(jnp.asarray(frames), JCAM, mesh,
                                                         batched=batched, **CONFIG)]
            for batched in (True, False)}


def _log_gap(T, T_jax) -> float:
    return float((se3.log(T) - se3.log(torch.from_numpy(np.array(T_jax)))).abs().max())


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "sequential"])
def test_sharded_matches_jax(scene, jax_runs, batched):
    frames, gt_wc = scene
    T, inliers, errors = track_sequence_sharded(torch.from_numpy(frames), CAM,
                                                landmark_layout(4), batched=batched, **CONFIG)
    T_j, inl_j, err_j = jax_runs[batched]
    assert T.shape == (N_FRAMES - 1, 4, 4)
    assert _log_gap(T, T_j) < 1e-4
    np.testing.assert_array_equal(inliers.numpy(), inl_j)
    np.testing.assert_allclose(errors.numpy(), err_j, rtol=1e-3, atol=1e-7)
    # tests/test_parallel.py's own assertions, on the port's result.
    T_wc = sequence.compose_trajectory(T).numpy()
    assert ate_rmse(T_wc[:, :3, 3], gt_wc[:, :3, 3]) < 0.01
    assert int(inliers.min()) > 200
    np.testing.assert_allclose(T_wc, np.asarray(jax_compose(jnp.asarray(T_j))), atol=1e-4)


@pytest.mark.parametrize("shards,n", [(4, N_FRAMES), (8, 5), (3, N_FRAMES)],
                         ids=["4-shards", "8-shards-5-frames", "3-shards"])
def test_batched_shards_equal_the_unsharded_call(scene, shards, n):
    """Every pair depends on its two frames only: the sharded batched run is
    the unsharded call, bit for bit, also where chunks run past the last
    frame (8 shards of 5 frames: 4 of them hold no real pair)."""
    frames = torch.from_numpy(scene[0][:n])
    got = track_sequence_sharded(frames, CAM, landmark_layout(shards), **CONFIG)
    want = sequence.track_sequence_batched(frames, CAM, **CONFIG)
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))


def test_sequential_chunks_restart_the_velocity_prior(scene):
    """batched=False tracks each chunk by `track_sequence`, its prior
    starting from the identity at the chunk's first pair (the JAX package's
    sharded scan, not the unsharded one)."""
    frames = torch.from_numpy(scene[0])
    T, _, _ = track_sequence_sharded(frames, CAM, landmark_layout(4), batched=False, **CONFIG)
    C = 2                                    # ceil(8 / 4) pairs per chunk
    chunks = [sequence.track_sequence(frames[d * C:d * C + C + 1], CAM, **CONFIG)[0]
              for d in range(4)]
    assert torch.equal(T, torch.cat(chunks))


def test_layouts_and_axis_names():
    assert (AXIS, SEQ_AXIS, PHOTO_AXIS) == ("lm", "seq", "obs")
    grid = grid_mesh(2, 4)
    assert grid.axes == ("kf", "lm") and grid.layout == ShardLayout(local=8, world=1, rank=0)
    assert grid.coords(5) == (1, 1) and grid.local_coords[:5] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (1, 0)]
    assert grid_mesh(3, 1, axes=("a", "b")).axes == ("a", "b")
    with pytest.raises(ValueError):
        grid_mesh(0, 4)
    with pytest.raises(ValueError):
        landmark_layout(0)


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from uwslam_tpu_torch.camera import PinholeCamera
from uwslam_tpu_torch.parallel import (init_distributed, landmark_layout, primary_only_io,
                                       track_sequence_sharded)

rank, port, src, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
init_distributed(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
cam = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
frames = torch.from_numpy(np.load(src))
outs = {}
for batched in (True, False):
    T, inl, err = track_sequence_sharded(frames, cam, landmark_layout(2), mono_z=2.0, levels=4,
                                         track_levels=(2, 1, 0), num_points=512, max_iters=12,
                                         batched=batched)
    outs.update({f"T_{batched}": T.numpy(), f"inliers_{batched}": inl.numpy(),
                 f"errors_{batched}": err.numpy()})
with primary_only_io() as primary:
    if primary:
        np.savez(out, **outs)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_of_two_shards_equal_one_of_four(scene, tmp_path):
    frames = scene[0]
    src, out = tmp_path / "frames.npy", tmp_path / "result.npz"
    np.save(src, frames)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(src),
                               str(out)], env=env, cwd=str(tmp_path),
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
    for batched in (True, False):
        one = track_sequence_sharded(torch.from_numpy(frames), CAM, landmark_layout(4),
                                     batched=batched, **CONFIG)
        for name, x in zip(("T", "inliers", "errors"), one):
            np.testing.assert_array_equal(two[f"{name}_{batched}"], x.numpy(),
                                          err_msg=f"{name} batched={batched}")
