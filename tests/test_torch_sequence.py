"""The port's slice end to end: `track_sequence_batched` (IC) against the
JAX package's CPU run of the same frames, trajectory composition and ATE,
and the package's boundaries (no JAX import, no CPU fallback of the
GPU entry points).

Tolerance of the slice: relative poses to 1e-4 on se3.log (f32 sums in
another order; the two runs agree to ~1e-6 in practice), counts exactly.
"""
import ast
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.io import trajectory as jtraj  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import sequence as jseq  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch import bench  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.io import trajectory  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.tracking import sequence  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "uwslam_tpu_torch"
# bench.py's design point at half width: 320 x 240, f = 262.5.
JCAM = JaxCamera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
CAM = camera_from_jax(JCAM)
CONFIG = dict(levels=5, track_levels=(3, 2, 1, 0), num_points=512, max_iters=(12, 8, 5, 3))


def _jax_poses(n):
    amp = jnp.asarray(bench.TWIST_AMP, jnp.float32)
    return [jse3.exp(amp * math.sin(2.0 * math.pi * i / 24.0)) for i in range(n)]


@pytest.fixture(scope="module")
def slice_runs():
    poses = _jax_poses(8)
    frames = jnp.stack([render_plane_view(JCAM, T, 2.0) for T in poses])
    want = jseq.track_sequence_batched(frames, JCAM, mono_z=2.0, mode="ic", **CONFIG)
    tracker = sequence.SequenceTracker(CAM, mode="ic", **CONFIG)
    got = tracker(torch.from_numpy(np.array(frames)), mono_z=2.0)
    gt = np.stack([np.asarray(jse3.inverse(T)) for T in poses])
    return got, want, gt


def test_slice_matches_jax_track_sequence_batched(slice_runs):
    (T, inliers, errors), (T_j, inliers_j, errors_j), _ = slice_runs
    assert T.shape == (7, 4, 4)
    dlog = se3.log(T) - se3.log(torch.from_numpy(np.array(T_j)))
    assert float(dlog.abs().max()) < 1e-4
    np.testing.assert_array_equal(inliers.numpy(), np.asarray(inliers_j))
    np.testing.assert_allclose(errors.numpy(), np.asarray(errors_j), rtol=1e-3, atol=1e-7)


def test_slice_trajectory_and_ate_match_jax(slice_runs):
    (T, _, _), (T_j, _, _), gt = slice_runs
    est = sequence.compose_trajectory(T).numpy()
    est_j = np.asarray(jseq.compose_trajectory(T_j))
    np.testing.assert_allclose(est, est_j, atol=1e-5)
    ate = trajectory.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    ate_j = jtraj.ate_rmse(est_j[:, :3, 3], gt[:, :3, 3])
    assert ate < 1e-3
    assert ate == pytest.approx(ate_j, abs=1e-5)


def test_functional_and_module_entry_points_agree(slice_runs):
    (T, _, _), _, _ = slice_runs
    frames = bench.bench_frames(bench.bench_poses(8), CAM)
    T2, _, _ = sequence.track_sequence_batched(frames, CAM, mono_z=2.0, **CONFIG)
    assert float((se3.log(T2) - se3.log(T)).abs().max()) < 1e-4
    with pytest.raises(NotImplementedError):
        sequence.SequenceTracker(CAM, mode="fc")


def test_bench_poses_match_jax():
    got = bench.bench_poses(30).numpy()
    want = np.stack([np.asarray(T) for T in _jax_poses(30)])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_compose_trajectory_and_umeyama_match_jax():
    rng = np.random.default_rng(0)
    T_rel = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=(12, 6)) * 0.1, jnp.float32)))
    np.testing.assert_allclose(
        sequence.compose_trajectory(torch.from_numpy(T_rel.copy())).numpy(),
        np.asarray(jseq.compose_trajectory(jnp.asarray(T_rel))), atol=1e-5)
    src = rng.normal(size=(40, 3))
    dst = 1.7 * src @ np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 0.3, -0.2, 0.1])))[:3, :3].T
    dst = dst + [0.5, -1.0, 2.0] + 1e-3 * rng.normal(size=dst.shape)
    for a, b in zip(trajectory.umeyama_alignment(src, dst),
                    jtraj.umeyama_alignment(src, dst)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    est = src.copy()
    est[3] = np.nan
    assert trajectory.ate_rmse(est, dst) == pytest.approx(jtraj.ate_rmse(est, dst))
    assert trajectory.ate_rmse(src, dst, align=False) == pytest.approx(
        jtraj.ate_rmse(src, dst, align=False))


def test_port_never_imports_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "uwslam_tpu"), (path, name)
    modules = sorted(
        "uwslam_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'uwslam_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def test_gpu_entry_points_fail_without_a_card(tmp_path):
    """No CPU continuation: the bench and the chip smoke test exit non-zero
    and print no result when no CUDA card is visible, and the smoke test
    fails alone, without the package beside it."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "uwslam_tpu_torch.bench"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "frames_per_sec" not in out.stdout
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
