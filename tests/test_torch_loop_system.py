"""Loop closure and the global distributed BA in the port's live system
against the JAX package's: tests/test_loop_closure.py's out-and-back run
(24 frames of the two-plane scene at 160x120, out along x and back, loop
gates relaxed as there), with `use_loop_closure` and `global_ba` on, then
`run_global_distributed_ba` over 8 landmark shards (the JAX package on the
8-device CPU mesh of tests/conftest.py).

The port is handed the JAX package's random draws (the PnP samples of loop
verification and the RANSAC uniforms of the global map's pair matches), and
the JAX package runs the two-view forms the port runs on every device
(`jax_accelerator_branch`). Then: the same keyframes and loop edges (history
indices and inlier counts), every frame's pose within 1e-4 (measured
1.1e-5), the same global-BA history, landmarks and observations, final
keyframe poses within 1e-4 (measured 1.1e-5) and final costs within 1e-4
relative. The f32 solves' iteration counts are not compared: both end at
their f32 noise floor, where each pass's accept test compares rounding noise
(measured 30-32 against the JAX package's 25 at equal final costs; see
tests/test_torch_pose_graph.py for how the JAX package's own count moves
with the host's instruction set). The same global-BA problem solved in
float64 by both packages takes the same number of passes (16), final costs
within 1e-5 relative (measured 3.7e-6) and poses within 1e-5 (measured
5.3e-7). The final pose is within the JAX test's
0.15 m of the truth. (With its own samples the port closes the same loops:
tests/test_torch_loop_closure.py holds the gates on both kinds of samples.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu import config as jcfg  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.camera.calibration import Calibration as JaxCalibration  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.utils.synthetic import render_two_plane_view  # noqa: E402
from uwslam_tpu_torch import config as pcfg  # noqa: E402
from uwslam_tpu_torch.camera import Calibration, PinholeCamera  # noqa: E402
from uwslam_tpu_torch.map import loop_closure as lc  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from test_torch_loop_closure import jax_pnp_samples  # noqa: E402
from test_torch_ransac import jax_accelerator_branch  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)


def _config(c):
    return c.SlamConfig(
        tracker=c.TrackerConfig(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512,
                                mono_depth=2.0),
        loop=c.LoopClosureConfig(min_gap=4, min_matches=15, pnp_min_inliers=12,
                                 min_similarity=0.5),
        use_loop_closure=True, global_ba=True,
    )


def _jax_uniforms(self, num_matches, seed):
    H = self.config.features.ransac_hypotheses
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (H, num_matches), minval=1e-9, maxval=1.0)))


def _out_and_back():
    xs = [0.06 * i for i in range(12)]
    xs += xs[::-1]
    frames, gt = [], []
    for x in xs:
        T = jse3.exp(jnp.asarray([x, 0.0, 0.0, 0.0, 0.0, 0.0]))
        frames.append(np.asarray(render_two_plane_view(JCAM, T, 2.0, 3.5, detail=3.0)))
        gt.append(np.asarray(jse3.inverse(T)))
    return frames, gt


GLOBAL_BA_CALLS: dict = {}


@pytest.fixture(scope="module")
def runs():
    """Both systems over the out-and-back frames, with the global BA's
    arguments of each recorded in GLOBAL_BA_CALLS ("jax", "port")."""
    import uwslam_tpu.parallel as jpar
    import uwslam_tpu_torch.parallel as ppar

    frames, gt = _out_and_back()

    def recorded(name, solve):
        def call(*args, **kw):
            GLOBAL_BA_CALLS[name] = (args, kw)
            return solve(*args, **kw)
        return call

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(lc, "pnp_samples", jax_pnp_samples)
        mp.setattr(SlamSystem, "_ransac_uniforms", _jax_uniforms)
        mp.setattr(jpar, "distributed_bundle_adjust",
                   recorded("jax", jpar.distributed_bundle_adjust))
        mp.setattr(ppar, "distributed_bundle_adjust",
                   recorded("port", ppar.distributed_bundle_adjust))
        port = SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120), _config(pcfg),
                          device="cpu")
        states = [port.process_frame(f) for f in frames]
        stats = port.run_global_distributed_ba(shards=8, time_steady_state=False)
        with jax_accelerator_branch():
            ref = JaxSystem(JaxCalibration(raw=JCAM, out_width=160, out_height=120),
                            _config(jcfg))
            want = [ref.process_frame(f) for f in frames]
            want_stats = ref.run_global_distributed_ba(time_steady_state=False)
    finally:
        mp.undo()
    return gt, (port, states, stats), (ref, want, want_stats)


def test_same_keyframes_loop_edges_and_poses_as_jax(runs):
    gt, (port, states, _), (ref, want, _) = runs
    assert [s.is_keyframe for s in states] == [s.is_keyframe for s in want]
    assert [s.status for s in states] == [s.status for s in want]
    edges = [(e.i, e.j, e.num_inliers) for e in port._loops.loop_edges]
    assert edges and edges == [(e.i, e.j, e.num_inliers) for e in ref._loops.loop_edges]
    assert len(port._loops.history) == len(ref._loops.history) >= 6
    for a, b in zip(states, want):
        np.testing.assert_allclose(a.T_wc, np.asarray(b.T_wc), atol=1e-4)
    assert np.linalg.norm(states[-1].T_wc[:3, 3] - gt[-1][:3, 3]) < 0.15
    assert port.loop_stats["pgo_runs"] == len(edges)


def test_global_ba_builds_and_solves_the_jax_problem(runs):
    _, (port, _, stats), (ref, _, want) = runs
    assert stats is not None and want is not None
    assert len(port._kf_history) == len(ref._kf_history)
    for k in ("keyframes", "landmarks", "observations"):
        assert stats[k] == want[k], k
    assert stats["shards"] == want["devices"] == 8
    assert stats["applied"] and want["applied"]
    np.testing.assert_allclose(stats["initial_cost"], want["initial_cost"], rtol=1e-4)
    np.testing.assert_allclose(stats["final_cost"], want["final_cost"], rtol=1e-4)
    assert 1 <= stats["iterations"] <= 40 and 1 <= want["iterations"] <= 40
    for fid, T in port._kf_poses.items():
        np.testing.assert_allclose(T, np.asarray(ref._kf_poses[fid]), atol=1e-4)
    _, poses = port.export_trajectory()
    np.testing.assert_allclose(poses, np.asarray(ref.export_trajectory()[1]), atol=1e-4)


def test_global_ba_in_float64_takes_the_jax_float64_passes(runs):
    """The recorded global-BA problem of each package (the same problem:
    see above), its f32 values solved in float64 by both (the JAX package
    under `jax.enable_x64`, its mesh of 8 devices; the port over 8 shards):
    equal LM pass counts, final costs within 1e-5 relative, poses within
    1e-5. At f32 the counts differ (30-32 against 25) by rounding alone."""
    from uwslam_tpu.parallel import distributed_bundle_adjust as jdba
    from uwslam_tpu_torch.parallel import distributed_bundle_adjust as pdba

    (jprob, jcam, mesh), jkw = GLOBAL_BA_CALLS["jax"]
    (pprob, pcam, layout), pkw = GLOBAL_BA_CALLS["port"]
    host = [np.asarray(x) for x in jprob]
    with jax.enable_x64(True):
        j64 = type(jprob)(*[jnp.asarray(x, jnp.float64 if x.dtype == np.float32 else x.dtype)
                            for x in host])
        want = jdba(j64, jcam, mesh, **jkw)
        assert want.T_cw.dtype == jnp.float64
        want = [np.asarray(x) for x in (want.T_cw, want.cost, want.iterations)]
    p64 = type(pprob)(*[x.double() if x.dtype == torch.float32 else x for x in pprob])
    out = pdba(p64, pcam, layout, **pkw)
    assert out.T_cw.dtype == torch.float64
    assert int(out.iterations) == int(want[2]) < pkw["max_iters"]
    np.testing.assert_allclose(float(out.cost), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(out.T_cw.numpy(), want[0], atol=1e-5)


def test_pipelined_loop_applies_each_correction_once(runs, monkeypatch):
    """The same frames through `process_frame_async`: a loop found at a
    keyframe's retirement corrects the device-side chain through the
    pending correction and the frames in flight at their retirement, each
    once. Every frame's live pose equals the synchronous run's (1e-5; a
    correction applied twice would move the chain by its size, ~7e-3 here)
    except each loop's own keyframe, which reports its pose before the
    correction, as the JAX package's pipelined retirement does."""
    _, (port, states, _), _ = runs
    monkeypatch.setattr(lc, "pnp_samples", jax_pnp_samples)
    monkeypatch.setattr(SlamSystem, "_ransac_uniforms", _jax_uniforms)
    pipe = SlamSystem(Calibration(raw=CAM, out_width=160, out_height=120), _config(pcfg),
                      device="cpu")
    for i, f in enumerate(_out_and_back()[0]):
        pipe.process_frame_async(f, timestamp=float(i))
    pipe.flush()
    edges = [(e.i, e.j) for e in pipe._loops.loop_edges]
    assert edges == [(e.i, e.j) for e in port._loops.loop_edges]
    closing = {pipe._loops.history[j].frame_id for _, j in edges}
    assert [s.frame_id for s in pipe.trajectory] == list(range(len(states)))
    for a, b in zip(pipe.trajectory, states):
        if a.frame_id not in closing:
            np.testing.assert_allclose(a.T_wc, b.T_wc, atol=1e-5)
    np.testing.assert_allclose(pipe._T_wc.numpy(), port._T_wc.numpy(), atol=1e-5)
    assert np.allclose(pipe._corr_pending, np.eye(4))
    assert not np.allclose(pipe._corr_accum, np.eye(4))
