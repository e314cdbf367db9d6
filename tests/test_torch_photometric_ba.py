"""Parity of the port's photometric window BA (`ba.photometric`), the
two-depth scene it is tested on (`utils.synthetic`) and `--photo-ba` in the
live system with the JAX package, on the CPU, on the cases of
tests/test_photometric_ba.py (4 keyframes of 160 x 120, 256 points each,
levels 0 and 1; the window is built by the JAX package and carried over
with `photo_ba_problem_from_numpy`, so both solve the same problem).

The port samples with the plain version of kernel K3 (the 4-tap gather),
the JAX package with its dense one-hot form; they agree in the interior to
f32 rounding. At u == W - 1 or v == H - 1 exactly the dense form returns
the last column or row and the gather the one before (ROADMAP section 3,
"Edge-pixel disagreement"): these cases have no valid observation there,
and `test_observations_match_jax` checks that they have none.

Tolerances, measured under XLA's default ISA on an AVX-512 CPU and under
`--xla_cpu_max_isa=AVX2` and `SSE4_2`:
- renders within 1e-3 gray levels, depths within 1e-5 m (f32 sin and ray
  arithmetic in another order; measured 3.1e-5 and 2.4e-7);
- `_observations`: `valid` equal, r within 1e-3 gray levels (measured
  7.6e-5), A, B and Jd within 1e-4 of each one's largest entry (measured
  7e-7, 7e-7 and 2.3e-6);
- pose-only solves: poses within 1e-4 (largest |se3.log| of T_port
  T_jax^-1; measured 7.5e-6), initial and final cost within 1e-3 relative
  (measured 1.4e-4 and 2.0e-4: at ground truth the residuals are ~0.06
  gray levels of interpolation noise, so the samplers' 7.6e-5 is 1e-3 of
  each), iterations within 1;
- the joint pose-and-depth solve: the JAX test's own assertions, poses
  within 1e-3 of JAX (measured 2.0e-5);
- the padded window (10 keyframes, 6 of them padding) against the 4 real
  ones: the first pass's normal equations bit-equal, poses within the
  bounds above (1e-4 pose-only, 1e-3 joint; measured 7.5e-6 and 1.4e-5:
  the 60 x 60 LU rounds otherwise than the 24 x 24), cost 1e-3 relative
  (measured 4e-5), inverse depths within 1e-3 (measured 4.5e-5);
- the 12-frame live run of tests/test_photometric_ba.py: equal keyframes,
  poses within 1e-3, ATE below 0.02 m.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.ba import photometric as jpba  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.camera.calibration import Calibration as JaxCalibration  # noqa: E402
from uwslam_tpu.config import BAConfig as JaxBAConfig  # noqa: E402
from uwslam_tpu.config import KeyframeConfig as JaxKeyframeConfig  # noqa: E402
from uwslam_tpu.config import SlamConfig as JaxSlamConfig  # noqa: E402
from uwslam_tpu.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from uwslam_tpu.image import build_pyramid as jbuild_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.system import SlamSystem as JaxSystem  # noqa: E402
from uwslam_tpu.tracking import topk_gradient_points as jtopk  # noqa: E402
from uwslam_tpu.utils import synthetic as jsyn  # noqa: E402
from uwslam_tpu_torch.ba import photometric as pba  # noqa: E402
from uwslam_tpu_torch.camera import Calibration  # noqa: E402
from uwslam_tpu_torch.config import BAConfig, KeyframeConfig, SlamConfig, TrackerConfig  # noqa: E402
from uwslam_tpu_torch.interop import (  # noqa: E402
    camera_from_jax,
    photo_ba_problem_from_numpy,
    points_from_numpy,
    pyramid_from_numpy,
)
from uwslam_tpu_torch.io.trajectory import ate_rmse  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.system import SlamSystem  # noqa: E402
from uwslam_tpu_torch.utils import synthetic  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
K = 4


def _pose(k):
    return jse3.exp(jnp.asarray([0.05 * k, 0.02 * k, 0.01 * k, 0.004 * k, -0.006 * k,
                                 0.008 * k], jnp.float32))


def _make_window(seed=0, two_plane=False):
    """tests/test_photometric_ba.py's window: K keyframes of a textured
    scene, their pyramids and top-256 points at the exact depths (off the
    depth seam of the two-plane scene)."""
    rng = np.random.default_rng(seed)
    T_gt, pyrs, pts = [], [], []
    for k in range(K):
        T = _pose(k)
        if two_plane:
            img, depth = jsyn.render_two_plane_view(JCAM, T), jsyn.two_plane_depth(JCAM, T)
        else:
            img, depth = jsyn.render_plane_view(JCAM, T, 2.0), jsyn.plane_depth(JCAM, T, 2.0)
        pyr = jbuild_pyramid(img, levels=3)
        p = jtopk(pyr.images[0], pyr.grad_mag[0], JCAM, num_points=256, mono_z=1.0, block=4)
        u = p.uv[:, 0].astype(jnp.int32).clip(0, JCAM.width - 1)
        v = p.uv[:, 1].astype(jnp.int32).clip(0, JCAM.height - 1)
        z = depth[v, u]
        ok = p.valid & (z > 0.1)
        if two_plane:
            X_c = JCAM.unproject(p.uv, z)
            T_wc = jse3.inverse(T)
            px_w = (jse3.rotation(T_wc) @ X_c.T).T[:, 0] + jse3.translation(T_wc)[0]
            ok = ok & (jnp.abs(px_w) > 0.25)
        T_gt.append(T)
        pyrs.append(pyr)
        pts.append(p._replace(p3d=JCAM.unproject(p.uv, z), valid=ok))
    return T_gt, pyrs, pts, rng


def _perturbed(T_gt, rng, scale):
    return [T_gt[0]] + [
        jse3.compose(jse3.exp(jnp.asarray(rng.normal(scale=scale, size=6), jnp.float32)), T)
        for T in T_gt[1:]
    ]


def _gap(T_a, T_b) -> float:
    """Largest |se3.log(T_a T_b^-1)| entry over the poses, in float64."""
    Ta = torch.from_numpy(np.array(T_a, np.float64))
    Tb = torch.from_numpy(np.array(T_b, np.float64))
    return float(se3.log(se3.compose(Ta, se3.inverse(Tb))).abs().max())


def _pose_errs(T_est, T_gt, align_scale=False):
    """tests/test_photometric_ba.py's gauge-aligned pose errors (relative to
    keyframe 0; with `align_scale` one least-squares scale removed)."""
    T_est = np.array(T_est, np.float64)
    T_gt = np.array(T_gt, np.float64)
    rel_est = [T @ np.linalg.inv(T_est[0]) for T in T_est]
    rel_gt = [T @ np.linalg.inv(T_gt[0]) for T in T_gt]
    if align_scale:
        te = np.concatenate([a[:3, 3] for a in rel_est])
        tg = np.concatenate([a[:3, 3] for a in rel_gt])
        s = float(te @ tg) / max(float(te @ te), 1e-12)
        for a in rel_est:
            a[:3, 3] *= s
    return [float(np.linalg.norm(se3.log(torch.from_numpy(np.linalg.inv(a) @ b)).numpy()))
            for a, b in zip(rel_est, rel_gt)]


# ---------------------------------------------------------------- the scene

@pytest.mark.parametrize("k", [0, 2, 3])
def test_two_plane_scene_matches_jax(k):
    T = _pose(k)
    Tt = torch.from_numpy(np.asarray(T))
    img = synthetic.render_two_plane_view(CAM, Tt).numpy()
    depth = synthetic.two_plane_depth(CAM, Tt).numpy()
    np.testing.assert_allclose(img, np.asarray(jsyn.render_two_plane_view(JCAM, T)), atol=1e-3)
    np.testing.assert_allclose(depth, np.asarray(jsyn.two_plane_depth(JCAM, T)), atol=1e-5)
    assert depth.min() > 1.9 and depth.max() > 3.4      # both planes in view


# ---------------------------------------------------------- the observations

CASES = [(0, 1, False), (0, 0, False), (1, 0, True), (2, 1, False)]


@pytest.mark.parametrize("seed,level,two_plane", CASES)
def test_observations_match_jax(seed, level, two_plane):
    T_gt, pyrs, pts, _ = _make_window(seed, two_plane)
    prob = jpba.photo_ba_problem_from_keyframes(pyrs, T_gt, pts, level=level)
    cam = JCAM.scaled(level)
    rj, Jp, Jdj, vj = (np.asarray(x) for x in jpba._observations(prob, cam))
    r, A, B, Jd, valid = (x.numpy() for x in pba._observations(
        photo_ba_problem_from_numpy(prob, "cpu"), camera_from_jax(cam)))
    # The JAX package's Jacobian has A in the owner's slot, B in the observer's.
    Aj = np.stack([Jp[i, :, :, 6 * i:6 * i + 6] for i in range(K)])
    Bj = np.stack([np.stack([Jp[i, j, :, 6 * j:6 * j + 6] for j in range(K)])
                   for i in range(K)])
    assert np.array_equal(valid, vj) and valid.sum() > 1000
    np.testing.assert_allclose(r, rj, atol=1e-3)
    for ours, theirs in ((A, Aj), (B, Bj), (Jd, Jdj)):
        assert np.abs(ours - theirs).max() <= 1e-4 * np.abs(theirs).max()
    # No valid observation on the last row or column (where the two
    # samplers differ by construction).
    X = np.asarray(prob.uv)
    assert X.shape == (K, 256, 2)
    W, H = cam.width, cam.height
    T_ji = np.einsum("jab,ibc->ijac", np.asarray(prob.T_cw),
                     np.linalg.inv(np.asarray(prob.T_cw)))
    rays = np.concatenate([(X - [cam.cx, cam.cy]) / [cam.fx, cam.fy],
                           np.ones((K, 256, 1))], -1) / np.asarray(prob.inv_depth)[..., None]
    Xj = np.einsum("ijab,inb->ijna", T_ji[..., :3, :3], rays) + T_ji[:, :, None, :3, 3]
    u = cam.fx * Xj[..., 0] / Xj[..., 2] + cam.cx
    v = cam.fy * Xj[..., 1] / Xj[..., 2] + cam.cy
    assert not (valid & ((np.abs(u - (W - 1)) < 1e-3) | (np.abs(v - (H - 1)) < 1e-3))).any()


@pytest.mark.parametrize("level", [0, 1])
def test_problem_from_keyframes_matches_jax(level):
    T_gt, pyrs, pts, _ = _make_window(0)
    want = jpba.photo_ba_problem_from_keyframes(pyrs, T_gt, pts, level=level)
    got = pba.photo_ba_problem_from_keyframes(
        [pyramid_from_numpy(p, "cpu") for p in pyrs],
        [torch.from_numpy(np.array(T)) for T in T_gt],
        [points_from_numpy(p, "cpu") for p in pts], level=level)
    for field in pba.PhotoBAProblem._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if field == "intensity":        # the gather against the dense sample
            np.testing.assert_allclose(a, b, atol=1e-4)
        else:
            assert np.array_equal(a, b), field


def test_observations_exclude_inactive_keyframes():
    """A padding keyframe neither owns nor observes: its row and column of
    the observation grid are invalid and zero."""
    T_gt, pyrs, pts, _ = _make_window(0)
    prob = photo_ba_problem_from_numpy(
        jpba.photo_ba_problem_from_keyframes(pyrs, T_gt, pts, level=1), "cpu")
    active = torch.tensor([True, True, False, True])
    r, A, B, Jd, valid = pba._observations(prob, camera_from_jax(JCAM.scaled(1)), active=active)
    full = pba._observations(prob, camera_from_jax(JCAM.scaled(1)))[-1]
    assert not valid[2].any() and not valid[:, 2].any()
    keep = active[:, None] & active[None, :]
    assert torch.equal(valid, full & keep[:, :, None])
    for x in (r, A, B, Jd):
        assert float(x[2].abs().max()) == 0.0 and float(x[:, 2].abs().max()) == 0.0


# ---------------------------------------------------------------- the solves

def _both_solves(prob, cam, **kwargs):
    out_j = jpba.photometric_bundle_adjust(prob, cam, **kwargs)
    out_t = pba.photometric_bundle_adjust(photo_ba_problem_from_numpy(prob, "cpu"),
                                          camera_from_jax(cam), **kwargs)
    return out_j, out_t


def _pose_only_case(name):
    if name == "recovers":
        T_gt, pyrs, pts, rng = _make_window(0)
        prob = jpba.photo_ba_problem_from_keyframes(pyrs, _perturbed(T_gt, rng, 0.01), pts,
                                                    level=1)
        return T_gt, prob, 15
    T_gt, pyrs, pts, _ = _make_window(2)
    return T_gt, jpba.photo_ba_problem_from_keyframes(pyrs, T_gt, pts, level=1), 8


@pytest.mark.parametrize("name", ["recovers", "noop"])
def test_pose_only_solve_matches_jax(name):
    T_gt, prob, iters = _pose_only_case(name)
    out_j, out_t = _both_solves(prob, JCAM.scaled(1), max_iters=iters, optimize_depths=False)
    assert _gap(out_t.T_cw.numpy(), out_j.T_cw) < 1e-4
    np.testing.assert_allclose(float(out_t.initial_cost), float(out_j.initial_cost), rtol=1e-3)
    np.testing.assert_allclose(float(out_t.cost), float(out_j.cost), rtol=1e-3)
    assert abs(int(out_t.iterations) - int(out_j.iterations)) <= 1
    assert torch.equal(out_t.inv_depth, torch.from_numpy(np.asarray(prob.inv_depth)))
    # The JAX test's own assertions, on the port's result.
    errs = _pose_errs(out_t.T_cw.numpy(), T_gt)
    if name == "recovers":
        assert float(out_t.cost) < 0.2 * float(out_t.initial_cost)
        assert max(errs) < 0.005, errs
    else:
        assert max(errs) < 1e-3, errs


@pytest.fixture(scope="module")
def joint_case():
    T_gt, pyrs, pts, rng = _make_window(1, two_plane=True)
    T_noisy = _perturbed(T_gt, rng, 0.008)
    exact = jpba.photo_ba_problem_from_keyframes(pyrs, T_noisy, pts, level=0)
    noise = jnp.asarray(rng.normal(scale=0.05, size=exact.inv_depth.shape), jnp.float32)
    prob = exact._replace(inv_depth=exact.inv_depth * (1.0 + noise))
    return T_gt, T_noisy, exact, prob, _both_solves(prob, JCAM, max_iters=20,
                                                    optimize_depths=True)


def test_joint_pose_and_depth_solve_matches_jax(joint_case):
    T_gt, T_noisy, exact, prob, (out_j, out_t) = joint_case
    assert float(out_t.cost) < 0.1 * float(out_t.initial_cost)
    assert np.mean(_pose_errs(out_t.T_cw.numpy(), T_gt, True)) < np.mean(
        _pose_errs(T_noisy, T_gt, True))
    d_gt, valid = np.asarray(exact.inv_depth), np.asarray(prob.valid)
    err_before = np.abs(np.asarray(prob.inv_depth) - d_gt)[valid].mean()
    err_after = np.abs(out_t.inv_depth.numpy() - d_gt)[valid].mean()
    assert err_after < 0.9 * err_before
    assert _gap(out_t.T_cw.numpy(), out_j.T_cw) < 1e-3


def test_two_solves_are_bit_equal(joint_case):
    _, _, _, prob, (_, first) = joint_case
    again = pba.photometric_bundle_adjust(photo_ba_problem_from_numpy(prob, "cpu"), CAM,
                                          max_iters=20, optimize_depths=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fixed_loop_equals_a_loop_that_stops_when_done():
    """The pose-only recovery converges before 30 passes (at 19 under XLA's
    default ISA, AVX2 and SSE4_2): the passes after `done` change nothing,
    so 30 passes give the bits of exactly `iterations` passes."""
    _, prob, _ = _pose_only_case("recovers")
    tp, cam = photo_ba_problem_from_numpy(prob, "cpu"), CAM.scaled(1)
    long = pba.photometric_bundle_adjust(tp, cam, max_iters=30, optimize_depths=False)
    k = int(long.iterations)
    assert 1 <= k < 30
    short = pba.photometric_bundle_adjust(tp, cam, max_iters=k, optimize_depths=False)
    assert all(torch.equal(a, b) for a, b in zip(long, short))


@pytest.mark.parametrize("case", ["pose-only", "joint"])
def test_padded_window_gives_the_real_keyframes_poses(case, joint_case):
    """The live system pads the window to the keyframe capacity (one shape,
    one graph): padding keyframes with identity poses, no valid point and no
    part in the solve leave the real keyframes' normal equations bit-equal;
    the 60 x 60 solve then rounds otherwise than the 24 x 24 one, so the
    poses are held to the bounds of the parity with JAX."""
    if case == "pose-only":
        T_gt, prob, _ = _pose_only_case("recovers")
        cam, kw, bound = CAM.scaled(1), dict(max_iters=15, optimize_depths=False), 1e-4
    else:
        prob = joint_case[3]
        cam, kw, bound = CAM, dict(max_iters=20, optimize_depths=True), 1e-3
    prob = photo_ba_problem_from_numpy(prob, "cpu")
    cap, pad = 10, 10 - K

    def padded(x, value):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), value, dtype=x.dtype)])

    big = pba.PhotoBAProblem(
        images=padded(prob.images, 0.0), grad_x=padded(prob.grad_x, 0.0),
        grad_y=padded(prob.grad_y, 0.0),
        T_cw=torch.cat([prob.T_cw, torch.eye(4).expand(pad, 4, 4)]), uv=padded(prob.uv, 0.0),
        inv_depth=padded(prob.inv_depth, 1.0), intensity=padded(prob.intensity, 0.0),
        valid=padded(prob.valid, False))
    active = torch.arange(cap) < K
    small = pba.photometric_bundle_adjust(prob, cam, **kw)
    out = pba.photometric_bundle_adjust(big, cam, active=active, **kw)
    assert _gap(out.T_cw[:K].numpy(), small.T_cw.numpy()) < bound
    assert torch.equal(out.T_cw[K:], big.T_cw[K:])
    np.testing.assert_allclose(float(out.cost), float(small.cost), rtol=1e-3)
    assert abs(int(out.iterations) - int(small.iterations)) <= 1
    np.testing.assert_allclose(out.inv_depth[:K].numpy(), small.inv_depth.numpy(), atol=1e-3)
    # The normal equations of the first pass: the real block bit-equal, the
    # padding rows and columns empty.
    one, many = (pba._observations(p, cam, active=a) for p, a in ((prob, None), (big, active)))
    eq_small = pba._normal_equations(*one[:4], pba._huber_w(one[0], one[-1], 12.0))
    eq_big = pba._normal_equations(*many[:4], pba._huber_w(many[0], many[-1], 12.0))
    assert torch.equal(eq_big[0][:6 * K, :6 * K], eq_small[0])
    assert torch.equal(eq_big[1][:6 * K], eq_small[1])
    assert float(eq_big[0][6 * K:].abs().max()) == 0.0


PASS_LIMIT = 20          # BAConfig.max_iterations, what the live system runs
OWN_STOP_LIMIT = 60


def test_jax_solve_also_ends_at_its_noise_floor_by_the_pass_limit(joint_case):
    """The joint solve at the live system's 20-pass limit, both packages:
    each runs all 20 passes; given room, each stops by its own rule at 20 to
    26 passes (the JAX package at 23 under XLA's default and AVX2 code and at
    20 under AVX and SSE4_2, the port at 23 or 26 on those inputs), and the
    cost at the limit is within 1e-3 of the cost where the rule stops it:
    the passes beyond are rejected steps raising the damping, or changes
    below 1e-7 of the cost. So a result at the limit sits on the f32 noise
    floor in both packages and carries its input's last bits (ROADMAP
    section 3, fault 5)."""
    prob = joint_case[3]
    j, t = _both_solves(prob, JCAM, max_iters=PASS_LIMIT, optimize_depths=True)
    j_own, t_own = _both_solves(prob, JCAM, max_iters=OWN_STOP_LIMIT, optimize_depths=True)
    assert int(j.iterations) == int(t.iterations) == PASS_LIMIT
    for own in (j_own, t_own):
        assert PASS_LIMIT <= int(own.iterations) < OWN_STOP_LIMIT
    np.testing.assert_allclose(float(j_own.cost), float(j.cost), rtol=1e-3)
    np.testing.assert_allclose(float(t_own.cost), float(t.cost), rtol=1e-3)


@pytest.mark.parametrize("passes", [1, 2, 3, 5])
@pytest.mark.parametrize("case", ["pose-only", "joint"])
def test_truncated_solve_follows_jax_pass_for_pass(joint_case, case, passes):
    """The solves cut after 1, 2, 3 and 5 passes, both packages, every pass
    accepted in both. Pose-only (the "recovers" case): poses within 1e-4,
    costs within 1e-3 relative. Joint (poses and depths): poses within 5e-4
    and costs within 6e-2 relative. One pass agrees to 1.4e-5 and 6e-5 under
    XLA's default, AVX2, AVX and SSE4_2 code; the second step then moves
    poses along directions the photometric cost hardly sees as the cost
    falls 50-fold, and the packages part by up to 1.8e-4 and 4.9e-2 (AVX)
    by pass 5, where the JAX package's own cost after two passes moves by
    3.2% between those instruction sets and its own sharded solves of this
    case part by 4.4e-4 to 4.9e-4 (ROADMAP section 3)."""
    if case == "pose-only":
        _, prob, _ = _pose_only_case("recovers")
        cam, depths, pose_tol, cost_tol = JCAM.scaled(1), False, 1e-4, 1e-3
    else:
        prob, cam, depths, pose_tol, cost_tol = joint_case[3], JCAM, True, 5e-4, 6e-2
    out_j, out_t = _both_solves(prob, cam, max_iters=passes, optimize_depths=depths)
    assert int(out_t.iterations) == int(out_j.iterations) == passes
    assert _gap(out_t.T_cw.numpy(), out_j.T_cw) < pose_tol
    np.testing.assert_allclose(float(out_t.cost), float(out_j.cost), rtol=cost_tol)
    assert float(out_t.cost) < float(out_t.initial_cost)


# ------------------------------------------------------------ the live system

LIVE_TRACKER = dict(pyramid_levels=3, track_levels=(2, 1, 0), mono_depth=2.0, num_points=256,
                    point_block=4)
LIVE_BA = dict(photometric=True, max_iterations=8, run_every_n_keyframes=2)


def _live_frames(n=12):
    xis = [[0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i] for i in range(n)]
    T = [jse3.exp(jnp.asarray(xi, jnp.float32)) for xi in xis]
    return ([np.asarray(jsyn.render_plane_view(JCAM, t, 2.0)) for t in T],
            np.stack([np.asarray(jse3.inverse(t)) for t in T]))


def _port_live(pipelined=False):
    frames, _ = _live_frames()
    system = SlamSystem(
        Calibration(raw=CAM, out_width=160, out_height=120),
        SlamConfig(tracker=TrackerConfig(**LIVE_TRACKER),
                   keyframes=KeyframeConfig(min_gap=2, max_gap=4), use_ba=True,
                   ba=BAConfig(**LIVE_BA)), device="cpu")
    step = system.process_frame_async if pipelined else system.process_frame
    for i, f in enumerate(frames):
        step(f, timestamp=float(i))
    system.flush()
    return system


@pytest.fixture(scope="module")
def live_runs():
    frames, gt = _live_frames()
    ref = JaxSystem(
        JaxCalibration(raw=JCAM, out_width=160, out_height=120),
        JaxSlamConfig(tracker=JaxTrackerConfig(**LIVE_TRACKER),
                      keyframes=JaxKeyframeConfig(min_gap=2, max_gap=4), use_ba=True,
                      ba=JaxBAConfig(**LIVE_BA)))
    for i, f in enumerate(frames):
        ref.process_frame(f, timestamp=float(i))
    return gt, _port_live(), ref, _port_live(pipelined=True)


def test_live_system_with_photometric_ba_matches_jax(live_runs):
    gt, port, ref, _ = live_runs
    assert port.ba_stats["runs"] == ref.ba_stats["runs"] >= 1
    assert [s.is_keyframe for s in port.trajectory] == [s.is_keyframe for s in ref.trajectory]
    assert all(s.status == "ok" for s in port.trajectory)
    got, want = port.export_trajectory()[1], ref.export_trajectory()[1]
    assert _gap(got, want) < 1e-3
    assert ate_rmse(got[:, :3, 3], gt[:, :3, 3]) < 0.02
    # The refined keyframe poses are what the export recomposes against.
    for kf in port.keyframes.keyframes:
        np.testing.assert_allclose(port._kf_poses[kf.frame_id], kf.T_wc.numpy(), atol=1e-6)


def test_live_system_with_photometric_ba_runs_pipelined(live_runs):
    """The pipelined loop solves at a keyframe's retirement, a few frames
    after its dispatch; the correction reaches the chain through the
    pending correction. Same keyframes and solves; trajectory within 2e-3 of
    the synchronous loop's."""
    gt, port, _, pipe = live_runs
    assert pipe.ba_stats["runs"] == port.ba_stats["runs"]
    assert [s.frame_id for s in pipe.trajectory] == list(range(12))
    assert [s.is_keyframe for s in pipe.trajectory] == [s.is_keyframe for s in port.trajectory]
    got = pipe.export_trajectory()[1]
    np.testing.assert_allclose(got, port.export_trajectory()[1], atol=2e-3)
    assert ate_rmse(got[:, :3, 3], gt[:, :3, 3]) < 0.02
