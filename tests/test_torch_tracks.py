"""The port's feature-track graph (`map.tracks`) against the JAX package's
on the same match tables: identical tracks, merges and pruning, and
`build_problem` arrays equal to the JAX package's (it is host-side numpy in
both; the port returns tensors on the device it is given, padded to
`max_poses`), down to a solve of the emitted problem by both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.ba import bundle_adjust as jbundle_adjust  # noqa: E402
from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.map import tracks as jtracks  # noqa: E402
from uwslam_tpu_torch.ba import bundle_adjust  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.map import tracks  # noqa: E402

KW = dict(fx=300.0, fy=300.0, cx=159.5, cy=119.5, width=320, height=240)
JCAM, CAM = JaxCamera(**KW), PinholeCamera(**KW)
N_KF, N_PTS, K = 6, 80, 96     # keyframes, scene points, keypoint slots per keyframe


def _world(seed=0, drift=0.0):
    """Scene points seen by N_KF keyframes; in each keyframe the points sit
    in shuffled keypoint slots. -> (T_cw, per keyframe: slot of each point,
    uv of each slot)."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-1.2, 1.2, N_PTS), rng.uniform(-0.9, 0.9, N_PTS),
                  rng.uniform(3.0, 6.0, N_PTS)], -1)
    T_cw = np.stack([
        np.asarray(jse3.exp(jnp.asarray([0.08 * i, 0.02 * i, 0.01 * i, 0.0, 0.01 * i, 0.0],
                                        jnp.float32)))
        for i in range(N_KF)
    ]).astype(np.float32)
    slots, uvs = [], []
    for i in range(N_KF):
        pc = P @ T_cw[i, :3, :3].T + T_cw[i, :3, 3]
        uv = np.stack([KW["fx"] * pc[:, 0] / pc[:, 2] + KW["cx"],
                       KW["fy"] * pc[:, 1] / pc[:, 2] + KW["cy"]], -1)
        uv += 0.2 * rng.standard_normal(uv.shape)
        slot = rng.permutation(K)[:N_PTS]
        table = np.zeros((K, 2), np.float32)
        table[slot] = uv
        slots.append(slot)
        uvs.append(table)
    noisy = T_cw.copy()
    noisy[1:, :3, 3] += drift * rng.standard_normal((N_KF - 1, 3)).astype(np.float32)
    return noisy, slots, uvs, P


def _feed(graph, slots, uvs, seed=1, skip_pairs=True):
    """Match tables between consecutive keyframes (and pairs two apart):
    each point matched with probability 0.85, a few wrong rows marked
    invalid."""
    rng = np.random.default_rng(seed)
    pairs = [(i, i + 1) for i in range(N_KF - 1)]
    if skip_pairs:
        pairs += [(i, i + 2) for i in range(N_KF - 2)]
    for a, b in pairs:
        idx_a = slots[a].copy()
        idx_b = slots[b].copy()
        valid = rng.uniform(size=N_PTS) < 0.85
        wrong = rng.uniform(size=N_PTS) < 0.05
        idx_b[wrong] = rng.integers(0, K, wrong.sum())
        valid &= ~wrong
        graph.add_keyframe_matches(10 * a, 10 * b, idx_a, idx_b, uvs[a][idx_a], uvs[b][idx_b],
                                   valid)


def _graphs(**kw):
    T_cw, slots, uvs, P = _world(**kw)
    gj, gt = jtracks.TrackGraph(), tracks.TrackGraph()
    _feed(gj, slots, uvs)
    _feed(gt, slots, uvs)
    return gj, gt, T_cw, P


def _same_tracks(gj, gt):
    assert sorted(gj.tracks) == sorted(gt.tracks)
    for tid, tr in gj.tracks.items():
        other = gt.tracks[tid].obs
        assert sorted(tr.obs) == sorted(other)
        for k, (uv, slot) in tr.obs.items():
            assert other[k][1] == slot and np.array_equal(other[k][0], uv)


def test_tracks_and_merges_match_jax():
    gj, gt, _, _ = _graphs()
    _same_tracks(gj, gt)
    assert gt._alias == gj._alias and gt._next_id == gj._next_id
    assert max(len(t.obs) for t in gt.tracks.values()) == N_KF


def test_prune_outside_window_matches_jax():
    gj, gt, _, _ = _graphs()
    window = {30, 40, 50}
    gj.prune_outside_window(window)
    gt.prune_outside_window(window)
    _same_tracks(gj, gt)
    assert all(any(k in window for k in t.obs) for t in gt.tracks.values())


def test_track_cap_drops_the_oldest_inactive():
    T_cw, slots, uvs, _ = _world()
    gj, gt = jtracks.TrackGraph(max_tracks=40), tracks.TrackGraph(max_tracks=40)
    _feed(gj, slots, uvs, skip_pairs=False)
    _feed(gt, slots, uvs, skip_pairs=False)
    _same_tracks(gj, gt)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(max_poses=10),
    dict(obs_gate_px=6.0, min_views=2),
    dict(max_landmarks=32, max_obs=128),
], ids=["strict", "padded", "per-observation", "small-capacity"])
def test_build_problem_matches_jax(kwargs):
    gj, gt, T_cw, _ = _graphs(drift=0.002)
    ids = [10 * i for i in range(N_KF)]
    pj, order_j = gj.build_problem(ids, T_cw, JCAM, **kwargs)
    pt, order_t = gt.build_problem(ids, T_cw, CAM, device="cpu", **kwargs)
    assert order_t == order_j and len(order_t) >= 8
    for name in pj._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            assert np.array_equal(a, b), name
    if "max_poses" in kwargs:
        assert pt.T_cw.shape == (10, 4, 4)
        assert torch.equal(pt.T_cw[N_KF:], torch.eye(4).expand(10 - N_KF, 4, 4))
        assert int(pt.obs_kf[pt.obs_valid].max()) < N_KF


def test_build_problem_with_seed_depths_matches_jax():
    gj, gt, T_cw, P = _graphs(drift=0.002)
    ids = [10 * i for i in range(N_KF)]
    # Camera-frame 3D of keyframe 0's slots (what a depth prior would give).
    _, slots, _, _ = _world(drift=0.002)
    p3d = np.zeros((K, 3), np.float32)
    p3d[slots[0]] = (P @ T_cw[0, :3, :3].T + T_cw[0, :3, 3]).astype(np.float32)
    ok = np.zeros(K, bool)
    ok[slots[0]] = True
    seed = {0: (p3d, ok)}
    pj, oj = gj.build_problem(ids, T_cw, JCAM, seed_p3d=seed)
    pt, ot = gt.build_problem(ids, T_cw, CAM, seed_p3d=seed)
    assert oj == ot
    np.testing.assert_allclose(pt.points.numpy(), np.asarray(pj.points), rtol=1e-6, atol=1e-6)


def test_too_few_tracks_give_no_problem():
    g = tracks.TrackGraph()
    assert g.build_problem([0, 10, 20], np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), CAM) is None


def test_emitted_problem_solves_alike_in_both_packages():
    gj, gt, T_cw, _ = _graphs(drift=0.004)
    ids = [10 * i for i in range(N_KF)]
    pj, _ = gj.build_problem(ids, T_cw, JCAM, max_poses=8)
    pt, _ = gt.build_problem(ids, T_cw, CAM, max_poses=8)
    kw = dict(max_iters=10, num_fixed_poses=2, pose_prior_weight=1e3)
    oj = jbundle_adjust(pj, JCAM, **kw)
    ot = bundle_adjust(pt, CAM, **kw)
    np.testing.assert_allclose(ot.T_cw.numpy(), np.asarray(oj.T_cw), atol=5e-4)
    assert float(ot.cost) < float(ot.initial_cost)
    np.testing.assert_allclose(float(ot.cost), float(oj.cost), rtol=2e-2)
