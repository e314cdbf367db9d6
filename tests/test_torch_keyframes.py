"""Parity of the port's keyframe window (`KeyframeStore.should_insert`,
`insert`, eviction) and landmark table (`MapPoints`) with the JAX
package's, over the same pose sequences. Decisions are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.map import keyframes as jkf  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.map import keyframes  # noqa: E402


def _poses(seed, n=60):
    """A random walk of camera poses: steps of a few cm and degrees, with
    occasional jumps that exceed the translation or rotation bound."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, [0.02, 0.02, 0.01, 0.01, 0.01, 0.02], (n, 6))
    steps[rng.choice(n, 5, replace=False)] *= 6.0
    T = [np.eye(4, dtype=np.float32)]
    for s in steps[1:]:
        T.append(T[-1] @ np.asarray(jse3.exp(jnp.asarray(s, jnp.float32))))
    return np.stack(T).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pass_log", [False, True])
def test_should_insert_decisions_match_jax(seed, pass_log):
    poses = _poses(seed)
    ratios = np.random.default_rng(seed + 10).uniform(0.4, 1.0, len(poses))
    decision = dict(min_inlier_ratio=0.55, max_translation=0.12, max_rotation=0.10,
                    min_gap=3, max_gap=12)
    store = keyframes.KeyframeStore(capacity=4,
                                    decision=keyframes.KeyframeDecision(**decision))
    jstore = jkf.KeyframeStore(capacity=4, decision=jkf.KeyframeDecision(**decision))
    got, want, evicted = [], [], []
    for i, (T, r) in enumerate(zip(poses, ratios)):
        rel = None
        if pass_log and store.latest is not None:
            rel = se3.log(se3.inverse(store.latest.T_wc) @ torch.from_numpy(T)).numpy()
        a = store.should_insert(i, torch.from_numpy(T), float(r), rel_log=rel)
        b = jstore.should_insert(i, jnp.asarray(T), float(r), rel_log=rel)
        got.append(a)
        want.append(b)
        if b:
            out = store.insert(keyframes.Keyframe(i, float(i), torch.from_numpy(T), None, None))
            jout = jstore.insert(jkf.Keyframe(i, float(i), jnp.asarray(T), None, None))
            evicted.append(((out.frame_id if out else None), (jout.frame_id if jout else None)))
    assert got == want
    assert 5 < sum(got) < len(poses)
    assert all(a == b for a, b in evicted)
    assert len(store) == len(jstore) == 4
    np.testing.assert_allclose(store.window_poses().numpy(),
                               np.asarray(jstore.window_poses()), atol=1e-6)


def test_map_points_allocate_and_prune_match_jax():
    mp, jmp = keyframes.MapPoints(capacity=10), jkf.MapPoints(capacity=10)
    rng = np.random.default_rng(0)
    for n in (4, 5, 3):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_array_equal(mp.allocate(pts), jmp.allocate(pts))
    mp.prune(np.array([1, 2]))
    jmp.prune(np.array([1, 2]))
    np.testing.assert_array_equal(mp.positions, jmp.positions)
    np.testing.assert_array_equal(mp.valid, jmp.valid)
