"""Parity of the port's loop closer (`uwslam_tpu_torch.map.loop_closure`)
with the JAX package's, on the cases of tests/test_loop_closure.py, from
the same numpy inputs.

- The host-numpy parts (`_kmeans`, `_vlad`, `_global_desc`, the vocabulary
  and the re-signing of the history) are copies: equal arrays.
- `detect` given the JAX package's PnP samples (`pnp_samples` replaced by a
  function that draws from `PRNGKey(j)` and its split, as the JAX package
  does) accepts the same edge: equal inlier count, T_ij within 1e-4 and the
  scale within 1e-5 (PnP's polish in f32, reductions in another order).
- `optimize` corrects to the same poses within 2e-4 (f32 pose graph of
  16 nodes, 30 passes; the JAX package's own solve moves by ~1e-5 between
  instruction sets) and rescales the same points.
- The gates behave as the JAX package's with the port's own samples.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.map import loop_closure as jlc  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.interop import keyframe_records_from_numpy, loop_edge_from_numpy  # noqa: E402
from uwslam_tpu_torch.map import loop_closure as lc  # noqa: E402

CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
ACAM = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
JACAM = JaxCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def jax_pnp_samples(valid, seed, reverse=False):
    """The minimal samples the JAX package's `detect` draws for history index
    `seed`: PRNGKey(seed) forward, its split's second key in reverse."""
    key = jax.random.PRNGKey(seed)
    if reverse:
        key = jax.random.split(key)[1]
    u = jax.random.uniform(key, (lc.PNP_HYPOTHESES, valid.shape[0]), minval=1e-9, maxval=1.0)
    scores = jnp.where(jnp.asarray(valid.cpu().numpy())[None, :], -jnp.log(-jnp.log(u)), -jnp.inf)
    return torch.from_numpy(np.asarray(jax.lax.top_k(scores, 6)[1]).astype(np.int64))


# ------------------------------------------------------------ host numpy


def test_kmeans_vlad_and_global_desc_equal_jax():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 32)).astype(np.float32)
    vocab = lc._kmeans(X, 16)
    np.testing.assert_array_equal(vocab, jlc._kmeans(X, 16))
    desc = rng.standard_normal((120, 32)).astype(np.float32)
    np.testing.assert_array_equal(lc._vlad(desc, vocab), jlc._vlad(desc, vocab))
    np.testing.assert_array_equal(lc._vlad(desc[:0], vocab), jlc._vlad(desc[:0], vocab))
    valid = rng.random(120) < 0.7
    port = lc.LoopCloser(cam=CAM, device="cpu")
    ref = jlc.LoopCloser(cam=CAM)
    np.testing.assert_array_equal(port._global_desc(desc, valid), ref._global_desc(desc, valid))
    port.vocab = ref.vocab = vocab
    np.testing.assert_array_equal(port._global_desc(desc, valid), ref._global_desc(desc, valid))


def test_bucket_matches_jax():
    for n in (0, 1, 15, 16, 17, 64, 65, 200):
        assert lc._bucket(n, 16) == jlc._bucket(n, 16)
        assert lc._bucket(n, 64) == jlc._bucket(n, 64)


# ---------------------------------------------------- pose-graph correction


def _jrecord(frame_id, T_wc):
    z = jnp.zeros((4, 2))
    return jlc.KeyframeRecord(
        frame_id=frame_id, T_wc=np.asarray(T_wc, np.float32), kp_uv=z,
        kp_desc=jnp.zeros((4, 8)), kp_valid=jnp.zeros(4, bool),
        kp_p3d=jnp.ones((4, 3)), global_desc=np.zeros(8, np.float32),
    )


def _closers(drifted, edge, config):
    """One history through both packages: records, odometry, one loop edge."""
    ref = jlc.LoopCloser(cam=CAM, config=jlc.LoopConfig(**config))
    for i, T in enumerate(drifted):
        ref.history.append(_jrecord(i, T))
        if i > 0:
            ref.odo_rel.append(np.linalg.inv(drifted[i - 1]) @ drifted[i])
    ref.loop_edges.append(edge)
    port = lc.LoopCloser(cam=CAM, config=lc.LoopConfig(**config), device="cpu")
    port.history = keyframe_records_from_numpy(ref.history, "cpu")
    port.odo_rel = [np.array(T) for T in ref.odo_rel]
    port.loop_edges = [loop_edge_from_numpy(edge)]
    return port, ref


def _assert_same_correction(port, ref):
    got, want = port.optimize(), ref.optimize()
    assert got and sorted(got) == sorted(want)
    for fid in want:
        np.testing.assert_allclose(got[fid], want[fid], atol=2e-4)
    for a, b in zip(port.history, ref.history):
        np.testing.assert_allclose(a.kp_p3d.numpy(), np.asarray(b.kp_p3d), rtol=2e-4)
    for a, b in zip(port.odo_rel, ref.odo_rel):
        np.testing.assert_allclose(a, b, atol=5e-4)
    assert [e.scale for e in port.loop_edges] == [e.scale for e in ref.loop_edges]
    return got


def test_drift_corrected_by_loop_edge_like_jax():
    n = 12
    gt, drifted = [], []
    step = np.asarray(jse3.exp(jnp.asarray([0.01, 0.004, 0.0, 0.0, 0.0, 0.002])))
    D = np.eye(4, dtype=np.float32)
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * i if i < n // 2 else 0.1 * (n - 1 - i)
        gt.append(T)
        D = D @ step
        drifted.append((T @ D).astype(np.float32))
    edge = jlc.LoopEdge(i=0, j=n - 1, T_ij=np.linalg.inv(gt[0]) @ gt[-1], num_inliers=50)
    port, ref = _closers(drifted, edge, dict(min_gap=4))
    got = _assert_same_correction(port, ref)
    before = np.linalg.norm(drifted[-1][:3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(got[n - 1][:3, 3] - gt[-1][:3, 3]) < 0.5 * before


@pytest.mark.parametrize("use_sim3", [True, False], ids=["sim3", "se3"])
def test_injected_scale_drift_corrected_like_jax(use_sim3):
    n, total = 12, 1.25
    per_step = total ** (1.0 / (n - 1))
    gt = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.12 * i if i < n // 2 else 0.12 * (n - 1 - i)
        T[1, 3] = 0.05 * i
        gt.append(T)
    drifted, s = [gt[0].copy()], 1.0
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        s *= per_step
        rel[:3, 3] *= s
        drifted.append((drifted[-1] @ rel).astype(np.float32))
    edge = jlc.LoopEdge(i=0, j=n - 1, T_ij=np.linalg.inv(gt[0]) @ gt[-1], num_inliers=50,
                        scale=1.0 / total)
    port, ref = _closers(drifted, edge, dict(min_gap=4, use_sim3=use_sim3))
    got = _assert_same_correction(port, ref)
    if use_sim3:
        before = np.linalg.norm(drifted[-1][:3, 3] - gt[-1][:3, 3])
        assert np.linalg.norm(got[n - 1][:3, 3] - gt[-1][:3, 3]) < before / 5.0


def test_update_poses_matches_jax():
    drifted = [np.eye(4, dtype=np.float32) for _ in range(5)]
    for i, T in enumerate(drifted):
        T[0, 3] = 0.1 * i
    edge = jlc.LoopEdge(i=0, j=4, T_ij=np.eye(4, dtype=np.float32), num_inliers=30)
    port, ref = _closers(drifted, edge, {})
    refined = {2: np.asarray(jse3.exp(jnp.asarray([0.2, 0, 0, 0, 0.01, 0]))), 7: np.eye(4)}
    port.update_poses(refined)
    ref.update_poses(refined)
    for a, b in zip(port.odo_rel, ref.odo_rel):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.history[2].T_wc, ref.history[2].T_wc)


# ------------------------------------------------------------ retrieval


class TestVladRetrieval:
    """tests/test_loop_closure.py's colliding scenes: equal signatures in both
    packages, and VLAD's recall@1 beats mean pooling's."""

    N_SCENES, N_DESC, D = 8, 160, 32

    def _scene_descs(self, rng, basis, noise=0.08, keep=0.75):
        mask = rng.random(basis.shape[0]) < keep
        d = basis[mask] + noise * rng.standard_normal((int(mask.sum()), self.D))
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        return d.astype(np.float32)

    def _build(self, use_vlad):
        rng = np.random.default_rng(42)
        common = rng.standard_normal(self.D)
        common /= np.linalg.norm(common)
        bases = []
        for _ in range(self.N_SCENES):
            w = rng.standard_normal((self.N_DESC // 2, self.D))
            w /= np.linalg.norm(w, axis=1, keepdims=True)
            b = 0.5 * common[None] + 0.8 * np.concatenate([w, -w], axis=0)
            bases.append(b / np.linalg.norm(b, axis=1, keepdims=True))
        kw = dict(use_vlad=use_vlad, vocab_size=16, vocab_min_desc=self.N_SCENES * self.N_DESC // 2)
        port = lc.LoopCloser(cam=CAM, config=lc.LoopConfig(**kw), device="cpu")
        ref = jlc.LoopCloser(cam=CAM, config=jlc.LoopConfig(**kw))
        fid = 0
        for _ in range(2):
            for s in range(self.N_SCENES):
                desc = self._scene_descs(rng, bases[s])
                n = desc.shape[0]
                for closer, record, tensor in ((port, lc.KeyframeRecord, torch.from_numpy),
                                               (ref, jlc.KeyframeRecord, jnp.asarray)):
                    closer.history.append(record(
                        frame_id=fid, T_wc=np.eye(4, dtype=np.float32),
                        kp_uv=tensor(np.zeros((n, 2), np.float32)), kp_desc=tensor(desc),
                        kp_valid=tensor(np.ones(n, bool)),
                        kp_p3d=tensor(np.zeros((n, 3), np.float32)),
                        global_desc=closer._global_desc(desc, np.ones(n, bool))))
                    closer._maybe_train_vocab()
                fid += 1
        return port, ref

    def _recall_at_1(self, closer):
        n = self.N_SCENES
        G = np.stack([r.global_desc for r in closer.history[:n]])
        return sum(int(np.argmax(G @ closer.history[q].global_desc) == q - n)
                   for q in range(n, 2 * n)) / n

    def test_vlad_signatures_equal_jax_and_beat_mean_pooling(self):
        port, ref = self._build(use_vlad=True)
        assert port.vocab is not None
        np.testing.assert_array_equal(port.vocab, ref.vocab)
        for a, b in zip(port.history, ref.history):
            np.testing.assert_array_equal(a.global_desc, b.global_desc)
        r_vlad = self._recall_at_1(port)
        r_mean = self._recall_at_1(self._build(use_vlad=False)[0])
        assert r_vlad >= 0.9 and r_vlad > r_mean + 0.3, (r_vlad, r_mean)
        G = np.stack([r.global_desc for r in port.history[: self.N_SCENES]])
        assert float(np.max(G @ port.history[self.N_SCENES].global_desc)) > \
            lc.LoopConfig().min_similarity_vlad


# -------------------------------------------------- verification gates


N = 128


def _points(rng):
    uv = np.stack([rng.uniform(20, 620, N), rng.uniform(20, 460, N)], axis=-1).astype(np.float32)
    z = rng.uniform(1.5, 3.0, N).astype(np.float32)
    return uv, np.asarray(JACAM.unproject(jnp.asarray(uv), jnp.asarray(z)))


def _descs(rng):
    d = rng.standard_normal((N, 32)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _jrec(closer, fid, uv, p3d, desc):
    return jlc.KeyframeRecord(
        frame_id=fid, T_wc=np.eye(4, dtype=np.float32), kp_uv=jnp.asarray(uv),
        kp_desc=jnp.asarray(desc), kp_valid=jnp.ones(N, bool), kp_p3d=jnp.asarray(p3d),
        global_desc=closer._global_desc(desc, np.ones(N, bool)),
    )


def _adversary(case):
    """tests/test_loop_closure.py:TestAdversarialFalseLoops's histories:
    [candidate, two fillers, current] -> (port closer, JAX closer, T)."""
    seed = {"true": 0, "aliased": 1, "corrupted": 2}[case]
    rng = np.random.default_rng(seed)
    cand_uv, cand_p = _points(rng)
    desc = _descs(rng)
    T = None
    if case == "aliased":
        uv_cur, p_cur = _points(np.random.default_rng(7))
    else:
        xi = ([0.15, 0.05, 0.02, 0.02, 0.03, 0.01] if case == "true"
              else [0.35, 0.15, 0.08, 0.02, 0.05, 0.03])
        T = np.asarray(jse3.exp(jnp.asarray(xi)))
        p_cur = cand_p @ T[:3, :3].T + T[:3, 3]
        uv_cur = np.asarray(JACAM.project(jnp.asarray(p_cur)))
    if case == "corrupted":
        z_bad = p_cur[:, 2] * rng.uniform(0.4, 2.5, N).astype(np.float32)
        p_cur = np.asarray(JACAM.unproject(jnp.asarray(uv_cur), jnp.asarray(z_bad)))
    desc_cur = desc + 0.02 * rng.standard_normal(desc.shape).astype(np.float32)
    ref = jlc.LoopCloser(cam=JACAM, config=jlc.LoopConfig(min_gap=2))
    ref.history.append(_jrec(ref, 0, cand_uv, cand_p, desc))
    for k in (1, 2):
        uv, p = _points(np.random.default_rng(100 + k))
        ref.history.append(_jrec(ref, k, uv, p, _descs(np.random.default_rng(200 + k))))
    ref.history.append(_jrec(ref, 3, uv_cur, p_cur, desc_cur))
    port = lc.LoopCloser(cam=ACAM, config=lc.LoopConfig(min_gap=2), device="cpu")
    port.history = keyframe_records_from_numpy(ref.history, "cpu")
    return port, ref, T


@pytest.mark.parametrize("samples", ["port", "jax"])
@pytest.mark.parametrize("case", ["true", "aliased", "corrupted"])
def test_adversarial_gates_decide_like_jax(case, samples, monkeypatch):
    if samples == "jax":
        monkeypatch.setattr(lc, "pnp_samples", jax_pnp_samples)
    port, ref, T = _adversary(case)
    edge, want = port.detect(), ref.detect()
    if case != "true":
        assert edge is None and want is None and port.loop_edges == []
        return
    assert edge is not None and want is not None
    assert (edge.i, edge.j) == (want.i, want.j) == (0, 3)
    assert np.linalg.norm(edge.T_ij[:3, 3] - np.linalg.inv(T)[:3, 3]) < 0.05
    if samples == "jax":
        assert edge.num_inliers == want.num_inliers
        np.testing.assert_allclose(edge.T_ij, want.T_ij, atol=1e-4)
        np.testing.assert_allclose(edge.scale, want.scale, rtol=1e-5)


def test_detect_then_optimize_match_jax_on_its_samples(monkeypatch):
    """An accepted edge, then the Sim(3) correction of the history it closes."""
    monkeypatch.setattr(lc, "pnp_samples", jax_pnp_samples)
    port, ref, _ = _adversary("true")
    for closer in (port, ref):
        for k in range(1, 4):
            closer.history[k] = closer.history[k]._replace(
                T_wc=np.asarray(jse3.exp(jnp.asarray([0.05 * k, 0.01 * k, 0, 0, 0.01 * k, 0])),
                                np.float32))
        closer.odo_rel = [np.linalg.inv(closer.history[k].T_wc) @ closer.history[k + 1].T_wc
                          for k in range(3)]
    assert port.detect() is not None and ref.detect() is not None
    _assert_same_correction(port, ref)
