"""Loop detection and pose-graph correction, in PyTorch.

Counterpart of `uwslam_tpu.map.loop_closure`:

- every keyframe leaves a light record (pose, keypoints, descriptors,
  camera-frame 3D points on the device; no pyramid);
- candidates are retrieved by one product against global descriptors: VLAD
  signatures (a k-means vocabulary trained on the session's own
  descriptors, residuals per visual word, intra- and global L2
  normalization), mean pooling until enough descriptors have accumulated;
- a candidate is verified by descriptor matching and PnP-RANSAC, then by
  the inlier ratio, a reverse PnP that must agree with the forward one and
  the dispersion of the inliers' depth ratios;
- an accepted loop triggers pose-graph LM (`ba.pose_graph`, Sim(3) by
  default) over the whole keyframe history, its buffers padded to buckets
  of 16 nodes and 64 edges as in the JAX package, so the graph has the
  same shapes (and on a CUDA device one captured LM pass per shape).

The vocabulary, VLAD and the record keeping are host numpy, copied from the
JAX package, and give the same arrays from the same input. The PnP samples
are the one deviation: the JAX package draws them from `PRNGKey(j)` (j the
history index of the newest keyframe) and its split; the port draws them
with `pnp_samples` from a `torch.Generator` seeded with j, forward first,
then the reverse draw from the same generator. A test that must agree with
the JAX package replaces `pnp_samples` by one that returns JAX's samples.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ba.pose_graph import PoseGraph, Sim3PoseGraph, optimize_pose_graph, optimize_pose_graph_sim3
from ..features import match_descriptors, pnp_from_pixels, sample_hypotheses
from ..lie import se3, sim3

PNP_HYPOTHESES = 128


class KeyframeRecord(NamedTuple):
    frame_id: int
    T_wc: np.ndarray             # (4, 4) f32
    kp_uv: torch.Tensor          # (K, 2) on the device
    kp_desc: torch.Tensor        # (K, D)
    kp_valid: torch.Tensor       # (K,) bool
    kp_p3d: torch.Tensor         # (K, 3) camera frame
    global_desc: np.ndarray      # VLAD signature (K_words * D,) or mean-pooled (D,)


class LoopEdge(NamedTuple):
    i: int             # history index of the older keyframe
    j: int             # history index of the newer keyframe
    T_ij: np.ndarray   # kf_i <- kf_j relative pose
    num_inliers: int
    # Relative monocular scale of kf_j's map against kf_i's gauge (the
    # median PnP-inlier depth ratio): what the Sim(3) pose graph absorbs.
    scale: float = 1.0


@dataclass
class LoopConfig:
    """The JAX package's `LoopConfig`, field for field and default for
    default (its comments there give the measurements behind each gate)."""

    min_gap: int = 8              # keyframes between i and j to count as a loop
    max_candidates: int = 3       # PnP-verified per new keyframe
    min_similarity: float = 0.70  # mean-pool cosine gate (cold start)
    vocab_size: int = 16
    vocab_min_desc: int = 1024
    min_similarity_vlad: float = 0.25
    use_vlad: bool = True
    min_matches: int = 25
    match_ratio: float = 0.80
    pnp_threshold_px: float = 8.0
    pnp_min_inliers: int = 20
    min_inlier_ratio: float = 0.25
    check_reverse_pnp: bool = True
    reverse_max_rot: float = 0.15          # rad
    reverse_max_trans_ratio: float = 0.35  # of |t| (+ 0.1 m absolute floor)
    reverse_min_inlier_fraction: float = 0.3
    max_scale_log_mad: float = 0.35
    odometry_weight: float = 100.0
    loop_weight: float = 30.0
    max_pgo_iters: int = 30
    use_sim3: bool = True


def _bucket(n: int, size: int) -> int:
    return max(size, ((n + size - 1) // size) * size)


def _kmeans(X: np.ndarray, k: int, iters: int = 12, seed: int = 0) -> np.ndarray:
    """Lloyd's k-means with k-means++ seeding: the vocabulary trainer (host
    numpy, once per session)."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((X[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(X[rng.choice(n, p=p)])
    C = np.stack(centers)
    for _ in range(iters):
        assign = np.argmin(((X[:, None, :] - C[None]) ** 2).sum(-1), axis=1)
        for j in range(k):
            m = assign == j
            if m.any():
                C[j] = X[m].mean(axis=0)
    return C.astype(np.float32)


def _vlad(desc: np.ndarray, vocab: np.ndarray) -> np.ndarray:
    """VLAD of (N, D) descriptors over a (K, D) vocabulary: residual sums per
    word, intra-normalized per word, then globally L2-normalized -> (K D,)."""
    K, D = vocab.shape
    if desc.shape[0] == 0:
        return np.zeros(K * D, np.float32)
    assign = np.argmin(((desc[:, None, :] - vocab[None]) ** 2).sum(-1), axis=1)
    V = np.zeros((K, D), np.float32)
    np.add.at(V, assign, desc - vocab[assign])
    norms = np.linalg.norm(V, axis=1, keepdims=True)
    V = V / np.maximum(norms, 1e-9)
    v = V.reshape(-1)
    return (v / max(float(np.linalg.norm(v)), 1e-9)).astype(np.float32)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pnp_samples(valid: torch.Tensor, seed: int, reverse: bool = False) -> torch.Tensor:
    """(PNP_HYPOTHESES, 6) minimal samples for loop verification: from a
    generator seeded with `seed`, the forward draw first and the reverse
    one after it (the JAX package's key and its split)."""
    gen = torch.Generator().manual_seed(seed)
    if reverse:
        sample_hypotheses(valid, PNP_HYPOTHESES, gen)
    return sample_hypotheses(valid, PNP_HYPOTHESES, gen)


def _se3_log_np(T: np.ndarray) -> np.ndarray:
    return se3.log(torch.from_numpy(np.asarray(T, np.float32))).numpy()


@dataclass
class LoopCloser:
    """Keyframe history, loop detection and pose-graph optimization; the
    pose graph runs on `device`."""

    cam: object                                       # PinholeCamera
    config: LoopConfig = field(default_factory=LoopConfig)
    device: str | torch.device = "cuda"
    history: list = field(default_factory=list)       # [KeyframeRecord]
    odo_rel: list = field(default_factory=list)       # [np (4, 4)] i -> i + 1
    loop_edges: list = field(default_factory=list)    # [LoopEdge]
    vocab: np.ndarray | None = None                   # (K, D) visual words
    # The pose graph's LM pass captured per graph shape (on a CUDA device).
    _pgo_graphs: dict = field(default_factory=dict, repr=False)

    def _global_desc(self, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """VLAD signature once the vocabulary exists; mean pooling before."""
        d = desc[valid]
        if self.vocab is not None:
            return _vlad(d, self.vocab)
        g = d.mean(axis=0) if d.shape[0] else np.zeros(desc.shape[1])
        return (g / max(float(np.linalg.norm(g)), 1e-9)).astype(np.float32)

    def _maybe_train_vocab(self) -> None:
        """Train the vocabulary once enough descriptors have accumulated, then
        re-sign the whole history into the (K D) space."""
        cfg = self.config
        if self.vocab is not None or not cfg.use_vlad:
            return
        pools = [_host(r.kp_desc).astype(np.float32)[_host(r.kp_valid)] for r in self.history]
        if sum(p.shape[0] for p in pools) < cfg.vocab_min_desc:
            return
        X = np.concatenate(pools, axis=0)
        # k-means over ~4k points is plenty for K <= 64.
        if X.shape[0] > 4096:
            X = X[np.random.default_rng(0).choice(X.shape[0], 4096, False)]
        self.vocab = _kmeans(X, cfg.vocab_size)
        for k, r in enumerate(self.history):
            self.history[k] = r._replace(global_desc=self._global_desc(
                _host(r.kp_desc).astype(np.float32), _host(r.kp_valid)))

    def add_keyframe(self, kf) -> None:
        """Record a keyframe (it must carry kp_uv, kp_desc, kp_valid, kp_p3d)."""
        g = self._global_desc(_host(kf.kp_desc).astype(np.float32), _host(kf.kp_valid))
        rec = KeyframeRecord(
            frame_id=kf.frame_id, T_wc=_host(kf.T_wc).astype(np.float32),
            kp_uv=kf.kp_uv, kp_desc=kf.kp_desc, kp_valid=kf.kp_valid, kp_p3d=kf.kp_p3d,
            global_desc=g.astype(np.float32),
        )
        if self.history:
            self.odo_rel.append(np.linalg.inv(self.history[-1].T_wc) @ rec.T_wc)
        self.history.append(rec)
        self._maybe_train_vocab()

    # ------------------------------------------------------------- detection

    def detect(self) -> LoopEdge | None:
        """Try to close a loop for the newest keyframe. Returns the accepted
        edge (also appended to `loop_edges`) or None."""
        cfg = self.config
        j = len(self.history) - 1
        if j < cfg.min_gap + 1:
            return None
        cur = self.history[j]
        past = self.history[: j - cfg.min_gap]
        sims = np.stack([r.global_desc for r in past]) @ cur.global_desc
        order = np.argsort(-sims)[: cfg.max_candidates]
        gate = cfg.min_similarity_vlad if self.vocab is not None else cfg.min_similarity
        for n in order:
            if sims[n] < gate:
                break
            cand = past[int(n)]
            m = match_descriptors(cand.kp_desc, cur.kp_desc, cand.kp_valid, cur.kp_valid,
                                  ratio=cfg.match_ratio)
            n_match = int(m.valid.sum())
            if n_match < cfg.min_matches:
                continue
            res = pnp_from_pixels(
                self.cam, cand.kp_p3d[m.idx_a], cur.kp_uv[m.idx_b], m.valid,
                pnp_samples(m.valid, j), threshold_px=cfg.pnp_threshold_px,
                min_inliers=cfg.pnp_min_inliers,
            )
            ok, n_inl = torch.stack([res.ok.long(), res.num_inliers.long()]).tolist()
            if not ok:
                continue
            if n_inl < cfg.min_inlier_ratio * n_match:
                continue   # a thin inlier fraction: typical of a false match set
            if cfg.check_reverse_pnp and not self._reverse_consistent(cand, cur, m, res, j):
                continue
            # Depth-ratio dispersion: tight for a true revisit, wide for
            # corrupted or unrelated structure.
            z_pred = _host(se3.apply(res.T, cand.kp_p3d[m.idx_a]))[:, 2]
            z_cur = _host(cur.kp_p3d[m.idx_b])[:, 2]
            ok = _host(m.valid & res.inliers) & (z_pred > 1e-6) & (z_cur > 1e-6)
            if ok.sum() >= 8:
                logr = np.log(z_pred[ok] / z_cur[ok])
                if float(np.median(np.abs(logr - np.median(logr)))) > cfg.max_scale_log_mad:
                    continue
            # res.T: cur camera <- cand camera, so T_ij (cand <- cur).
            T_ij = np.linalg.inv(_host(res.T).astype(np.float32))
            scale = 1.0
            if cfg.use_sim3 and ok.sum() >= 8:
                # median(z_pred / z_cur) = 1/d for a map of cur inflated by
                # d: the edge's Sim(3) scale.
                s = float(np.median(z_pred[ok] / z_cur[ok]))
                if np.isfinite(s) and 0.2 < s < 5.0:
                    scale = s
            edge = LoopEdge(i=int(n), j=j, T_ij=T_ij, num_inliers=n_inl, scale=scale)
            self.loop_edges.append(edge)
            return edge
        return None

    def _reverse_consistent(self, cand, cur, m, res_fwd, j: int) -> bool:
        """PnP in the mirror direction (cur's 3D against cand's pixels) must
        re-verify most forward inliers and give a pose that composes with the
        forward one to about the identity."""
        cfg = self.config
        res_bwd = pnp_from_pixels(
            self.cam, cur.kp_p3d[m.idx_b], cand.kp_uv[m.idx_a], m.valid,
            pnp_samples(m.valid, j, reverse=True), threshold_px=cfg.pnp_threshold_px,
            min_inliers=cfg.pnp_min_inliers,
        )
        ok, n_bwd, n_fwd = torch.stack(
            [res_bwd.ok.long(), res_bwd.num_inliers.long(), res_fwd.num_inliers.long()]).tolist()
        if not ok:
            return False
        if n_bwd < cfg.reverse_min_inlier_fraction * n_fwd:
            return False
        T_fwd = _host(res_fwd.T).astype(np.float32)   # cur <- cand
        xi = _se3_log_np(T_fwd @ _host(res_bwd.T).astype(np.float32))
        rot_err = float(np.linalg.norm(xi[3:]))
        trans_err = float(np.linalg.norm(xi[:3]))
        t_norm = float(np.linalg.norm(T_fwd[:3, 3]))
        return rot_err <= cfg.reverse_max_rot and trans_err <= (
            cfg.reverse_max_trans_ratio * t_norm + 0.1)

    def update_poses(self, refined: dict[int, np.ndarray]) -> None:
        """Take externally refined keyframe poses (window BA), so that the
        next pose-graph optimization does not start from the stale chain and
        revert the refinement."""
        changed = False
        for k, r in enumerate(self.history):
            T = refined.get(r.frame_id)
            if T is not None:
                self.history[k] = r._replace(T_wc=np.asarray(T, np.float32))
                changed = True
        if changed:
            self.odo_rel = [np.linalg.inv(self.history[k].T_wc) @ self.history[k + 1].T_wc
                            for k in range(len(self.history) - 1)]

    # ------------------------------------------------------------ correction

    def _graph_arrays(self):
        """Bucket-padded node and edge tables of the keyframe history."""
        cfg = self.config
        M = len(self.history)
        Mp, Ep = _bucket(M, 16), _bucket((M - 1) + len(self.loop_edges), 64)
        T = np.tile(np.eye(4, dtype=np.float32), (Mp, 1, 1))
        for k, r in enumerate(self.history):
            T[k] = r.T_wc
        ei = np.zeros(Ep, np.int32)
        ej = np.zeros(Ep, np.int32)
        Tij = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        w = np.zeros(Ep, np.float32)
        valid = np.zeros(Ep, bool)
        for k in range(M - 1):
            ei[k], ej[k], Tij[k], w[k], valid[k] = k, k + 1, self.odo_rel[k], cfg.odometry_weight, True
        for k, e in enumerate(self.loop_edges):
            p = (M - 1) + k
            ei[p], ej[p], Tij[p] = e.i, e.j, e.T_ij
            if cfg.use_sim3 and e.scale != 1.0:
                # Measured relative Sim(3) i <- j: rotation and translation
                # from PnP (metric in kf_i's gauge), scale the drift of j's
                # map against i's.
                Tij[p] = sim3.from_rst(torch.from_numpy(e.T_ij[:3, :3].astype(np.float32)),
                                       np.float32(e.scale),
                                       torch.from_numpy(e.T_ij[:3, 3].astype(np.float32))).numpy()
            w[p], valid[p] = cfg.loop_weight, True
        return T, ei, ej, Tij, w, valid

    def optimize(self) -> dict[int, np.ndarray]:
        """Pose-graph LM over the whole keyframe history -> {frame_id:
        corrected T_wc}, or {} when the solve is rejected. With
        `config.use_sim3` the nodes are Sim(3), a loop edge carries its depth
        ratio, and each keyframe's stored 3D points are rescaled by its
        solved scale."""
        cfg = self.config
        M = len(self.history)
        arrays = self._graph_arrays()
        dev = torch.device(self.device)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        if cfg.use_sim3:
            out = optimize_pose_graph_sim3(Sim3PoseGraph(*tensors), max_iters=cfg.max_pgo_iters,
                                           captured=self._pgo_graphs)
        else:
            out = optimize_pose_graph(PoseGraph(*tensors), max_iters=cfg.max_pgo_iters,
                                      captured=self._pgo_graphs)
        S_new = out.T_wc.cpu()
        c, c0 = torch.stack([out.cost, out.initial_cost]).tolist()
        if not np.isfinite(c) or c > c0:
            return {}
        sc = sim3.scale(S_new[:M]).numpy() if cfg.use_sim3 else np.ones(M, np.float32)
        S_new = S_new.numpy()
        scales_ok = bool(np.isfinite(sc).all() and (sc > 1e-3).all() and (sc < 1e3).all())
        if not (np.isfinite(S_new[:M]).all() and scales_ok):
            # Non-finite poses or degenerate node scales: reject the
            # correction and drop the newest loop edge, so that the next
            # optimization is not broken by the same constraint.
            if self.loop_edges:
                self.loop_edges.pop()
            return {}
        corrected = {}
        T_new = np.zeros((M, 4, 4), np.float32)
        for k, r in enumerate(self.history):
            kp = r.kp_p3d
            if cfg.use_sim3:
                s_k = float(sc[k])
                Tk = np.eye(4, dtype=np.float32)
                Tk[:3, :3] = S_new[k][:3, :3] / s_k
                Tk[:3, 3] = S_new[k][:3, 3]
                # s_k ~ 1/d for a keyframe whose map is inflated by d: the
                # rescaled structure is metric again for later PnP.
                if abs(s_k - 1.0) > 1e-4:
                    kp = r.kp_p3d * s_k
            else:
                Tk = S_new[k]
            T_new[k] = Tk
            self.history[k] = r._replace(T_wc=Tk, kp_p3d=kp)
            corrected[r.frame_id] = Tk
        self.odo_rel = [np.linalg.inv(T_new[k]) @ T_new[k + 1] for k in range(M - 1)]
        if cfg.use_sim3:
            # The node scales went into poses and points: nodes re-enter at
            # scale 1, so the edges' scales are re-gauged too.
            self.loop_edges = [e._replace(scale=1.0) for e in self.loop_edges]
        return corrected
