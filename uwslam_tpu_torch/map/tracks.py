"""Feature-track graph across keyframes: the observations of window BA.

Counterpart of `uwslam_tpu.map.tracks`, host-side numpy like it. uw-slam
never builds landmark tracks (its Map is a stub, src/Map.cpp:33-45). This
structure chains descriptor matches between keyframe pairs (consecutive or
skip pairs) into multi-view tracks and emits a fixed-capacity `BAProblem`:

- the matches of a pair extend existing tracks, open new ones, or merge two
  tracks that meet on a shared keypoint (union-find aliasing);
- a track with at least `min_views` observations becomes a landmark,
  initialized from seed depths (per-keyframe keypoint 3D) where given, else
  by linear triangulation;
- gating is per landmark (every view must reproject within
  `max_init_reproj_px`: strict, right for the window) or per observation
  (`obs_gate_px`: each view judged alone, the landmark kept when two views
  survive: right for a drifted global map);
- the problem is padded to static (L, O) capacities and, with `max_poses`,
  to a static pose count, so every window solve has one shape; only
  surviving landmarks take slots. `build_problem` returns the port's
  `BAProblem` as tensors on the device it is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..ba.schur import BAProblem
from ..camera.model import PinholeCamera


@dataclass
class Track:
    # kf_id -> (uv np(2,), keypoint slot in that keyframe)
    obs: dict


@dataclass
class TrackGraph:
    max_tracks: int = 4096
    tracks: dict = field(default_factory=dict)
    _next_id: int = 0
    # kf_id -> {keypoint slot -> track id} (ids may be aliased after merges)
    _tails: dict = field(default_factory=dict)
    _alias: dict = field(default_factory=dict)

    def _resolve(self, tid: int | None) -> int | None:
        """Union-find lookup through merge aliases; None if the track died."""
        if tid is None:
            return None
        seen = []
        while tid in self._alias:
            seen.append(tid)
            tid = self._alias[tid]
        for s in seen[:-1]:  # path compression
            self._alias[s] = tid
        return tid if tid in self.tracks else None

    def add_keyframe_matches(
        self,
        kf_id_prev: int,
        kf_id_new: int,
        idx_prev: np.ndarray,
        idx_new: np.ndarray,
        uv_prev: np.ndarray,
        uv_new: np.ndarray,
        valid: np.ndarray,
    ) -> None:
        """Extend tracks with matches (prev-kf keypoint a -> new-kf keypoint b).

        The pair need not be consecutive: skip-pair matches (kf[i-3] -> kf[i])
        land in the same tracks via the per-keyframe tail maps."""
        tails_prev = self._tails.setdefault(kf_id_prev, {})
        tails_new = self._tails.setdefault(kf_id_new, {})
        for a, b, ua, ub, ok in zip(idx_prev, idx_new, uv_prev, uv_new, valid):
            if not ok:
                continue
            a = int(a)
            b = int(b)
            ta = self._resolve(tails_prev.get(a))
            tb = self._resolve(tails_new.get(b))
            if ta is None and tb is None:
                tid = self._next_id
                self._next_id += 1
                self.tracks[tid] = Track(obs={
                    kf_id_prev: (np.asarray(ua, np.float64), a),
                    kf_id_new: (np.asarray(ub, np.float64), b),
                })
                tails_prev[a] = tid
                tails_new[b] = tid
            elif tb is None:
                tr = self.tracks[ta]
                tr.obs.setdefault(kf_id_new, (np.asarray(ub, np.float64), b))
                tails_new[b] = ta
            elif ta is None:
                tr = self.tracks[tb]
                tr.obs.setdefault(kf_id_prev, (np.asarray(ua, np.float64), a))
                tails_prev[a] = tb
            elif ta != tb:
                # Two tracks meet on a shared keypoint: merge newer into older
                # (older id keeps the longer history on average).
                keep, drop = (ta, tb) if ta < tb else (tb, ta)
                src = self.tracks.pop(drop)
                dst = self.tracks[keep]
                for k, v in src.obs.items():
                    dst.obs.setdefault(k, v)
                self._alias[drop] = keep
        # Cap memory: drop oldest tracks no longer extendable from the newest
        # keyframe.
        if len(self.tracks) > self.max_tracks:
            active = {self._resolve(t) for t in tails_new.values()}
            for tid in sorted(self.tracks.keys()):
                if len(self.tracks) <= self.max_tracks:
                    break
                if tid not in active:
                    del self.tracks[tid]

    def prune_outside_window(self, kf_ids_in_window: set) -> None:
        dead = [
            tid
            for tid, tr in self.tracks.items()
            if not any(k in kf_ids_in_window for k in tr.obs)
        ]
        for tid in dead:
            del self.tracks[tid]

    def build_problem(
        self,
        kf_ids: list[int],
        T_cw: np.ndarray,
        cam: PinholeCamera,
        max_landmarks: int = 1024,
        max_obs: int = 8192,
        min_views: int = 3,
        max_init_reproj_px: float = 4.0,
        obs_gate_px: float | None = None,
        seed_p3d: dict | None = None,
        max_poses: int | None = None,
        device: str | torch.device = "cpu",
    ) -> tuple[BAProblem, list[int]] | None:
        """Emit a fixed-capacity BAProblem over the window keyframes.

        kf_ids: ordered keyframe ids; T_cw their current camera-from-world
        poses. Gating: with obs_gate_px=None, a landmark survives only if
        EVERY view reprojects within max_init_reproj_px (per-landmark, strict);
        with obs_gate_px set, each observation is judged alone and the
        landmark survives when >= 2 observations do (drift-tolerant).

        seed_p3d: optional {kf_id: (p3d (K,3) camera-frame keypoint 3D,
        valid (K,) bool)} — landmark initialization prefers lifting the first
        seeded observation over two-view triangulation (immune to the
        inter-keyframe drift that breaks wide-baseline triangulation).

        max_poses: pad T_cw to this static pose count (identity-filled, no
        observation refers to the padding) so a growing window keeps one
        problem shape (one captured solve instead of one per window size).

        device: where the problem's tensors go.

        Returns (problem, track_ids in landmark slot order) or None if too
        few tracks survive."""
        kf_pos = {k: i for i, k in enumerate(kf_ids)}
        sel = []
        for tid, tr in self.tracks.items():
            views = sorted(
                (kf_pos[k], k, uv, kp)
                for k, (uv, kp) in tr.obs.items()
                if k in kf_pos
            )
            if len(views) >= min_views:
                sel.append((tid, views))
        if len(sel) < 8:
            return None
        # Longest tracks first: capacity goes to the most constraining ones.
        sel.sort(key=lambda t: -len(t[1]))

        M = len(kf_ids)
        Mp = max(M, max_poses or M)
        T_cw_p = np.tile(np.eye(4, dtype=np.float32), (Mp, 1, 1))
        T_cw_p[:M] = np.asarray(T_cw, np.float32)
        # SE(3) inverses on the host: no device round trip per pose.
        Rm = T_cw_p[:M, :3, :3]
        T_wc = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
        T_wc[:, :3, :3] = Rm.transpose(0, 2, 1)
        T_wc[:, :3, 3] = -np.einsum("nji,nj->ni", Rm, T_cw_p[:M, :3, 3])

        pts = np.zeros((max_landmarks, 3), np.float32)
        obs_kf = np.zeros(max_obs, np.int32)
        obs_lm = np.zeros(max_obs, np.int32)
        obs_uv = np.zeros((max_obs, 2), np.float32)
        obs_valid = np.zeros(max_obs, bool)
        o = 0
        l = 0
        track_order = []
        gate = obs_gate_px if obs_gate_px is not None else max_init_reproj_px

        def _view_errors(X, views):
            errs = []
            for pos, _k, uv, _kp in views:
                pc = T_cw_p[pos][:3, :3] @ X + T_cw_p[pos][:3, 3]
                if pc[2] < 1e-3:
                    errs.append(np.inf)
                    continue
                pu = cam.fx * pc[0] / pc[2] + cam.cx
                pv = cam.fy * pc[1] / pc[2] + cam.cy
                errs.append(float(np.hypot(pu - uv[0], pv - uv[1])))
            return np.asarray(errs)

        for tid, views in sel:
            if l >= max_landmarks or o + len(views) > max_obs:
                break
            # Candidate initializations: seed lift (immune to inter-keyframe
            # drift but carrying depth-prior noise) vs multi-view DLT
            # triangulation under the CURRENT poses (exact when the chain is
            # good — e.g. after loop-closure correction — garbage when it
            # drifted). Judged by their own reprojections: keep whichever
            # passes more views, tie-broken by median error.
            cands = []
            X_seed = self._init_landmark(views, T_cw_p, T_wc, cam, seed_p3d)
            if X_seed is not None:
                cands.append(X_seed)
            if len(views) >= 2:
                X_tri = _triangulate_views_np(views, T_cw_p, cam)
                if X_tri is not None:
                    cands.append(X_tri)
            if not cands:
                continue
            scored = []
            for X in cands:
                errs = _view_errors(X, views)
                ok = errs <= gate
                scored.append((int(ok.sum()), -float(np.median(errs)), X, ok))
            scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
            _, _, X, view_ok = scored[0]
            view_ok = [bool(v) for v in view_ok]
            if obs_gate_px is None:
                # Strict per-landmark gate: all views or nothing.
                if not all(view_ok):
                    continue
            elif sum(view_ok) < 2:
                continue  # < 2 sane views constrain nothing
            pts[l] = X
            track_order.append(tid)
            for (pos, _k, uv, _kp), ok in zip(views, view_ok):
                obs_kf[o] = pos
                obs_lm[o] = l
                obs_uv[o] = uv
                obs_valid[o] = ok
                o += 1
            l += 1
        if l < 8:
            return None
        problem = BAProblem(*(
            torch.from_numpy(a).to(device)
            for a in (T_cw_p, pts, obs_kf, obs_lm, obs_uv, obs_valid)
        ))
        return problem, track_order

    @staticmethod
    def _init_landmark(views, T_cw, T_wc, cam, seed_p3d) -> np.ndarray | None:
        """World-frame landmark initialization: first seeded view, else
        first/last-view linear triangulation. None if nothing finite."""
        if seed_p3d is not None:
            for pos, k, _uv, kp in views:
                entry = seed_p3d.get(k)
                if entry is None:
                    continue
                p3d, valid = entry
                if kp < len(valid) and valid[kp] and p3d[kp][2] > 1e-6:
                    Xw = T_wc[pos][:3, :3] @ np.asarray(
                        p3d[kp], np.float64
                    ) + T_wc[pos][:3, 3]
                    if np.isfinite(Xw).all():
                        return Xw.astype(np.float32)
        (ia, _ka, uva, _), (ib, _kb, uvb, _) = views[0], views[-1]
        X = _triangulate_np(T_cw[ia], T_cw[ib], uva, uvb, cam)
        if not np.isfinite(X).all():
            return None
        return X


def _triangulate_views_np(views, T_cw, cam: PinholeCamera) -> np.ndarray | None:
    """Multi-view linear (DLT) triangulation over ALL of a track's views in
    normalized coordinates. More accurate than first/last two-view when the
    pose chain is good (every observation constrains), and the caller's
    reprojection scoring rejects it when the chain is not."""
    rows = []
    for pos, _k, uv, _kp in views:
        x = (uv[0] - cam.cx) / cam.fx
        y = (uv[1] - cam.cy) / cam.fy
        P = np.asarray(T_cw[pos])[:3, :]
        rows.append(x * P[2] - P[0])
        rows.append(y * P[2] - P[1])
    A = np.stack(rows)
    if not np.isfinite(A).all():
        return None
    try:
        _, _, Vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    X = (X[:3] / X[3]).astype(np.float32)
    return X if np.isfinite(X).all() else None


def _triangulate_np(
    T_cw_a: np.ndarray, T_cw_b: np.ndarray, uv_a, uv_b, cam: PinholeCamera
) -> np.ndarray:
    """Host-side linear triangulation in normalized coords."""
    xa = np.array(
        [(uv_a[0] - cam.cx) / cam.fx, (uv_a[1] - cam.cy) / cam.fy]
    )
    xb = np.array(
        [(uv_b[0] - cam.cx) / cam.fx, (uv_b[1] - cam.cy) / cam.fy]
    )
    Pa = np.asarray(T_cw_a)[:3, :]
    Pb = np.asarray(T_cw_b)[:3, :]
    A = np.stack(
        [
            xa[0] * Pa[2] - Pa[0],
            xa[1] * Pa[2] - Pa[1],
            xb[0] * Pb[2] - Pb[0],
            xb[1] * Pb[2] - Pb[1],
        ]
    )
    # LAPACK's iterative SVD can refuse to converge on a degenerate or badly
    # scaled system; a failed landmark initialization must degrade to "no
    # landmark", never to an exception inside window BA.
    if not np.isfinite(A).all():
        return np.full(3, np.nan, np.float32)
    try:
        _, _, Vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return np.full(3, np.nan, np.float32)
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return np.full(3, np.nan, np.float32)
    return (X[:3] / X[3]).astype(np.float32)
