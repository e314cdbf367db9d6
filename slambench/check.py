"""The output check that decides `correct`.

Answers are checked one by one: each sampled frame's pyramid (Ingest), the
points selected in it (Select) and the pose it ends with (Track). The
sample is drawn from the seed over the frames handed over in the window
(reservoir sampling, so it spans the whole window at a fixed memory cost);
a sampled frame's pyramid and points are kept as the program dispatched
them, its pose is read from `system.trajectory`.

The reference (`reference/`) works every compared quantity out again from
the harness's own 8-bit frames. One thing it takes from the program's
state: the initial pose of the LM, which the live loop sets to the previous
frame's motion (the constant-velocity model). The reference starts from
that same motion, read off the trajectory, so that each comparison is of
one frame's work; the motion it starts from is itself a Track answer of the
previous frame, compared where that frame is sampled.

The numbers, over the sampled frames:

- `ingest_gap`: the largest absolute difference over every level's image,
  gx, gy and |g| (gray levels). For 8-bit frames every product and sum of
  the 2x2 means and the Scharr pass is exact in float32, whatever the
  order, so this comparison is exact: its limit is 0.
- `select_miss`: the largest share of the reference's valid points that
  the program did not select (as a set of pixels); exact on exact
  magnitudes, limit 0.
- `track_gap_t_p90` / `track_gap_r_p90`: the 90th percentile over the
  frames of the translation / rotation angle of T_program^-1 T_reference
  for the frame's relative pose. Not the largest: at a few frames in a
  window the LM is chaotic (a 1e-6 nudge of its initial pose moves the
  reference's own result by up to 1e-3), and the largest gap reads that.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import direct, lie
from .stats import percentile
from .reference.settings import from_flags

NUMBERS = ("ingest_gap", "select_miss", "track_gap_t_p90", "track_gap_r_p90")


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions with TF32 on or off (the
    reference: off; its control: on), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Sample:
    """Reservoir of the pyramids and points of frames dispatched while
    `active`, `size` of them, chosen by a generator of the seed. It wraps the
    system's `_dispatch_pipelined`, the one place where a pipelined frame's
    pyramid and points come back from its graph replay."""

    def __init__(self, system, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.kept: dict[int, tuple] = {}
        self.seen = 0
        self.active = False
        dispatch = system._dispatch_pipelined

        def wrapped(image, ts):
            rec = dispatch(image, ts)
            if self.active:
                self._offer(rec)
            return rec

        system._dispatch_pipelined = wrapped

    def _offer(self, rec) -> None:
        self.seen += 1
        item = (rec["pyr"], rec["pts"])
        if len(self.kept) < self.size:
            self.kept[rec["frame_id"]] = item
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[rec["frame_id"]] = item


def motion(states: dict, i: int):
    """Frame i's relative pose T_i <- i-1 from the trajectory, or None where
    either frame is not a tracked ("ok") pose."""
    a, b = states.get(i - 1), states.get(i)
    if a is None or b is None or a.status != "ok" or b.status != "ok":
        return None
    Ta = torch.from_numpy(np.asarray(a.T_wc, np.float64))
    Tb = torch.from_numpy(np.asarray(b.T_wc, np.float64))
    return (lie.inverse(Tb) @ Ta).to(torch.float32)


def program_frames(sample: Sample, states: dict) -> list[dict]:
    """The sampled frames the program tracked, with what the reference needs
    from its state (the initial motion) beside its answers."""
    out = []
    for i, (pyr, pts) in sorted(sample.kept.items()):
        T_rel, T_init = motion(states, i), motion(states, i - 1)
        if T_rel is None or T_init is None:
            continue
        out.append({
            "frame": i, "T_init": T_init, "T_rel": T_rel,
            "pyr": {"images": [x[0] for x in pyr.images], "gx": [x[0] for x in pyr.grad_x],
                    "gy": [x[0] for x in pyr.grad_y], "gm": [x[0] for x in pyr.grad_mag]},
            "uv": pts.uv[0], "valid": pts.valid[0],
        })
    return out


def reference_frame(ring, i: int, T_init: torch.Tensor, config: dict, device) -> dict:
    """The reference's answers for run frame i: its pyramid, its points and
    its relative pose from the previous frame, tracked from T_init."""
    s = from_flags(config["flags"])
    cam = config["camera"]
    prev = direct.pyramid(ring.frame(i - 1).to(device), s.levels)
    cur = direct.pyramid(ring.frame(i).to(device), s.levels)
    pts_prev = direct.select(prev, cam, s.num_points, s.mono_depth)
    pts_cur = direct.select(cur, cam, s.num_points, s.mono_depth)
    T, _ = direct.track(prev, cur, pts_prev, cam, T_init.to(device), s.track_levels, s.iters)
    return {"frame": i, "pyr": cur, "uv": pts_cur["uv"], "valid": pts_cur["valid"],
            "T_rel": T}


def _pixels(uv, valid) -> set:
    return set(map(tuple, uv[valid].round().long().cpu().tolist()))


def compare(answer: dict, ref: dict) -> dict:
    """The numbers of one frame: `answer` (the program's, or the control's)
    against the reference's."""
    ingest = max(float((a.to(r.device) - r).abs().max())
                 for f in ("images", "gx", "gy", "gm")
                 for a, r in zip(answer["pyr"][f], ref["pyr"][f]))
    want = _pixels(ref["uv"], ref["valid"])
    got = _pixels(answer["uv"], answer["valid"])
    t, r = lie.gap(answer["T_rel"].cpu(), ref["T_rel"].cpu())
    return {"ingest_gap": ingest, "select_miss": len(want - got) / max(len(want), 1),
            "track_gap_t": t, "track_gap_r": r}


def summarize(rows: list[dict]) -> dict:
    """The compared numbers of a sample's per-frame rows (nan for none)."""
    if not rows:
        return dict.fromkeys(NUMBERS, float("nan"))
    return {
        "ingest_gap": max(r["ingest_gap"] for r in rows),
        "select_miss": max(r["select_miss"] for r in rows),
        "track_gap_t_p90": percentile([r["track_gap_t"] for r in rows], 90),
        "track_gap_r_p90": percentile([r["track_gap_r"] for r in rows], 90),
    }


def judge(numbers: dict, compared: int, sampled: int, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: [number, limit]}): every number within its limit,
    and at least `min_compared` of the sample comparable."""
    table = {k: [numbers[k], limits[k]] for k in NUMBERS}
    share = compared / max(sampled, 1)
    table["compared_share"] = [share, limits["min_compared"]]
    ok = share >= limits["min_compared"] and all(
        np.isfinite(v) and v <= lim for k, (v, lim) in table.items() if k in NUMBERS)
    return bool(ok), table
