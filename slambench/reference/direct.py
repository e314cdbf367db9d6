"""Direct monocular tracking of one frame pair, in plain PyTorch.

The three layers of the live frame the output check covers:

- Ingest: the 8-bit frame as float32, its pyramid of 2x2 means and each
  level's Scharr gradients (edge-replicated, / 32, a convolution) and
  magnitude 0.5 |gx| + 0.5 |gy|.
- Select: the `num_points` strongest 8 x 8 block maxima of level 0's
  magnitude, 4 px of border suppressed. A block's maximum compares the
  magnitudes' float32 bit patterns with their low 6 bits dropped (values
  that close are equal) and takes the lowest in-block index among equals;
  blocks are ranked by magnitude, ties in block order. Points sit at the
  monocular depth.
- Track: forward-compositional Levenberg-Marquardt of the pose target <-
  reference over the tracked levels, coarse to fine: at each level the
  scale sigma0 is 1.4826 MAD of the residuals at the level's initial pose,
  Huber weights (k = 1.345) at max(sigma0, 1), normal equations of the
  weighted Jacobian, damping lambda diag(H) + 1e-8 I (lambda from 1e-4,
  halved on an accepted step, times 4 on a rejected one, within
  [1e-7, 1e3]), the update T exp(delta) re-orthonormalized, a fixed budget
  of iterations, a level done once an accepted step is under 1e-4 or
  lambda passes 500. Last, the basin guard: the initial pose is kept where
  the result explains the finest level worse (mean |r| over 1.05 times)
  than the initial pose did.

Bilinear reads are valid inside [0, W-1] x [0, H-1]; their top-left tap is
clamped to (W-2, H-2) with weights from the unclamped floor. Warped points
are valid in front of the camera (z > 1e-3) and inside the image.

As the reference of the output check (the contract in `__init__.py`): a
sampled frame's pyramid and points are kept as the program dispatched
them, its pose is read from `system.trajectory`. One thing the reference
takes from the program's state: the initial pose of the LM, which the live
loop sets to the previous frame's motion (the constant-velocity model). The
reference starts from that same motion, read off the trajectory, so that
each comparison is of one frame's work; the motion it starts from is itself
a Track answer of the previous frame, compared where that frame is sampled.

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

import numpy as np
import torch
import torch.nn.functional as F

from ..stats import percentile
from .lie import exp_se3, gap, inverse, normalize_se3
from .settings import from_flags

NUMBERS = ("ingest_gap", "select_miss", "track_gap_t_p90", "track_gap_r_p90")

HUBER_K = 1.345
MAD_SCALE = 1.4826
BORDER = 4
BLOCK = 8


# ------------------------------------------------------------------ ingest

def pyramid(image_u8: torch.Tensor, levels: int) -> dict:
    """(H, W) uint8 -> {"images", "gx", "gy", "gm"}: lists of (H_l, W_l)."""
    img = image_u8.to(torch.float32)
    images = [img]
    for _ in range(levels - 1):
        x = images[-1]
        H, W = x.shape
        b = x.reshape(H // 2, 2, W // 2, 2)
        images.append((b[:, 0, :, 0] + b[:, 0, :, 1] + b[:, 1, :, 0] + b[:, 1, :, 1]) / 4.0)
    k = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                     device=img.device) / 32.0
    weight = torch.stack([k, k.t()])[:, None]                      # (2, 1, 3, 3)
    gx, gy, gm = [], [], []
    for x in images:
        padded = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")
        g = F.conv2d(padded, weight)[0]
        gx.append(g[0])
        gy.append(g[1])
        gm.append(0.5 * g[0].abs() + 0.5 * g[1].abs())
    return {"images": images, "gx": gx, "gy": gy, "gm": gm}


# ------------------------------------------------------------------ select

def select(pyr: dict, cam: dict, num_points: int, depth: float) -> dict:
    """-> {"uv" (N, 2), "p3d" (N, 3), "valid" (N,)} in rank order, padded
    to `num_points` with invalid points at (0, 0)."""
    gm = pyr["gm"][0]
    H, W = gm.shape
    dev = gm.device
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    interior = (row >= BORDER) & (row < H - BORDER) & (col >= BORDER) & (col < W - BORDER)
    g = torch.where(interior, gm.clamp(min=0.0), 0.0)
    Hb, Wb = H // BLOCK, W // BLOCK
    blocks = g[: Hb * BLOCK, : Wb * BLOCK].reshape(Hb, BLOCK, Wb, BLOCK).permute(0, 2, 1, 3)
    blocks = blocks.reshape(Hb, Wb, BLOCK * BLOCK)
    coarse = blocks.contiguous().view(torch.int32) >> 6            # magnitude to 2^-17
    # the largest coarse value, and the lowest in-block index among equals
    best = coarse.amax(-1, keepdim=True)
    index = torch.arange(BLOCK * BLOCK, device=dev).expand_as(coarse)
    inner = torch.where(coarse == best, index, BLOCK * BLOCK).amin(-1)   # (Hb, Wb)
    by = torch.arange(Hb, device=dev)[:, None]
    bx = torch.arange(Wb, device=dev)[None, :]
    v = by * BLOCK + inner // BLOCK
    u = bx * BLOCK + inner % BLOCK
    val = g[v, u].reshape(-1)
    order = torch.sort(-val, stable=True).indices[:num_points]
    uv = torch.stack([u.reshape(-1)[order], v.reshape(-1)[order]], -1).to(torch.float32)
    valid = val[order] > 0
    pad = num_points - uv.shape[0]
    if pad > 0:
        uv = torch.cat([uv, uv.new_zeros(pad, 2)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    z = torch.full((num_points,), depth, device=dev)
    return {"uv": uv, "p3d": unproject(uv, z, cam), "valid": valid}


# ------------------------------------------------------------------ camera

def at_level(cam: dict, level: int) -> dict:
    f = float(1 << level)
    return {"fx": cam["fx"] / f, "fy": cam["fy"] / f,
            "cx": (cam["cx"] + 0.5) / f - 0.5, "cy": (cam["cy"] + 0.5) / f - 0.5}


def unproject(uv, z, cam):
    return torch.stack([(uv[:, 0] - cam["cx"]) / cam["fx"] * z,
                        (uv[:, 1] - cam["cy"]) / cam["fy"] * z, z], -1)


def bilinear(planes: torch.Tensor, uv: torch.Tensor):
    """planes (C, H, W), uv (N, 2) -> ((C, N), (N,) valid); 0 where invalid."""
    C, H, W = planes.shape
    u, v = uv[:, 0], uv[:, 1]
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.where(valid, u, 0.0)
    v = torch.where(valid, v, 0.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    iu = u0.long().clamp(0, W - 2)
    iv = v0.long().clamp(0, H - 2)
    p = planes.reshape(C, H * W)
    i00 = iv * W + iu

    def tap(i):
        return p[:, i]

    out = (tap(i00) * (1 - du) * (1 - dv) + tap(i00 + 1) * du * (1 - dv)
           + tap(i00 + W) * (1 - du) * dv + tap(i00 + W + 1) * du * dv)
    return torch.where(valid, out, 0.0), valid


# ------------------------------------------------------------------- track

def _median(x, valid):
    s = torch.sort(x[valid]).values
    n = s.shape[0]
    if n == 0:
        return x.new_tensor(float("inf"))
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def mad_sigma(r, valid):
    med = _median(r, valid)
    return MAD_SCALE * _median((r - med).abs(), valid) + 1e-6


class _Level:
    """One level's residual, Jacobian and robust sums at a pose."""

    def __init__(self, pts, ref_int, tgt, cam):
        self.p3d, self.valid0, self.ref, self.cam = pts["p3d"], pts["valid"], ref_int, cam
        self.planes = torch.stack([tgt["image"], tgt["gx"], tgt["gy"]])

    def warp(self, T):
        p = self.p3d @ T[:3, :3].t() + T[:3, 3]
        z = torch.where(p[:, 2].abs() < 1e-9, 1e-9, p[:, 2])
        uv = torch.stack([self.cam["fx"] * p[:, 0] / z + self.cam["cx"],
                          self.cam["fy"] * p[:, 1] / z + self.cam["cy"]], -1)
        vals, inside = bilinear(self.planes, uv)
        return p, vals, self.valid0 & inside & (p[:, 2] > 1e-3)

    def residual(self, T):
        _, vals, valid = self.warp(T)
        return torch.where(valid, vals[0] - self.ref, 0.0), valid

    def evaluate(self, T, sigma):
        """-> (H, b, mean robust cost, sum |r|, valid count)."""
        p, vals, valid = self.warp(T)
        r = torch.where(valid, vals[0] - self.ref, 0.0)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        gu = vals[1] * self.cam["fx"] * zi
        gv = vals[2] * self.cam["fy"] * zi
        # d r / d p_t, then d p_t / d delta = [R | -R hat(p)] for T exp(delta)
        dp = torch.stack([gu, gv, -(gu * x + gv * y) * zi], -1)
        gR = dp @ T[:3, :3]
        Jw = torch.linalg.cross(self.p3d, gR)                     # gR . (-hat(p))
        J = torch.where(valid[:, None], torch.cat([gR, Jw], -1), 0.0)
        s = torch.clamp(sigma, min=1.0)
        ax = (r / s).abs()
        w = torch.where(valid, torch.clamp(HUBER_K / torch.clamp(ax, min=1e-12), max=1.0), 0.0)
        rho = torch.where(ax <= HUBER_K, 0.5 * ax * ax, HUBER_K * (ax - 0.5 * HUBER_K)) * s * s
        wJ = w[:, None] * J
        H = J.t() @ wJ
        b = -(wJ.t() @ r[:, None])[:, 0]
        n = valid.sum()
        cost = torch.where(valid, rho, 0.0).sum() / torch.clamp(n, min=1)
        return H, b, cost, r.abs().sum(), n


def _solve(H, b, lam):
    n = H.shape[0]
    A = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * torch.eye(n, device=H.device)
    return torch.linalg.solve(A, b)


def lm_level(level: _Level, T0, iters: int, eps: float = 1e-4, lam0: float = 1e-4):
    """-> (T, sum |r|, valid count) of the best accepted state."""
    sigma = mad_sigma(*level.residual(T0))
    H, b, err, abs_r, n = level.evaluate(T0, sigma)
    best = (T0, H, b, err, abs_r, n)
    lam = lam0
    T = normalize_se3(T0 @ exp_se3(_solve(H, b, lam)))
    for _ in range(iters):
        H, b, err, abs_r, n = level.evaluate(T, sigma)
        accept = bool(err < best[3]) and bool(torch.isfinite(err))
        if accept:
            best = (T, H, b, err, abs_r, n)
        lam = min(max(lam * 0.5 if accept else lam * 4.0, 1e-7), 1e3)
        d = _solve(best[1], best[2], lam)
        ok = bool(torch.isfinite(d).all())
        T = normalize_se3(best[0] @ exp_se3(d)) if ok else best[0]
        if (accept and float(d.norm()) < eps) or lam > 500.0 or not ok:
            break
    return best[0], best[4], best[5]


def track(ref_pyr, tgt_pyr, pts, cam, T_init, levels, iters):
    """Pose target <- reference (4, 4) of points `pts` selected in the
    reference frame, from `T_init`, over the pyramid `levels` coarse to fine
    -> (T, inliers)."""
    T = T_init
    for lvl in levels:
        cam_l = at_level(cam, lvl)
        uv_l = pts["uv"] * (1.0 / (1 << lvl))
        ref_int, ref_ok = bilinear(ref_pyr["images"][lvl][None], uv_l)
        pts_l = {"p3d": pts["p3d"], "valid": pts["valid"] & ref_ok}
        tgt = {"image": tgt_pyr["images"][lvl], "gx": tgt_pyr["gx"][lvl],
               "gy": tgt_pyr["gy"][lvl]}
        level = _Level(pts_l, ref_int[0], tgt, cam_l)
        T, abs_r, n = lm_level(level, T, iters)
    r0, valid0 = level.residual(T_init)
    e_init = r0.abs().sum() / torch.clamp(valid0.sum(), min=1)
    e_final = abs_r / torch.clamp(n, min=1)
    if bool(e_final > e_init * 1.05):
        return T_init, int(valid0.sum())
    return T, int(n)


# ------------------------------------------------------------- the check

def settings(config: dict):
    """The configuration's flags as this reference implements them."""
    return from_flags(config["flags"])


def keep(rec: dict, prev: dict | None) -> tuple:
    """A dispatched frame's pyramid and points, as the program made them."""
    return rec["pyr"], rec["pts"]


def motion(states: dict, i: int):
    """Frame i's relative pose T_i <- i-1 from the trajectory, or None where
    either frame is not a tracked ("ok") pose."""
    a, b = states.get(i - 1), states.get(i)
    if a is None or b is None or a.status != "ok" or b.status != "ok":
        return None
    Ta = torch.from_numpy(np.asarray(a.T_wc, np.float64))
    Tb = torch.from_numpy(np.asarray(b.T_wc, np.float64))
    return (inverse(Tb) @ Ta).to(torch.float32)


def answer(frame_id: int, kept: tuple, states: dict) -> dict | None:
    """A sampled frame's answers, with what the reference needs from the
    program's state (the initial motion) beside them; None unless the frame
    and the two before it are tracked."""
    pyr, pts = kept
    T_rel, T_init = motion(states, frame_id), motion(states, frame_id - 1)
    if T_rel is None or T_init is None:
        return None
    return {
        "frame": frame_id, "T_init": T_init, "T_rel": T_rel,
        "pyr": {"images": [x[0] for x in pyr.images], "gx": [x[0] for x in pyr.grad_x],
                "gy": [x[0] for x in pyr.grad_y], "gm": [x[0] for x in pyr.grad_mag]},
        "uv": pts.uv[0], "valid": pts.valid[0],
    }


def reference(ring, answer: dict, config: dict, device) -> dict:
    """The reference's answers for the answer's run frame i: its pyramid,
    its points and its relative pose from frame i - 1, tracked from the
    answer's T_init."""
    i = answer["frame"]
    s = settings(config)
    cam = config["camera"]
    prev = pyramid(ring.frame(i - 1).to(device), s.levels)
    cur = pyramid(ring.frame(i).to(device), s.levels)
    pts_prev = select(prev, cam, s.num_points, s.mono_depth)
    pts_cur = select(cur, cam, s.num_points, s.mono_depth)
    T, _ = track(prev, cur, pts_prev, cam, answer["T_init"].to(device), s.track_levels, s.iters)
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
    t, r = gap(answer["T_rel"].cpu(), ref["T_rel"].cpu())
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
