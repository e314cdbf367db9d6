"""The bootstrap megastep of one frame, in plain PyTorch: eval.py config 2
(`--features --depth-bootstrap --affine`, the top-K points at depths read
from a coarse inverse-depth prior that is refreshed every frame).

Every stage of the frame, each fed the program's own inputs to it (what the
sample kept of the frame's record and of the record dispatched before it),
so that one rounding flip upstream does not cascade into the next stage's
number: on this path 1e-4 gray levels of input noise move the pose by
7e-3.

- Ingest: as `direct` (the pyramid of 2x2 means and Scharr gradients).
- Detection, on the program's gradients of levels 0-2: Harris (det - 0.04
  tr^2) of the 5 x 5 box means of gx^2, gy^2, gx gy (edge-replicated; the
  box sums as cumulative sums, each one summing in order within blocks of
  16 and adding the scanned totals of the blocks before, whose order the
  program defines its keypoints by), 7 x 7 maximum suppression, 8 px of
  border, the 256 strongest per level (ties to the lower index), subpixel
  parabolas through the raw response, valid above 1e-3 of the 32nd
  strongest; positions in level-0 pixels.
- Descriptors, at the program's keypoints on its pyramid: 8 x 8 bilinear
  samples 2 px apart at the detection level, zero mean, unit norm, times
  the fixed 64 x 64 projection (`data/descriptor_projection.npy`, a copy
  of the package's), unit norm; 0 where invalid or leaving the level.
- Matching, of the previous frame's descriptors with this frame's (both
  the program's): each rounded to bf16 and multiplied in float32, the
  ratio test (1 - s1) < 0.65^2 (1 - s2) both ways, mutual.
- F-RANSAC at 3 px: the uniforms drawn again from the frame id (a CPU
  `torch.Generator` seeded with it, `torch.rand((256, matches))` into
  [1e-9, 1)), the top eight Gumbel keys -log(-log u) of each hypothesis over
  the valid matches (float32, ties to the lower index), a Hartley-normalized
  8-point solve, rank 2 by the smallest eigenvector of F^T F, MSAC scores on
  Sampson distances, the best eight refit by three rounds of weighted
  8-point (1 / (1 + d / t^2) on inliers), the best model any refit visited.
  This stage runs in float64 with `torch.linalg.eigh` (the program solves
  its eigenproblems by float32 iterations of its own): a departure in
  precision only, so that the reference's models are the exact ones.
- Track, from the previous frame's points (the program's, at its prior's
  depths): `direct`'s coarse-to-fine Huber LM with the brightness (a, b)
  solved jointly, residual I_t(w) - (1 + a) I_ref - b, Jacobian columns
  (-I_ref, -1), the state [xi, a, b] of an 8 x 8 damped system, (a, b)
  from 0 at the first level and carried to the next; the scale sigma0 is
  the MAD of the affine residual at the level's initial state and the
  basin guard reads the finest level at the initial pose under the final
  (a, b).
- Prior refresh, from the previous frame's prior (the program's) over the
  program's relative pose: the prior propagated (cell centres unprojected,
  moved, rasterized again, support clamped at 4 and halved); the previous
  points' inverse depths refined by 4 Gauss-Newton steps on the current
  frame at that pose (a 30% trust region, gates on slope, residual and
  depth) and moved into the current frame; the good matches triangulated
  (a ridged 3 x 3 linear solve, gates on depth, 2 px reprojection and
  2e-3 rad parallax); each grid anchored to the propagated one by the
  median ratio of jointly supported cells (8 at least), gated on 50
  refined points and 20 triangulations; the support-weighted fusion,
  anchored once more and filled (3 rounds of neighbour averaging, then the
  median).
- Select: `direct`'s top-K block maxima of level 0's magnitude, at depths
  read from the program's new prior (bilinear over 32 px cells, blended
  0.25 : 0.75 with its median inverse depth, 2.5 where it has none).

As the reference of the output check (the contract in `__init__.py`): the
sample keeps references to the frame's record (its pyramid, keypoints and
descriptors, new prior, points, diagnostics row, relative pose and RANSAC
uniforms) and to the previous record's keypoints, descriptors, prior,
points and relative pose. The LM starts from the previous step's relative
pose (the constant-velocity model) and the prior moves by this step's, as
the records hold them; Track's answer is the frame's relative pose off the
trajectory, as `direct` compares it. The LM's brightness starts from (0, 0)
at every frame, as the program's does, so there is no (a, b) to take.

The numbers, over the sampled frames, and why each limit is what it is. The
limits (`limits/tum_mono_features.json`) come from 22 seeds on an H100,
64 frames each: the largest the program read, and the smallest that the
TF32 control (this reference with TF32 on, in the program's place) read.
A stage with no float32 product that TF32 rounds (the exact ones, the
matching of bf16 values, the float64 F-RANSAC) reads the same in the
control, and its limit comes from the program's side alone.

- `ingest_gap`: as `direct`; exact, limit 0.
- `detect_miss`: the largest share of the reference's valid keypoints that
  the program did not detect at the same position and level. Its sums and
  comparisons round alike on both sides: read 0, limit 0.
- `desc_gap`: the largest |difference| of a descriptor entry (unit
  descriptors). Program 0, control at least 2.1e-4: limit 1e-5.
- `uniforms_gap`: the largest |difference| of the RANSAC uniforms the
  program's step took (kept with its record) from the redraw: exact, limit 0.
- `match_count_gap`: the largest |difference| of the mutual match counts,
  the program's from its diagnostics row. Both sides round the
  descriptors to bf16 and take the same float32 product of the same
  shapes: read 0 on every seed, program and control; limit 0.
- `inlier_count_gap_p90`: the 90th percentile of |difference| of the
  F-RANSAC inlier counts. The program's float32 models differ from the
  float64 ones by rounding, which may move a match that sits on the 3 px
  threshold: program at most 1 (largest single frame 5), control 0. The
  reference with a planted fault in the program's place reads 3.0-4.7 at a
  2.5 px threshold and 3-5 at 4 px (3 seeds), and as the program does at
  2.9 px (1) or with two refits in place of three (0-1): limit 2.
- `track_gap_t_p90` / `track_gap_r_p90`: as `direct`, for the affine LM.
  Program at most 6.7e-8 / 4.4e-7, control at least 5.7e-5 / 7.0e-4:
  limits 1e-5 / 5e-5.
- `prior_gap_p90`: the 90th percentile of the largest |difference| of a
  prior cell's inverse depth, over the reference grid's median. A cell's
  sums add in another order and a point on a gate (reprojection, slope,
  residual) may fall on the other side: program at most 5.9e-3 (one cell
  of one frame up to 0.74), control at least 0.69: limit 0.1. The refresh
  is ill-conditioned: at this scale a frame moves ~1 mm, and a change of
  1e-6 of its translation moves single frames' grids by up to 0.35 of the
  median (the photometric depth refinement's steps hit their 30% trust
  region, points cross the slope gate), so the pose it moves by is the
  step's own, from the record.
- `select_miss`: as `direct`; exact, limit 0.
- `depth_gap_p90`: the 90th percentile of the largest relative gap of the
  depth of a selected point, read at the program's points from its prior:
  exact, read 0 by program and control, limit 0.
- `compared_share`: sampled frames whose predecessor was dispatched just
  before them and whose pose and the two before it are "ok": read 1.0.

A frame whose record holds no relative pose or uniforms, whose
predecessor's holds no relative pose, or whose diagnostics row carries no
match counts (a program from before they were kept) is not comparable: no
number is left out of a frame that is compared, and a number that is not
finite fails the check.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..stats import percentile
from .direct import (
    HUBER_K,
    _Level,
    _pixels,
    _solve,
    at_level,
    bilinear,
    mad_sigma,
    motion,
    pyramid,
    select,
    unproject,
)
from .lie import exp_se3, gap, normalize_se3
from .settings import Settings, from_flags

NUMBERS = ("ingest_gap", "detect_miss", "desc_gap", "uniforms_gap", "match_count_gap",
           "inlier_count_gap_p90", "track_gap_t_p90", "track_gap_r_p90", "prior_gap_p90",
           "select_miss", "depth_gap_p90")

PROJECTION = Path(__file__).resolve().parent / "data" / "descriptor_projection.npy"
# The program's fixed settings of this path (its configuration's defaults).
PER_LEVEL, DETECT_LEVELS, DETECT_BORDER, NMS_RADIUS, BOX_RADIUS = 256, 3, 8, 3, 2
HARRIS_K, MIN_RESPONSE_REL, SCAN_BLOCK = 0.04, 1e-3, 16
PATCH, PATCH_SPACING = 8, 2.0
RATIO, HYPOTHESES, RANSAC_PX = 0.65, 256, 3.0
PRIOR_BLOCK = 32
# Diagnostics row: the plain step's 26 floats, then the two counts.
ROW = 26
# This reference's own flags; the rest go to `settings.from_flags`.
_BOOLS = ("--features", "--depth-bootstrap", "--affine")
_SHRINK = "--bootstrap-shrink"


class FeatureSettings(NamedTuple):
    base: Settings
    shrink: float


def settings(config: dict) -> FeatureSettings:
    """The configuration's flags as this reference implements them: the
    bootstrap megastep needs --features, --depth-bootstrap and --affine."""
    flags, rest, seen, shrink = config["flags"], [], set(), 1.0
    i = 0
    while i < len(flags):
        if flags[i] in _BOOLS:
            seen.add(flags[i])
            i += 1
        elif flags[i] == _SHRINK:
            shrink = float(flags[i + 1])
            i += 2
        else:
            rest += flags[i:i + 2]
            i += 2
    missing = sorted(set(_BOOLS) - seen)
    if missing:
        raise ValueError(f"the features reference checks the bootstrap megastep; "
                         f"the flags lack {missing}")
    return FeatureSettings(base=from_flags(rest), shrink=shrink)


# --------------------------------------------------------------- detection

def _scan(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis: in order within blocks of 16, and
    the blocks' totals, scanned the same way, added."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, -1)
    nb = -(-n // SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(*x.shape[:-1], nb, SCAN_BLOCK)
    inner = _scan(blocks)
    before = F.pad(_scan(inner[..., -1])[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """(C, H, W) -> the (2r+1)^2 box means, edges replicated."""
    k = 2 * r + 1
    p = F.pad(x[None], (r, r, r, r), mode="replicate")[0]
    c = _scan(p.transpose(-1, -2)).transpose(-1, -2)                 # down the rows
    c = torch.cat([c[..., k - 1:k, :], c[..., k:, :] - c[..., :-k, :]], -2)
    c = _scan(c)                                                      # along the columns
    c = torch.cat([c[..., k - 1:k], c[..., k:] - c[..., :-k]], -1)
    return c / torch.full((), float(k * k), device=x.device)


def detect_level(gx: torch.Tensor, gy: torch.Tensor, K: int):
    """One level's corners -> (uv (K, 2) in the level's pixels, valid (K,))."""
    H, W = gx.shape
    sxx, syy, sxy = box_mean(torch.stack([gx * gx, gy * gy, gx * gy]), BOX_RADIUS)
    tr = sxx + syy
    raw = (sxx * syy - sxy * sxy) - HARRIS_K * tr * tr
    peak = F.max_pool2d(raw[None, None], 2 * NMS_RADIUS + 1, stride=1,
                        padding=NMS_RADIUS)[0, 0]
    row = torch.arange(H, device=gx.device)[:, None]
    col = torch.arange(W, device=gx.device)[None, :]
    inside = ((row >= DETECT_BORDER) & (row < H - DETECT_BORDER)
              & (col >= DETECT_BORDER) & (col < W - DETECT_BORDER))
    resp = torch.where((raw >= peak) & inside, raw, -torch.inf).reshape(-1)
    order = torch.sort(resp, descending=True, stable=True).indices[:K]
    score = resp[order]
    v, u = order // W, order % W
    vc, uc = v.clamp(1, H - 2), u.clamp(1, W - 2)

    def offset(lo, c, hi):
        den = lo - 2.0 * c + hi
        return torch.where(den.abs() > 1e-9, 0.5 * (lo - hi) / den, 0.0).clamp(-0.5, 0.5)

    c = raw[vc, uc]
    du = offset(raw[vc, uc - 1], c, raw[vc, uc + 1])
    dv = offset(raw[vc - 1, uc], c, raw[vc + 1, uc])
    bound = torch.clamp(score[K // 8] * MIN_RESPONSE_REL, min=1e-9)
    valid = torch.isfinite(score) & (score > bound)
    return torch.stack([u.float() + du, v.float() + dv], -1), valid


def detect(pyr: dict) -> dict:
    """-> {"uv" (768, 2) level-0 pixels, "level", "valid"}, level by level."""
    uvs, levels, valids = [], [], []
    for lvl in range(DETECT_LEVELS):
        uv, valid = detect_level(pyr["gx"][lvl], pyr["gy"][lvl], PER_LEVEL)
        uvs.append(uv * float(1 << lvl))
        levels.append(torch.full((PER_LEVEL,), lvl, device=uv.device))
        valids.append(valid)
    return {"uv": torch.cat(uvs), "level": torch.cat(levels), "valid": torch.cat(valids)}


@functools.cache
def _projection() -> np.ndarray:
    return np.load(PROJECTION)


def describe(images: list, uv, level, valid) -> torch.Tensor:
    """(K, 64) unit descriptors of the keypoints on the pyramid's images."""
    dev = uv.device
    offs = (torch.arange(PATCH, dtype=torch.float32, device=dev) - (PATCH - 1) / 2.0) \
        * PATCH_SPACING
    dv, du = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([du.reshape(-1), dv.reshape(-1)], -1)          # u fastest
    K = uv.shape[0]
    patches = torch.zeros((K, PATCH * PATCH), device=dev)
    ok = torch.zeros(K, dtype=torch.bool, device=dev)
    for lvl, img in enumerate(images):
        coords = (uv / float(1 << lvl))[:, None, :] + grid[None]
        vals, inside = bilinear(img[None], coords.reshape(-1, 2))
        here = level == lvl
        patches = torch.where(here[:, None], vals[0].reshape(K, -1), patches)
        ok = torch.where(here, inside.reshape(K, -1).all(-1), ok)
    centred = patches - patches.mean(-1, keepdim=True)
    unit = centred / torch.clamp(centred.norm(dim=-1, keepdim=True), min=1e-6)
    desc = unit @ torch.from_numpy(_projection()).to(dev)
    desc = desc / torch.clamp(desc.norm(dim=-1, keepdim=True), min=1e-6)
    return torch.where((valid & ok)[:, None], desc, 0.0)


# ----------------------------------------------------------------- matching

def _best_two(sim, valid_a, valid_b):
    masked = torch.where(valid_b[None, :], sim, -torch.inf)
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :2]
    s1, s2 = masked.gather(-1, order).unbind(-1)
    ok = valid_a & torch.isfinite(s1) & torch.isfinite(s2) \
        & ((1.0 - s1) < (RATIO * RATIO) * (1.0 - s2))
    return order[:, 0], ok


def match(desc_a, desc_b, valid_a, valid_b):
    """-> (idx_b (K_a,), valid (K_a,)): mutual ratio-tested matches."""
    sim = desc_a.to(torch.bfloat16).float() @ desc_b.to(torch.bfloat16).float().t()
    ab, ok_ab = _best_two(sim, valid_a, valid_b)
    ba, ok_ba = _best_two(sim.t(), valid_b, valid_a)
    mutual = ba[ab] == torch.arange(desc_a.shape[0], device=desc_a.device)
    return ab, ok_ab & ok_ba[ab] & mutual


# ---------------------------------------------------------------- F-RANSAC

def draw_uniforms(seed: int, matches: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((HYPOTHESES, matches), generator=gen) * (1.0 - 1e-9) + 1e-9


def _hartley(uv, valid):
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    scale = 2.0 ** 0.5 / torch.clamp(((uv - mean).norm(dim=-1) * w).sum() / n, min=1e-6)
    T = torch.eye(3, dtype=uv.dtype, device=uv.device) * scale
    T[2, 2] = 1.0
    T[:2, 2] = -scale * mean
    return (uv - mean) * scale, T


def _smallest_eigvec(M):
    return torch.linalg.eigh(M)[1][..., :, 0]


def _eight_point(pa, pb, w):
    """Weighted 8-point on normalized points (..., M, 2) -> (..., 3, 3),
    rank 2."""
    xa, ya, xb, yb = pa[..., 0], pa[..., 1], pb[..., 0], pb[..., 1]
    A = torch.stack([xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya,
                     torch.ones_like(xa)], -1) * w[..., None]
    Fm = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 3)
    v3 = _smallest_eigvec(Fm.transpose(-1, -2) @ Fm)
    return Fm - (Fm @ v3[..., None]) @ v3[..., None, :]


def sampson(Fm, uv_a, uv_b):
    ha = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], -1)
    hb = torch.cat([uv_b, torch.ones_like(uv_b[:, :1])], -1)
    Fa = ha @ Fm.transpose(-1, -2)
    Fb = hb @ Fm
    num = (hb * Fa).sum(-1) ** 2
    den = Fa[..., 0] ** 2 + Fa[..., 1] ** 2 + Fb[..., 0] ** 2 + Fb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_inliers(uv_a, uv_b, valid, uniforms) -> torch.Tensor:
    """The F-RANSAC inliers among the valid matches."""
    keys = -torch.log(-torch.log(uniforms.to(valid.device)))
    keys = torch.where(valid[None, :], keys, -torch.inf)
    sample = torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :8]
    a, b = uv_a.double(), uv_b.double()
    pa, Ta = _hartley(a, valid)
    pb, Tb = _hartley(b, valid)
    t2 = RANSAC_PX * RANSAC_PX

    def model(Fn):
        return Tb.t() @ Fn @ Ta

    def msac(Fm):
        d = sampson(Fm, a, b)
        return valid & (d < t2), torch.where(valid, d.clamp(max=t2), 0.0).sum(-1)

    hyp = model(_eight_point(pa[sample], pb[sample], torch.ones(sample.shape, dtype=a.dtype,
                                                                   device=a.device)))
    top = hyp[torch.sort(msac(hyp)[1], stable=True).indices[:8]]
    best, best_score = top, msac(top)[1]
    Fm = top
    for _ in range(3):
        d = sampson(Fm, a, b)
        w = torch.where(valid & (d < t2), 1.0 / (1.0 + d / t2), 0.0)
        Fm = model(_eight_point(pa.expand(8, -1, -1), pb.expand(8, -1, -1), w))
        score = msac(Fm)[1]
        better = score <= best_score
        best = torch.where(better[:, None, None], Fm, best)
        best_score = torch.where(better, score, best_score)
    return msac(best[torch.sort(best_score, stable=True).indices[0]])[0]


# ------------------------------------------------------- track, with (a, b)

class _AffineLevel(_Level):
    """One level's affine residual, Jacobian and robust sums at (T, a, b)."""

    def residual(self, T, ab):
        _, vals, valid = self.warp(T)
        r = vals[0] - self.ref - ab[0] * self.ref - ab[1]
        return torch.where(valid, r, 0.0), valid

    def evaluate(self, T, ab, sigma):
        """-> (H (8, 8), b (8,), mean robust cost, sum |r|, valid count)."""
        p, vals, valid = self.warp(T)
        r = torch.where(valid, vals[0] - self.ref - ab[0] * self.ref - ab[1], 0.0)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        gu = vals[1] * self.cam["fx"] * zi
        gv = vals[2] * self.cam["fy"] * zi
        gR = torch.stack([gu, gv, -(gu * x + gv * y) * zi], -1) @ T[:3, :3]
        J = torch.cat([gR, torch.linalg.cross(self.p3d, gR), -self.ref[:, None],
                       -torch.ones_like(self.ref)[:, None]], -1)
        J = torch.where(valid[:, None], J, 0.0)
        s = torch.clamp(sigma, min=1.0)
        ax = (r / s).abs()
        w = torch.where(valid, torch.clamp(HUBER_K / torch.clamp(ax, min=1e-12), max=1.0), 0.0)
        rho = torch.where(ax <= HUBER_K, 0.5 * ax * ax, HUBER_K * (ax - 0.5 * HUBER_K)) * s * s
        wJ = w[:, None] * J
        n = valid.sum()
        cost = torch.where(valid, rho, 0.0).sum() / torch.clamp(n, min=1)
        return J.t() @ wJ, -(wJ.t() @ r[:, None])[:, 0], cost, r.abs().sum(), n


def lm_level(level: _AffineLevel, T0, ab0, iters: int, eps: float = 1e-4, lam0: float = 1e-4):
    """`direct.lm_level` on the state [xi, a, b] -> (T, ab, sum |r|, count)
    of the best accepted state."""
    sigma = mad_sigma(*level.residual(T0, ab0))
    H, b, err, abs_r, n = level.evaluate(T0, ab0, sigma)
    best = (T0, ab0, H, b, err, abs_r, n)
    lam = lam0
    d = _solve(H, b, lam)
    T, ab = normalize_se3(T0 @ exp_se3(d[:6])), ab0 + d[6:]
    for _ in range(iters):
        H, b, err, abs_r, n = level.evaluate(T, ab, sigma)
        accept = bool(err < best[4]) and bool(torch.isfinite(err))
        if accept:
            best = (T, ab, H, b, err, abs_r, n)
        lam = min(max(lam * 0.5 if accept else lam * 4.0, 1e-7), 1e3)
        d = _solve(best[2], best[3], lam)
        ok = bool(torch.isfinite(d).all())
        T, ab = (normalize_se3(best[0] @ exp_se3(d[:6])), best[1] + d[6:]) if ok \
            else (best[0], best[1])
        if (accept and float(d.norm()) < eps) or lam > 500.0 or not ok:
            break
    return best[0], best[1], best[5], best[6]


def track(ref_pyr, tgt_pyr, pts, cam, T_init, levels, iters):
    """Pose target <- reference of the points `pts` (their "uv", "p3d",
    "valid") from `T_init`, with the brightness, coarse to fine -> T."""
    T, ab = T_init, torch.zeros(2, device=T_init.device)
    for lvl in levels:
        cam_l = at_level(cam, lvl)
        ref_int, ref_ok = bilinear(ref_pyr["images"][lvl][None], pts["uv"] / float(1 << lvl))
        tgt = {"image": tgt_pyr["images"][lvl], "gx": tgt_pyr["gx"][lvl],
               "gy": tgt_pyr["gy"][lvl]}
        level = _AffineLevel({"p3d": pts["p3d"], "valid": pts["valid"] & ref_ok}, ref_int[0],
                             tgt, cam_l)
        T, ab, abs_r, n = lm_level(level, T, ab, iters)
    r0, valid0 = level.residual(T_init, ab)
    e_init = r0.abs().sum() / torch.clamp(valid0.sum(), min=1)
    if bool(abs_r / torch.clamp(n, min=1) > e_init * 1.05):
        return T_init
    return T


# ---------------------------------------------------------- the depth prior

class Grid(NamedTuple):
    inv: torch.Tensor      # (Hb, Wb) inverse depth per cell
    weight: torch.Tensor   # (Hb, Wb) support


def project(cam, p):
    z = torch.where(p[:, 2].abs() < 1e-9, 1e-9, p[:, 2])
    return torch.stack([cam["fx"] * p[:, 0] / z + cam["cx"], cam["fy"] * p[:, 1] / z + cam["cy"]],
                       -1)


def rasterize(uv, depth, valid, H: int, W: int) -> Grid:
    """Each cell's mean inverse depth of the valid points in it, and their
    count."""
    Hb, Wb = -(-H // PRIOR_BLOCK), -(-W // PRIOR_BLOCK)
    u = torch.nan_to_num(uv[:, 0], nan=0.0, posinf=0.0, neginf=0.0)
    v = torch.nan_to_num(uv[:, 1], nan=0.0, posinf=0.0, neginf=0.0)
    cell = (torch.floor(v / PRIOR_BLOCK).clamp(0, Hb - 1) * Wb
            + torch.floor(u / PRIOR_BLOCK).clamp(0, Wb - 1)).long()
    inv = torch.where(valid, 1.0 / torch.clamp(depth, min=1e-6), 0.0)
    num = torch.zeros(Hb * Wb, device=uv.device).index_add_(0, cell, inv)
    den = torch.zeros(Hb * Wb, device=uv.device).index_add_(0, cell, valid.float())
    grid = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return Grid(grid.reshape(Hb, Wb), den.reshape(Hb, Wb))


def lower_median(x, mask):
    """The element (n - 1) // 2 of x's sorted masked values; 1 for none."""
    s = torch.sort(x[mask]).values
    return s[(s.numel() - 1) // 2] if s.numel() else x.new_tensor(1.0)


def gauge_ratio(new: Grid, ref: Grid):
    mask = ((new.weight >= 0.2) & (ref.weight >= 0.2) & (new.inv > 1e-6) & (ref.inv > 1e-6))
    if int(mask.sum()) < 8:
        return new.inv.new_tensor(1.0)
    return lower_median(new.inv / torch.clamp(ref.inv, min=1e-6), mask)


def anchored(grid: Grid, ref: Grid, support, least: int):
    """The grid over its gauge ratio to `ref`, emptied below `least` support."""
    inv = grid.inv / gauge_ratio(grid, ref)
    keep = bool(support >= least)
    return Grid(inv if keep else torch.zeros_like(inv),
                grid.weight if keep else torch.zeros_like(grid.weight))


def _shift(x, dy: int, dx: int):
    """out[i, j] = x[i - dy, j - dx], 0 from outside."""
    H, W = x.shape
    out = torch.zeros_like(x)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def fill(grid: Grid) -> Grid:
    inv, w = grid.inv, torch.clamp(grid.weight, max=8.0)
    for _ in range(3):
        acc_v, acc_w = inv * w, w
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            acc_v = acc_v + 0.5 * _shift(inv * w, dy, dx)
            acc_w = acc_w + 0.5 * _shift(w, dy, dx)
        seen = w > 0
        inv = torch.where(seen, inv, torch.where(acc_w > 0,
                                                 acc_v / torch.clamp(acc_w, min=1e-6), 0.0))
        w = torch.where(seen, w, (acc_w > 0).float() * 0.25)
    med = lower_median(inv, w > 0) if float(grid.weight.sum()) > 0 else inv.new_tensor(0.0)
    return Grid(torch.where(w > 0, inv, med), torch.clamp(w, min=1e-3))


def propagate(prior: Grid, T, cam, H: int, W: int) -> Grid:
    Hb, Wb = prior.inv.shape
    yy, xx = torch.meshgrid(torch.arange(Hb, device=T.device, dtype=torch.float32),
                            torch.arange(Wb, device=T.device, dtype=torch.float32),
                            indexing="ij")
    uv = torch.stack([(xx.reshape(-1) + 0.5) * PRIOR_BLOCK,
                      (yy.reshape(-1) + 0.5) * PRIOR_BLOCK], -1)
    inv, w = prior.inv.reshape(-1), prior.weight.reshape(-1)
    p = unproject(uv, 1.0 / torch.clamp(inv, min=1e-6), cam) @ T[:3, :3].t() + T[:3, 3]
    uv_b = project(cam, p)
    valid = ((w > 0) & (inv > 1e-6) & (p[:, 2] > 1e-3) & (uv_b[:, 0] >= 0)
             & (uv_b[:, 0] < W) & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < H))
    g = rasterize(uv_b, p[:, 2], valid, H, W)
    return Grid(g.inv, torch.clamp(g.weight, max=4.0) * 0.5)


def refine_depths(pts, T, tgt, cam):
    """The previous points' inverse depths refined on the current frame at
    the pose T -> (inverse depth, good)."""
    R, t = T[:3, :3], T[:3, 3]
    ones = torch.ones_like(pts["uv"][:, 0])
    Rx = unproject(pts["uv"], ones, cam) @ R.t()
    rho = 1.0 / torch.clamp(pts["p3d"][:, 2], min=1e-6)
    planes = torch.stack([tgt["image"], tgt["gx"], tgt["gy"]])

    def at(rho):
        p = Rx + rho[:, None] * t
        vals, inside = bilinear(planes, project(cam, p))
        r = vals[0] - pts["intensity"]
        zi = 1.0 / torch.where(p[:, 2].abs() < 1e-9, 1e-9, p[:, 2])
        du = cam["fx"] * zi * t[0] - cam["fx"] * p[:, 0] * zi * zi * t[2]
        dv = cam["fy"] * zi * t[1] - cam["fy"] * p[:, 1] * zi * zi * t[2]
        return r, vals[1] * du + vals[2] * dv, inside & (p[:, 2] > 1e-6)

    for _ in range(4):
        r, g, ok = at(rho)
        step = torch.where(ok, g * r / (g * g + 1e-4), 0.0)
        step = torch.maximum(torch.minimum(step, 0.3 * rho), -0.3 * rho)
        rho = torch.clamp(rho - step, 1.0 / 50.0, 1.0 / 0.05)
    r, g, ok = at(rho)
    good = (pts["valid"] & ok & (g.abs() > 0.5) & (r.abs() < 12.0)
            & (rho > 1.0 / 50.0) & (rho < 1.0 / 0.05))
    return rho, good


def triangulate(uv_a, uv_b, valid, T, cam):
    """Matched pixels over the pose b <- a -> (depth in b, good)."""
    ones = torch.ones_like(uv_a[:, 0])
    xa = unproject(uv_a, ones, cam)[:, :2]
    xb = unproject(uv_b, ones, cam)[:, :2]
    Pb = T[:3]
    Pa = torch.eye(4, device=T.device)[:3]
    rows = torch.stack([xa[:, :1] * Pa[2] - Pa[0], xa[:, 1:] * Pa[2] - Pa[1],
                        xb[:, :1] * Pb[2] - Pb[0], xb[:, 1:] * Pb[2] - Pb[1]], 1)
    A, c = rows[..., :3], rows[..., 3]
    AtA = A.transpose(-1, -2) @ A
    ridge = 1e-9 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) + 1e-12
    X = torch.linalg.solve(AtA + ridge[:, None, None] * torch.eye(3, device=T.device),
                           -(A.transpose(-1, -2) @ c[..., None])[..., 0])
    Xb = X @ T[:3, :3].t() + T[:3, 3]
    za, zb = X[:, 2], Xb[:, 2]
    reproj = (project(cam, Xb) - uv_b).norm(dim=-1)
    ra = torch.cat([xa, ones[:, None]], -1)
    rb = torch.cat([xb, ones[:, None]], -1) @ T[:3, :3]
    cos = (ra * rb).sum(-1) / (ra.norm(dim=-1) * rb.norm(dim=-1))
    good = (valid & (za > 0.05) & (za < 50.0) & (zb > 0.05) & (zb < 50.0) & (reproj < 2.0)
            & (torch.arccos(cos.clamp(-1.0, 1.0)) > 2e-3))
    return zb, good


def refresh(prior: Grid, T, prev_pts, tgt, uv_a, uv_b, good, cam, H: int, W: int) -> Grid:
    """The prior of the previous frame carried onto the current one."""
    prop = propagate(prior, T, cam, H, W)
    rho, ok = refine_depths(prev_pts, T, tgt, cam)
    z = 1.0 / torch.clamp(rho, min=1e-6)
    p = unproject(prev_pts["uv"], z, cam) @ T[:3, :3].t() + T[:3, 3]
    uv_t = project(cam, p)
    moved = (ok & (p[:, 2] > 1e-3) & (uv_t[:, 0] >= 0) & (uv_t[:, 0] <= W - 1)
             & (uv_t[:, 1] >= 0) & (uv_t[:, 1] <= H - 1))
    g1 = anchored(rasterize(uv_t, p[:, 2], moved, H, W), prop, ok.sum(), 50)
    depth_b, tri = triangulate(uv_a, uv_b, good, T, cam)
    g2 = anchored(rasterize(uv_b, depth_b, tri, H, W), prop, tri.sum(), 20)
    wsum = g1.weight + g2.weight + prop.weight
    inv = torch.where(wsum > 0, (g1.inv * g1.weight + g2.inv * g2.weight + prop.inv * prop.weight)
                      / torch.clamp(wsum, min=1e-6), 0.0)
    fused = Grid(inv, wsum)
    return fill(Grid(fused.inv / gauge_ratio(fused, prop), wsum))


def prior_depth(prior: Grid, uv, fallback: float, shrink: float):
    """Depth at pixels from the grid, blended toward its median inverse depth."""
    Hb, Wb = prior.inv.shape
    gx, gy = uv[:, 0] / PRIOR_BLOCK - 0.5, uv[:, 1] / PRIOR_BLOCK - 0.5
    x0, y0 = torch.floor(gx).clamp(0, Wb - 2), torch.floor(gy).clamp(0, Hb - 2)
    dx, dy = (gx - x0).clamp(0.0, 1.0), (gy - y0).clamp(0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    g = prior.inv
    inv = (g[y0, x0] * (1 - dx) * (1 - dy) + g[y0, x0 + 1] * dx * (1 - dy)
           + g[y0 + 1, x0] * (1 - dx) * dy + g[y0 + 1, x0 + 1] * dx * dy)
    if shrink < 1.0:
        inv = torch.where(inv > 1e-6, shrink * inv + (1.0 - shrink)
                          * lower_median(prior.inv, prior.weight > 0), inv)
    return torch.where(inv > 1e-6, 1.0 / torch.clamp(inv, min=1e-6), fallback)


# ------------------------------------------------------------- the check

def keep(rec: dict, prev: dict | None) -> tuple:
    """References to a dispatched frame's pyramid, features, new prior,
    points, diagnostics row, relative pose and RANSAC uniforms, and to its
    predecessor's features, prior, points and relative pose (the pose and
    the uniforms where the record has them)."""
    mine = (rec["frame_id"], rec["pyr"], rec["feats"], rec["prior"], rec["pts"], rec["diag"],
            rec.get("T_rel"), rec.get("uniforms"))
    before = None if prev is None else (prev["frame_id"], prev["feats"], prev["prior"],
                                        prev["pts"], prev.get("T_rel"))
    return mine, before


def _counts(diag, state):
    """The row's match and inlier counts, or None where it carries none:
    the stage times, where there are any, follow the counts."""
    stamped = len(getattr(state, "step_ms", None) or ())
    if len(diag) - stamped < ROW + 2:
        return None
    return float(diag[ROW]), float(diag[ROW + 1])


def _points(pts) -> dict:
    return {"uv": pts.uv[0], "p3d": pts.p3d[0], "valid": pts.valid[0],
            "intensity": pts.intensity[0]}


def _grid(prior) -> Grid:
    return Grid(prior.inv_depth, prior.weight)


def answer(frame_id: int, kept: tuple, states: dict) -> dict | None:
    """A sampled frame's answers and the program's inputs to each stage;
    None unless its predecessor was dispatched just before it and the frame
    and the two before it are tracked."""
    (fid, pyr, feats, prior, pts, diag, step_T, uniforms), before = kept
    if before is None or before[0] != fid - 1 or feats is None or before[1] is None:
        return None
    if step_T is None or uniforms is None or before[4] is None:
        return None
    T_rel = motion(states, fid)
    if T_rel is None or motion(states, fid - 1) is None:
        return None
    counts = _counts(diag.cpu().numpy(), states[fid])
    if counts is None:
        return None
    _, (kp_prev, desc_prev), prior_prev, pts_prev, prev_T = before
    kps, desc = feats
    pts_cur = _points(pts)
    return {
        "frame": fid, "T_rel": T_rel,
        # The LM starts from the previous step's motion and the prior moves
        # by this step's, each as the step computed it.
        "T_init": prev_T,
        "T_step": step_T,
        "uniforms": uniforms,
        "pyr": {"images": [x[0] for x in pyr.images], "gx": [x[0] for x in pyr.grad_x],
                "gy": [x[0] for x in pyr.grad_y], "gm": [x[0] for x in pyr.grad_mag]},
        "kp_uv": kps.uv, "kp_level": kps.level, "kp_valid": kps.valid, "desc": desc,
        "prev_kp_uv": kp_prev.uv, "prev_kp_valid": kp_prev.valid, "prev_desc": desc_prev,
        "prev_prior": _grid(prior_prev), "prev_pts": _points(pts_prev),
        "prior": _grid(prior), "counts": counts,
        "uv": pts_cur["uv"], "valid": pts_cur["valid"], "depth": pts_cur["p3d"][:, 2],
    }


def reference(ring, answer: dict, config: dict, device) -> dict:
    """The reference's answers for frame i, each stage from the program's
    inputs to it (in `answer`); the LM's reference frame i - 1 from the
    ring."""
    i = answer["frame"]
    s = settings(config)
    cam = config["camera"]
    H, W = cam["height"], cam["width"]
    own = pyramid(ring.frame(i).to(device), s.base.levels)
    prev = pyramid(ring.frame(i - 1).to(device), s.base.levels)
    pyr = {k: [x.to(device) for x in v] for k, v in answer["pyr"].items()}
    kps = detect(pyr)
    kp_uv, kp_level, kp_valid = (answer[k].to(device) for k in ("kp_uv", "kp_level", "kp_valid"))
    desc = describe(pyr["images"], kp_uv, kp_level, kp_valid)
    idx_b, mutual = match(answer["prev_desc"].to(device), answer["desc"].to(device),
                          answer["prev_kp_valid"].to(device), kp_valid)
    uv_a, uv_b = answer["prev_kp_uv"].to(device), kp_uv[idx_b]
    uniforms = draw_uniforms(i, uv_a.shape[0])
    inliers = ransac_inliers(uv_a, uv_b, mutual, uniforms)
    good = mutual & inliers
    prev_pts = {k: v.to(device) for k, v in answer["prev_pts"].items()}
    T = track(prev, pyr, prev_pts, cam, answer["T_init"].to(device), s.base.track_levels,
              s.base.iters)
    tgt = {"image": pyr["images"][0], "gx": pyr["gx"][0], "gy": pyr["gy"][0]}
    prior_prev = Grid(answer["prev_prior"].inv.to(device), answer["prev_prior"].weight.to(device))
    new = refresh(prior_prev, answer["T_step"].to(device), prev_pts, tgt, uv_a, uv_b, good,
                  cam, H, W)
    chosen = select(pyr, cam, s.base.num_points, s.base.mono_depth)
    given = Grid(answer["prior"].inv.to(device), answer["prior"].weight.to(device))
    depth = prior_depth(given, answer["uv"].to(device), s.base.mono_depth, s.shrink)
    return {"frame": i, "pyr": own, "kp_uv": kps["uv"], "kp_level": kps["level"],
            "kp_valid": kps["valid"], "desc": desc,
            "uniforms": uniforms, "counts": (float(mutual.sum()), float(good.sum())), "T_rel": T,
            "prior": new, "uv": chosen["uv"], "valid": chosen["valid"], "depth": depth}


def _keypoints(uv, level, valid) -> set:
    return set(zip(map(tuple, uv[valid].cpu().tolist()), level[valid].cpu().tolist()))


def compare(answer: dict, ref: dict) -> dict:
    """The numbers of one frame: `answer` (the program's, or the control's)
    against the reference's."""
    ingest = max(float((a.to(r.device) - r).abs().max())
                 for f in ("images", "gx", "gy", "gm")
                 for a, r in zip(answer["pyr"][f], ref["pyr"][f]))
    want_kp = _keypoints(ref["kp_uv"], ref["kp_level"], ref["kp_valid"])
    got_kp = _keypoints(answer["kp_uv"], answer["kp_level"], answer["kp_valid"])
    desc = float((answer["desc"].to(ref["desc"].device) - ref["desc"]).abs().max())
    uniforms = float((answer["uniforms"].cpu() - ref["uniforms"]).abs().max())
    matches, inliers = (abs(a - b) for a, b in zip(answer["counts"], ref["counts"]))
    t, r = gap(answer["T_rel"].cpu(), ref["T_rel"].cpu())
    got_inv, want_inv = answer["prior"].inv.to(ref["prior"].inv.device), ref["prior"].inv
    prior = float((got_inv - want_inv).abs().max() / lower_median(want_inv, want_inv > 1e-6))
    want, got = _pixels(ref["uv"], ref["valid"]), _pixels(answer["uv"], answer["valid"])
    valid = answer["valid"].to(ref["depth"].device)
    depth = ((answer["depth"].to(ref["depth"].device) - ref["depth"]).abs() / ref["depth"])[valid]
    return {"ingest_gap": ingest, "detect_miss": len(want_kp - got_kp) / max(len(want_kp), 1),
            "desc_gap": desc, "uniforms_gap": uniforms, "match_count_gap": matches,
            "inlier_count_gap": inliers, "track_gap_t": t, "track_gap_r": r, "prior_gap": prior,
            "select_miss": len(want - got) / max(len(want), 1),
            "depth_gap": float(depth.max()) if depth.numel() else 0.0}


def summarize(rows: list[dict]) -> dict:
    """The compared numbers of a sample's per-frame rows: nan for no rows,
    and nan for a number that any row reads as not finite."""
    if not rows:
        return dict.fromkeys(NUMBERS, float("nan"))

    def worst(name, reduce):
        values = [r[name] for r in rows]
        return reduce(values) if np.isfinite(values).all() else float("nan")

    def p90(values):
        return percentile(values, 90)

    return {
        "ingest_gap": worst("ingest_gap", max),
        "detect_miss": worst("detect_miss", max),
        "desc_gap": worst("desc_gap", max),
        "uniforms_gap": worst("uniforms_gap", max),
        "match_count_gap": worst("match_count_gap", max),
        "inlier_count_gap_p90": worst("inlier_count_gap", p90),
        "track_gap_t_p90": worst("track_gap_t", p90),
        "track_gap_r_p90": worst("track_gap_r", p90),
        "prior_gap_p90": worst("prior_gap", p90),
        "select_miss": worst("select_miss", max),
        "depth_gap_p90": worst("depth_gap", p90),
    }
