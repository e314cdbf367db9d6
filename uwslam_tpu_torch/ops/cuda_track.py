"""K2 and its redesign for the H100: warp -> project -> bilinear sample for
a batch of frame pairs (`csrc/warp_sample.cu:uws_warp_sample`), and the
whole Levenberg-Marquardt evaluation in one launch
(`csrc/lm_evaluate.cu:uws_lm_evaluate`).

Both replace the TPU kernel `uwslam_tpu/ops/pallas_track.py:_kernel`
(wrapper `warp_and_sample`), the work of every LM iteration. One pose per
pair, one thread per point; the TPU kernel samples through a bf16 one-hot
matmul, these gather four f32 taps per point with the CPU gather's
semantics. Both are bound by bytes, and at one pair by the launch itself.

`warp_and_sample` returns the (B, C, N) samples. On the TPU the code that
consumes them (residual, Jacobian, robust weights and cost, normal
equations) is fused by XLA; in eager PyTorch it is 30 to 65 small launches
per evaluation. `lm_evaluate` does all of it in the kernel and returns the
pair's sums: H, b, the robust cost's sum, sum |r| and the valid count, 48
floats per pair for the pose alone (`LM_POSE`) and 80 with affine
brightness (`LM_AFFINE`: the residual r - a I_ref - b, and 8 parameters
with the constant columns (-I_ref, -1)). It covers Huber and unweighted
least squares at a given scale sigma, IC (constant reference Jacobian, one
target plane) and FC (Jacobian from the sampled target gradients; the
target as texels). Tukey weights (whose scale is a median of the residuals
at every solve) and the first evaluation of a level (whose residuals give
sigma) take `warp_and_sample` and plain operations.

`WarpSampler` and `LMEvaluator` bind a kernel to one level's constant inputs:
shapes, dtypes, devices and contiguity are checked once, and each call
checks only the pose (and the brightness). `warp_and_sample_plain` and
`lm_evaluate_plain` are the same functions in plain PyTorch: a CPU tensor
takes them, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import so3
from . import _lib
from .cuda_sample import bilinear_sample_plain, sampled_image_shape, unpack_texels

class LMLayout(NamedTuple):
    """Where a pair's sums lie in its row of `lm_evaluate`'s output."""
    n: int          # parameters: the pose's 6, or 8 with the brightness (a, b)
    width: int      # floats per pair; zero after `count`
    H: slice        # H = sum w J J^T, row-major n x n
    b: slice        # b = -sum w J r
    cost: int       # sum rho(r / sigma) sigma^2 over the valid points
    abs_r: int      # sum |r|
    count: int      # valid points


LM_POSE = LMLayout(6, 48, slice(0, 36), slice(36, 42), 42, 43, 44)
LM_AFFINE = LMLayout(8, 80, slice(0, 64), slice(64, 72), 72, 73, 74)
_KINDS = {"none": 0, "huber": 1}   # WeightKind values the kernel computes


def lm_layout(affine: bool) -> LMLayout:
    return LM_AFFINE if affine else LM_POSE


def warp_and_sample_plain(images, p3d, T, cam, texels: bool = False):
    """images (B, C, H, W) or, with texels=True, (B, H, W, 4); p3d (B, N, 3)
    reference-camera points, T (B, 4, 4) (target <- reference) ->
    ((B, C, N) samples, (B, N) valid).

    p_t = R p + t is written out term by term, in the kernel's order; valid =
    z > 1e-3 and the projection inside [0, W-1] x [0, H-1]; samples are 0
    where invalid."""
    if texels:
        images = unpack_texels(images)
    px, py, pz = p3d[..., 0], p3d[..., 1], p3d[..., 2]

    def row(i: int) -> torch.Tensor:
        r = T[:, i, :, None]   # (B, 4, 1): R_i0, R_i1, R_i2, t_i
        return r[:, 0] * px + r[:, 1] * py + r[:, 2] * pz + r[:, 3]

    p_t = torch.stack([row(0), row(1), row(2)], dim=-1)
    vals, in_img = bilinear_sample_plain(images, cam.project(p_t))
    ok = in_img & (p_t[..., 2] > 1e-3)
    return torch.where(ok[:, None, :], vals, 0.0), ok


class WarpSampler:
    """K2 bound to a level's target and points: `sampler(T)` samples at the
    points warped by T (B, 4, 4) -> ((B, C, N) f32, (B, N) bool).

    images (B, C, H, W) f32 or, with texels=True, (B, H, W, 4) f32 (C = 3);
    p3d (B, N, 3) f32; `cam` the level's PinholeCamera."""

    def __init__(self, images, p3d, cam, texels: bool = False):
        self.images, self.p3d, self.cam, self.texels = images, p3d, cam, texels
        self.device = dev = images.device
        if dev.type == "cpu":
            return
        B, C, H, W = sampled_image_shape(images, texels, dev)
        _lib.require(p3d, "p3d", (B, None, 3), dev)
        N = p3d.shape[1]
        self._out_shape, self._pose_shape = (B, C, N), (B, 4, 4)
        self._head = (images.data_ptr(), p3d.data_ptr())
        self._tail = (B, C, H, W, N, cam.fx, cam.fy, cam.cx, cam.cy, int(texels))

    def __call__(self, T):
        if self.device.type == "cpu":
            return warp_and_sample_plain(self.images, self.p3d, T, self.cam, self.texels)
        dev = self.device
        _lib.require(T, "T", self._pose_shape, dev)
        B, _, N = self._out_shape
        out = torch.empty(self._out_shape, dtype=torch.float32, device=dev)
        valid = torch.empty((B, N), dtype=torch.bool, device=dev)
        _lib.launch("uws_warp_sample", dev, *self._head, T.data_ptr(),
                    out.data_ptr(), valid.data_ptr(), *self._tail)
        warp_and_sample.launches += 1
        return out, valid


def warp_and_sample(images, p3d, T, cam, texels: bool = False):
    """One K2 call: images (B, C, H, W) f32 (texels=True: (B, H, W, 4)),
    p3d (B, N, 3) f32, T (B, 4, 4) f32 -> ((B, C, N) f32, (B, N) bool)."""
    return WarpSampler(images, p3d, cam, texels)(T)


warp_and_sample.launches = 0


def fc_jacobian(gx, gy, p3d, T, cam):
    """The forward-compositional Jacobian rows (B, N, 6), [v, w] order, from
    the target gradients gx, gy (B, N) sampled at the warped points:
    dI/d(uv) . d(uv)/dp_t, then dp_t/d(delta) = [R | -R hat(p)] for the
    right update T exp(delta)."""
    R = T[:, :3, :3]
    p_t = torch.einsum("bij,bnj->bni", R, p3d) + T[:, None, :3, 3]
    Jp = cam.project_jacobian(p_t)                            # (B, N, 2, 3)
    g = gx[..., None] * Jp[..., 0, :] + gy[..., None] * Jp[..., 1, :]
    gR = torch.einsum("bnj,bjk->bnk", g, R)
    Jw = torch.einsum("bnj,bnjk->bnk", gR, -so3.hat(p3d))
    return torch.cat([gR, Jw], dim=-1)


def lm_evaluate_plain(target, p3d, T, ref_intensity, pts_valid, sigma, cam, kind,
                      J_ref=None, ab=None):
    """`lm_evaluate` in plain PyTorch -> (B, 48), or (B, 80) with the
    brightness ab (B, 2): K2's plain version, the residual, the Jacobian,
    the affine residual and columns, `tracking.robust`'s weights and cost,
    and the normal equations as the LM loop composes them."""
    from ..tracking import photometric, robust   # tracking imports this module

    fc = J_ref is None
    vals, ok = warp_and_sample_plain(target if fc else target[:, None], p3d, T, cam,
                                     texels=fc)
    valid = pts_valid & ok
    r = torch.where(valid, vals[:, 0] - ref_intensity, 0.0)
    J = fc_jacobian(vals[:, 1], vals[:, 2], p3d, T, cam) if fc else J_ref
    J = torch.where(valid[..., None], J, 0.0)
    if ab is not None:
        r = photometric._affine_residual(r, ref_intensity, ab, valid)
        J = torch.cat([J, photometric._affine_columns(ref_intensity, valid)], dim=-1)
    layout = lm_layout(ab is not None)
    n = layout.n
    wJ = robust.weights(r, valid, kind, sigma=sigma)[..., None] * J
    H = torch.einsum("bni,bnj->bij", J, wJ)
    b = -torch.einsum("bni,bn->bi", wJ, r)
    tail = torch.stack([
        robust.robust_cost_sum(r, valid, kind, sigma=sigma),
        torch.abs(r).sum(-1),
        valid.sum(-1).to(r.dtype),
    ], dim=-1)
    pad = torch.zeros((r.shape[0], layout.width - layout.count - 1), dtype=r.dtype,
                      device=r.device)
    return torch.cat([H.reshape(-1, n * n), b, tail, pad], dim=-1)


def launch_shape(B: int, N: int, sm_count: int) -> tuple[int, int]:
    """(threads per block, blocks per pair) of an `lm_evaluate` launch: blocks
    of 256 threads (the most the affine form takes), and per pair a cluster
    of 1, 2, 4 or 8 of them. One pair of 2048 points spreads over 8 SMs; many
    pairs get fewer blocks each (about two blocks per SM in all), whose
    threads then stride over several points and reduce once."""
    want = min(8, -(-N // 256), max(1, 2 * sm_count // B))
    blocks = 1
    while blocks * 2 <= want:
        blocks *= 2
    return 256, blocks


class LMEvaluator:
    """`lm_evaluate` bound to one level of B pairs: `evaluator(T)` -> the
    (B, 48) sums of the evaluation at poses T (B, 4, 4); with affine=True
    `evaluator(T, ab)` -> the (B, 80) sums at poses T and brightness ab
    (B, 2) f32 (`layout` says where each sum lies).

    target: IC (`J_ref` given, (B, N, 6) f32, 0 where the point is invalid)
    the target level (B, H, W) f32; FC (`J_ref` None) its texels
    (B, H, W, 4) f32 from `pack_texels`. p3d (B, N, 3) f32; ref_intensity
    (B, N) f32 with contiguous rows (a channel of a K3 result will do);
    pts_valid (B, N) bool; sigma (B,) f32, the level's robust
    scale (clamped at 1 as `tracking.robust` does); kind WeightKind.HUBER or
    NONE.

    On the card every call writes the same output buffer, allocated here:
    use or copy a result before the next call."""

    def __init__(self, target, p3d, ref_intensity, pts_valid, sigma, cam, kind,
                 J_ref=None, affine: bool = False):
        if kind.value not in _KINDS:
            raise ValueError(f"lm_evaluate computes {sorted(_KINDS)} weights, not {kind}")
        self._plain_args = (p3d, ref_intensity, pts_valid, sigma, cam, kind, J_ref)
        self.target = target
        self.affine = affine
        self.layout = lm_layout(affine)
        self.device = dev = target.device
        if dev.type == "cpu":
            return
        fc = J_ref is None
        if fc:
            B, _, H, W = sampled_image_shape(target, True, dev)
        else:
            _lib.require(target, "target", (None, None, None), dev)
            B, H, W = target.shape
        _lib.require(p3d, "p3d", (B, None, 3), dev)
        N = p3d.shape[1]
        _lib.require(ref_intensity, "ref_intensity", (B, N), dev, rows=True)
        _lib.require(pts_valid, "pts_valid", (B, N), dev, dtype=torch.bool)
        _lib.require(sigma, "sigma", (B,), dev)
        if not fc:
            _lib.require(J_ref, "J_ref", (B, N, 6), dev)
            if J_ref.data_ptr() % 8:
                raise ValueError("J_ref must be 8-byte aligned")
        self._pose_shape, self._ab_shape = (B, 4, 4), (B, 2)
        self.out = torch.empty((B, self.layout.width), dtype=torch.float32, device=dev)
        self._head = (target.data_ptr(), p3d.data_ptr())
        self._tail = (
            ref_intensity.data_ptr(), pts_valid.data_ptr(),
            0 if fc else J_ref.data_ptr(), sigma.data_ptr(), self.out.data_ptr(),
            B, H, W, N, ref_intensity.stride(0), cam.fx, cam.fy, cam.cx, cam.cy,
            int(fc), int(affine), _KINDS[kind.value],
            *launch_shape(B, N, torch.cuda.get_device_properties(dev).multi_processor_count),
        )

    def __call__(self, T, ab=None):
        if (ab is not None) != self.affine:
            raise ValueError("the brightness ab is given exactly when the evaluator is affine")
        if self.device.type == "cpu":
            p3d, *rest = self._plain_args
            return lm_evaluate_plain(self.target, p3d, T, *rest, ab=ab)
        _lib.require(T, "T", self._pose_shape, self.device)
        if self.affine:
            _lib.require(ab, "ab", self._ab_shape, self.device)
        _lib.launch("uws_lm_evaluate", self.device, *self._head, T.data_ptr(),
                    ab.data_ptr() if self.affine else 0, *self._tail)
        lm_evaluate.launches += 1
        return self.out


def lm_evaluate(target, p3d, T, ref_intensity, pts_valid, sigma, cam, kind,
                J_ref=None, ab=None):
    """One fused LM evaluation (see `LMEvaluator`) -> (B, 48) f32, or
    (B, 80) with the brightness ab (B, 2)."""
    return LMEvaluator(target, p3d, ref_intensity, pts_valid, sigma, cam, kind,
                       J_ref, affine=ab is not None)(T, ab)


lm_evaluate.launches = 0
