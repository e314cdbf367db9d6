"""The fused LM evaluation (`ops.lm_evaluate`) and the texel layout.

On the CPU `lm_evaluate` runs its plain version, which is held here against
the same sums assembled from the JAX package's CPU branch:
`residuals_and_jacobian` (FC) or the constant reference Jacobian of
`lm_level_ic` (IC), `weights` and `robust_cost`, in float64 numpy sums. The
pairs include an all-invalid one, points behind and at the camera, and
points that project exactly onto the last column and row.

With affine brightness (a, b) (non-zero, from a numpy seed) the JAX side
adds its `_affine_residual` and `_affine_columns` to those terms, and the
port's 80-float form is held to the 8 x 8 sums the same way.

Tolerances: the valid count exactly; every sum to rtol 2e-5 of the pair's
scale for it (H: its largest entry; b: sqrt(max H * 2 cost), its
Cauchy-Schwarz bound; cost and sum |r|: themselves), since both sides sum a
few hundred f32 terms in another order. The texel sampler repeats the planar
one's arithmetic on the same values and must be bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image.pyramid import scharr_gradients as jax_scharr  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.lie import so3 as jso3  # noqa: E402
from uwslam_tpu.tracking import photometric as jphoto  # noqa: E402
from uwslam_tpu.tracking import robust as jrobust  # noqa: E402
from uwslam_tpu.tracking.points import TrackPoints as JaxPoints  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch import ops  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.ops import cuda_track  # noqa: E402
from uwslam_tpu_torch.tracking.robust import WeightKind  # noqa: E402

# Power-of-two focal lengths: a depth-1 point projects exactly onto the last
# column or row, in both packages.
JCAM = JaxCamera(fx=64.0, fy=64.0, cx=31.5, cy=23.5, width=64, height=48)
CAM = camera_from_jax(JCAM)
B, N = 4, 160
SUM_RTOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _p3d(seed):
    """Exact right and bottom edges, points behind and at the camera, the
    rest random in front."""
    rng = np.random.default_rng(seed)
    x = (JCAM.width - 1.0 - JCAM.cx) / JCAM.fx
    y = (JCAM.height - 1.0 - JCAM.cy) / JCAM.fy
    p = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.4, 0.4, N),
                  rng.uniform(0.8, 3.0, N)], -1)
    p[:8] = np.stack([np.full(8, x), np.linspace(-0.3, 0.3, 8), np.ones(8)], -1)
    p[8:16] = np.stack([np.linspace(-0.45, 0.45, 8), np.full(8, y), np.ones(8)], -1)
    p[16] = [x, y, 1.0]
    p[17:21] = [[0, 0, -1.0], [0, 0, 5e-4], [0, 0, 0.0], [0.1, 0.1, 1e-3]]
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """B pairs: pair 0 has the identity pose and the edge points, pair 2 has
    no valid point, the others random poses and 10% invalid points."""
    rng = np.random.default_rng(0)
    imgs = np.stack([np.asarray(render_plane_view(
        JCAM, jse3.exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)), 2.0))
        for _ in range(B)])
    grads = [jax_scharr(jnp.asarray(im)) for im in imgs]
    gx = np.stack([np.asarray(g[0]) for g in grads])
    gy = np.stack([np.asarray(g[1]) for g in grads])
    p3d = np.stack([_p3d(seed=b) for b in range(B)])
    T = np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.03, (B, 6)), jnp.float32)))
    T[0] = np.eye(4, dtype=np.float32)
    ref_int = (imgs.mean() + rng.normal(0, 20.0, (B, N))).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    valid[0, :21] = True
    valid[2] = False
    sigma = np.array([0.3, 7.5, 4.0, 12.0], np.float32)   # 0.3 is clamped at 1
    ref_gx = rng.normal(0, 15.0, (B, N)).astype(np.float32)
    ref_gy = rng.normal(0, 15.0, (B, N)).astype(np.float32)
    ab = np.stack([rng.normal(0, 0.05, B), rng.normal(0, 4.0, B)], -1).astype(np.float32)
    return dict(imgs=imgs, gx=gx, gy=gy, p3d=p3d, T=T, ref_int=ref_int, valid=valid,
                sigma=sigma, ref_gx=ref_gx, ref_gy=ref_gy, ab=ab)


def _ic_jacobian(s):
    """The constant Jacobian of the JAX `lm_level_ic` (B, N, 6): reference
    gradients at the identity warp, 0 where the point is invalid."""
    p3d = jnp.asarray(s["p3d"])
    Jp = JCAM.project_jacobian(p3d)
    g = s["ref_gx"][..., None] * Jp[..., 0, :] + s["ref_gy"][..., None] * Jp[..., 1, :]
    Jw = jnp.einsum("bnj,bnjk->bnk", g, -jso3.hat(p3d))
    return jnp.where(s["valid"][..., None], jnp.concatenate([g, Jw], axis=-1), 0.0)


def _jax_terms(s, mode):
    """Per-point r, J, valid of the JAX package (CPU branch), (B, N, ...)."""
    pts = JaxPoints(uv=np.zeros((B, N, 2), np.float32), p3d=s["p3d"],
                    intensity=s["ref_int"], valid=s["valid"])
    r, J, valid = jax.vmap(lambda T_, p, ri, im, x, y: jphoto.residuals_and_jacobian(
        T_, p, ri, im, x, y, JCAM))(s["T"], jax.tree.map(jnp.asarray, pts),
                                    s["ref_int"], s["imgs"], s["gx"], s["gy"])
    if mode == "ic":
        # Masked by the evaluation's validity, as the JAX solve masks it.
        J = jnp.where(valid[..., None], _ic_jacobian(s), 0.0)
    return r, J, valid


def _jax_sums(s, mode, kind, affine=False):
    """The 45 sums of each pair (75 with affine brightness) from the JAX
    package's per-point terms, weights and cost, summed in float64."""
    r, J, valid = _jax_terms(s, mode)
    if affine:
        r = jax.vmap(jphoto._affine_residual)(r, s["ref_int"], s["ab"], valid)
        J = jnp.concatenate([J, jax.vmap(jphoto._affine_columns)(s["ref_int"], valid)], -1)
    jkind = jrobust.WeightKind(kind)
    w = jax.vmap(lambda r_, v_, s_: jrobust.weights(r_, v_, jkind, sigma=s_))(
        r, valid, s["sigma"])
    cost = jax.vmap(lambda r_, v_, s_: jrobust.robust_cost(r_, v_, jkind, sigma=s_))(
        r, valid, s["sigma"])
    r, J, w, valid = (np.asarray(x, np.float64) for x in (r, J, w, valid))
    count = valid.sum(-1)
    H = np.einsum("bni,bn,bnj->bij", J, w, J)
    b = -np.einsum("bni,bn,bn->bi", J, w, r)
    cost_sum = np.asarray(cost, np.float64) * np.maximum(count, 1)
    tail = np.stack([cost_sum, np.abs(r).sum(-1), count], -1)
    return np.concatenate([H.reshape(B, -1), b, tail], -1), np.asarray(valid, bool)


def _port_sums(s, mode, kind, affine=False):
    if mode == "fc":
        target = ops.pack_texels(_t(s["imgs"]), _t(s["gx"]), _t(s["gy"]))
        J_ref = None
    else:
        target = _t(s["imgs"])
        J_ref = _t(_ic_jacobian(s))
    before = ops.lm_evaluate.launches
    out = ops.lm_evaluate(target, _t(s["p3d"]), _t(s["T"]), _t(s["ref_int"]),
                          _t(s["valid"]), _t(s["sigma"]), CAM, WeightKind(kind),
                          J_ref=J_ref, ab=_t(s["ab"]) if affine else None)
    assert ops.lm_evaluate.launches == before   # a CPU tensor launches nothing
    return out.numpy()


def assert_sums_close(got, want, rtol=SUM_RTOL, lay=cuda_track.LM_POSE):
    """Pair by pair: counts equal, every other sum within rtol of its scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[:, lay.count], want[:, lay.count])
    h_scale = np.abs(want[:, lay.H]).max(-1, keepdims=True)
    cost = want[:, lay.cost, None]
    b_scale = np.sqrt(2.0 * h_scale * cost)
    tail = slice(lay.cost, lay.abs_r + 1)
    for sl, scale in ((lay.H, h_scale), (lay.b, b_scale), (tail, np.abs(want[:, tail]))):
        err = np.abs(got[:, sl] - want[:, sl])
        assert (err <= rtol * scale).all(), (sl, float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("kind", ["huber", "none"])
@pytest.mark.parametrize("mode", ["ic", "fc"])
def test_lm_evaluate_plain_matches_jax_sums(scene, mode, kind):
    want, valid = _jax_sums(scene, mode, kind)
    got = _port_sums(scene, mode, kind)
    assert got.shape == (B, cuda_track.LM_POSE.width) and got.dtype == np.float32
    assert valid[0, :17].all() and not valid[0, 17:21].any()   # edges in, behind out
    assert want[2, cuda_track.LM_POSE.count] == 0 and not got[2].any()   # the empty pair
    assert_sums_close(got[:, :45], want)
    assert not got[:, 45:].any()


@pytest.mark.parametrize("kind", ["huber", "none"])
@pytest.mark.parametrize("mode", ["ic", "fc"])
def test_lm_evaluate_plain_affine_matches_jax_sums(scene, mode, kind):
    lay = cuda_track.LM_AFFINE
    want, valid = _jax_sums(scene, mode, kind, affine=True)
    got = _port_sums(scene, mode, kind, affine=True)
    assert got.shape == (B, lay.width) and got.dtype == np.float32
    assert want.shape == (B, lay.count + 1)
    assert want[2, lay.count] == 0 and not got[2].any()   # the empty pair
    assert_sums_close(got[:, :lay.count + 1], want, lay=lay)
    assert not got[:, lay.count + 1:].any()
    # The brightness moves the residual, so the affine sums are not the pose's.
    pose = _port_sums(scene, mode, kind)
    assert not np.allclose(got[:, lay.cost], pose[:, cuda_track.LM_POSE.cost])


def test_lm_evaluate_sigma_is_clamped_at_one(scene):
    s = dict(scene, sigma=np.array([1.0, 7.5, 4.0, 12.0], np.float32))
    np.testing.assert_array_equal(_port_sums(s, "ic", "huber")[0],
                                  _port_sums(scene, "ic", "huber")[0])


def test_lm_evaluate_refuses_tukey(scene):
    with pytest.raises(ValueError):
        _port_sums(scene, "ic", "tukey")


@pytest.mark.parametrize("wrapper", ["bilinear_sample", "warp_sample"])
def test_texel_sampler_equals_planar_bit_for_bit(scene, wrapper):
    s = scene
    imgs, gx, gy = _t(s["imgs"]), _t(s["gx"]), _t(s["gy"])
    texels = ops.pack_texels(imgs, gx, gy)
    planar = torch.stack([imgs, gx, gy], dim=1)
    assert texels.shape == (B, 48, 64, 4) and texels.is_contiguous()
    assert not texels[..., 3].any()
    assert torch.equal(ops.unpack_texels(texels), planar)
    if wrapper == "bilinear_sample":
        rng = np.random.default_rng(5)
        uv = rng.uniform(-2.0, 1.0, (B, N, 2)) + rng.uniform(0, 1, (B, N, 2)) * [66.0, 50.0]
        uv[0, :6] = [[63, 3.5], [63, 47], [5.25, 47], [0, 0], [63.001, 2], [np.nan, 2]]
        uv = _t(uv.astype(np.float32))
        got = ops.cuda_bilinear_sample(texels, uv, texels=True)
        want = ops.cuda_bilinear_sample(planar, uv)
        assert want[1][0, :4].all() and not want[1][0, 4:6].any()
    else:
        got = ops.warp_and_sample(texels, _t(s["p3d"]), _t(s["T"]), CAM, texels=True)
        want = ops.warp_and_sample(planar, _t(s["p3d"]), _t(s["T"]), CAM)
        assert want[1][0, :17].all() and not want[1][0, 17:21].any()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (B, 3, N)
