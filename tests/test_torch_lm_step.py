"""The LM update after an evaluation: `tracking.photometric.lm_step` (the
plain version, the CPU's and the Tukey loop's) and its kernel
`ops.cuda_lm.lm_step` (one launch per iteration on a card).

On the CPU: `_lm_loop`, now `lm_start` and `max_iters` calls of `lm_step`,
against a frozen copy of the loop as it was written before the update was
factored out, bit for bit, with pairs that accept, reject, stop early and
meet a NaN cost; and the LM levels counted by path. Marked `cuda` (skipped
without a card): one launch against the plain step on the same state, lane
by lane (integer and boolean fields, the error, the damping and the sums
exact: the kernel forms err and the accept test as the plain version does;
poses and brightness within 2e-6 of each entry's scale, since the plain
version's matmuls and sin / cos round otherwise); whole FC, IC and affine
levels, kernel against plain (T within 1e-5, k equal); the LM levels counted
by path; and a captured level's launches.

This file imports neither JAX nor the JAX package.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import ops  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.image.pyramid import build_pyramid_batched  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.ops.cuda_lm import LMLoop  # noqa: E402
from uwslam_tpu_torch.ops.cuda_track import lm_layout  # noqa: E402
from uwslam_tpu_torch.tracking import photometric  # noqa: E402
from uwslam_tpu_torch.tracking.photometric import LM_LEVELS  # noqa: E402
from uwslam_tpu_torch.tracking.points import topk_gradient_points  # noqa: E402
from uwslam_tpu_torch.tracking.robust import WeightKind  # noqa: E402
from uwslam_tpu_torch.utils.synthetic import render_plane_view  # noqa: E402

CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
MOTION = torch.tensor([[0.01, -0.005, 0.004, 0.002, -0.003, 0.001],
                       [0.20, 0.12, -0.05, 0.05, -0.06, 0.03],
                       [0.06, 0.03, 0.0, 0.012, 0.0, -0.006]])
POSE_RTOL = 2e-6


def _scene(device, B=3, points=256):
    """B views of the textured plane at depth 2 from the identity (the
    reference) and at the poses MOTION (cycled); the reference's strongest
    gradient points at their exact depth."""
    motion = MOTION[torch.arange(B) % len(MOTION)]
    ref = render_plane_view(CAM, se3.identity((B,)), 2.0).to(device)
    tgt = render_plane_view(CAM, se3.exp(motion), 2.0).to(device)
    pr, pt = build_pyramid_batched(ref, levels=2), build_pyramid_batched(tgt, levels=2)
    pts = topk_gradient_points(pr.images[0], pr.grad_mag[0], CAM, num_points=points,
                               mono_z=2.0, block=4, grad_x=pr.grad_x[0], grad_y=pr.grad_y[0])
    return pts, pt


def _evaluator(pts, pt, mode, affine):
    sigma = torch.full((pts.uv.shape[0],), 5.0, device=pts.uv.device)
    if mode == "fc":
        target = ops.pack_texels(pt.images[0], pt.grad_x[0], pt.grad_y[0])
        return ops.LMEvaluator(target, pts.p3d, pts.intensity, pts.valid, sigma, CAM,
                               WeightKind.HUBER, affine=affine)
    J = photometric.ic_jacobian(pts, pts.gx0, pts.gy0, CAM)
    return ops.LMEvaluator(pt.images[0], pts.p3d, pts.intensity, pts.valid, sigma, CAM,
                           WeightKind.HUBER, J_ref=J, affine=affine)


class Scripted:
    """An `LMEvaluator` whose pairs meet scripted faults: from its second call
    on pair 1's cost is ten times its own (each step is rejected until the
    damping passes 500) and at its fourth call pair 2's cost is NaN."""

    def __init__(self, evaluator):
        self.evaluator, self.calls = evaluator, 0
        self.affine, self.layout = evaluator.affine, evaluator.layout

    def __call__(self, T, ab=None):
        sums = self.evaluator(T, ab) if self.affine else self.evaluator(T)
        sums = sums.clone()
        self.calls += 1
        if self.calls >= 2:
            sums[1, self.layout.cost] *= 10.0
        if self.calls == 4:
            sums[2, self.layout.cost] = float("nan")
        return sums


def _lm_loop_before(T0, ab0, first, evaluate, solve, max_iters, eps, init_lambda, affine):
    """`tracking.photometric._lm_loop` as it was before its body became
    `lm_start` and `lm_step`, kept as the reference of the refactor."""
    _where = photometric._where
    B = T0.shape[0]
    error, n_inlier, s_best = first

    def apply_delta(T, delta):
        return se3.normalize(se3.compose(T, se3.exp(delta[:, :6])))

    lam = torch.full((B,), init_lambda, dtype=T0.dtype, device=T0.device)
    delta0 = solve(s_best, lam)
    T = apply_delta(T0, delta0)
    ab = ab0 + delta0[:, 6:] if affine else ab0
    T_best, ab_best = T0, ab0
    k = torch.zeros(B, dtype=torch.int64, device=T0.device)
    done = torch.zeros(B, dtype=torch.bool, device=T0.device)
    for _ in range(max_iters):
        active = ~done & (k < max_iters)
        err, n_valid, s = evaluate(T, ab)
        accept = (err < error) & torch.isfinite(err)
        T_base = _where(accept, T, T_best)
        s_base = tuple(_where(accept, x, y) for x, y in zip(s, s_best))
        err_base = torch.where(accept, err, error)
        lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e3)
        delta = solve(s_base, lam_next)
        ok = torch.isfinite(delta).all(-1)
        T_next = _where(ok, apply_delta(T_base, delta), T_base)
        small = torch.linalg.vector_norm(delta, dim=-1) < eps
        done_next = (accept & small) | (lam_next > 500.0) | ~ok
        n_next = torch.where(accept, n_valid, n_inlier)
        T = _where(active, T_next, T)
        T_best = _where(active, T_base, T_best)
        s_best = tuple(_where(active, x, y) for x, y in zip(s_base, s_best))
        if affine:
            ab_base = _where(accept, ab, ab_best)
            ab_next = _where(ok, ab_base + delta[:, 6:], ab_base)
            ab = _where(active, ab_next, ab)
            ab_best = _where(active, ab_base, ab_best)
        error = torch.where(active, err_base, error)
        lam = torch.where(active, lam_next, lam)
        k = k + active.long()
        done = torch.where(active, done_next, done)
        n_inlier = torch.where(active, n_next, n_inlier)
    return LMLoop(T, ab, T_best, ab_best, s_best, error, lam, k, done, n_inlier)


def _leaves(loop):
    return [*loop[:4], *loop.s_best, *loop[5:]]


@pytest.fixture(scope="module")
def cpu_scene():
    return _scene(torch.device("cpu"))


@pytest.mark.parametrize("affine", [False, True], ids=["n6", "n8"])
@pytest.mark.parametrize("mode", ["fc", "ic"])
def test_factored_step_reproduces_the_loop_bit_for_bit(cpu_scene, mode, affine):
    pts, pt = cpu_scene
    T0, ab0 = se3.identity((3,)), torch.zeros(3, 2)
    ab = ab0 if affine else None
    runs = []
    for loop_fn in (_lm_loop_before, photometric._lm_loop):
        steps = photometric._fused_steps(Scripted(_evaluator(pts, pt, mode, affine)), T0, ab)
        runs.append(loop_fn(T0, ab0, *steps, 10, 1e-4, 0.1, affine))
    want, got = runs
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # pair 0 accepts and stops on a small step, pair 1 is rejected until the
    # damping passes 500, pair 2 rejects its NaN cost and runs to max_iters
    assert bool(got.done[0]) and float(got.lam[0]) < 1e-3
    assert bool(got.done[1]) and float(got.lam[1]) > 500.0 and int(got.k[1]) == 7
    assert not bool(got.done[2]) and int(got.k[2]) == 10
    assert torch.isfinite(got.error).all()


def test_a_step_leaves_finished_pairs_unchanged(cpu_scene):
    pts, pt = cpu_scene
    T0, ab0 = se3.identity((3,)), torch.zeros(3, 2)
    first, evaluate, solve = photometric._fused_steps(_evaluator(pts, pt, "fc", False), T0, None)
    loop = photometric.lm_start(T0, ab0, first, solve, 1e-4, False)
    loop = loop._replace(done=torch.tensor([True, False, False]), k=torch.tensor([0, 10, 3]))
    new = photometric.lm_step(loop, evaluate(loop.T, loop.ab), solve, 10, 1e-4, False)
    for a, b in zip(_leaves(new), _leaves(loop)):
        assert torch.equal(a[:2], b[:2])
    assert int(new.k[2]) == 4


def _levels_counted(pts, pt, kind) -> tuple[int, int]:
    """(kernel, plain) LM levels counted over one FC level."""
    before = dict(LM_LEVELS)
    photometric.lm_level(se3.identity((3,), device=pts.uv.device), pts, pts.intensity,
                         pt.images[0], pt.grad_x[0], pt.grad_y[0], CAM, max_iters=3,
                         weight_kind=kind)
    return tuple(LM_LEVELS[name] - before[name] for name in ("lm_kernel_levels",
                                                               "lm_plain_levels"))


@pytest.mark.parametrize("kind", [WeightKind.HUBER, WeightKind.NONE, WeightKind.TUKEY])
def test_levels_are_counted_by_path(cpu_scene, kind):
    # the CPU runs every level's updates on the plain loop
    assert _levels_counted(*cpu_scene, kind) == (0, 1)


def test_kernel_refuses_cpu_tensors(cpu_scene):
    pts, pt = cpu_scene
    sums = _evaluator(pts, pt, "fc", False)(se3.identity((3,)))
    with pytest.raises(ValueError, match="runs on a card"):
        ops.lm_step_init(sums, se3.identity((3,)), torch.zeros(3, 2), 1e-4, False)


# ---- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: lm_step is a CUDA kernel")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [WeightKind.HUBER, WeightKind.NONE, WeightKind.TUKEY])
def test_levels_are_counted_by_path_on_card(kind, cuda_device):
    # Huber and unweighted levels update through lm_step, Tukey's through
    # the plain loop
    pts, pt = _scene(cuda_device)
    fused = kind != WeightKind.TUKEY
    assert _levels_counted(pts, pt, kind) == (int(fused), int(not fused))


MAX_ITERS, EPS = 10, 1e-4
LANES = ("accept", "reject", "k_max", "small", "lam_500", "nan_cost", "singular", "done")


def _step_case(B, affine, device, seed=7):
    """An LMLoop of B pairs and the candidate's sums: the first lanes take
    LANES' cases in turn (for B = 1: accept), the rest random accepts and
    rejects. Sums are those of SPD systems with b ~ 0.1 of H's scale."""
    g = torch.Generator().manual_seed(seed + B + 10 * affine)
    lay = lm_layout(affine)
    n = lay.n

    def sums_of(err, count):
        A = torch.randn(B, n, n, generator=g)
        H = A @ A.transpose(1, 2) * 50.0 + torch.eye(n) * 5.0
        out = torch.zeros(B, lay.width)
        out[:, lay.H] = H.reshape(B, -1)
        out[:, lay.b] = torch.randn(B, n, generator=g) * 5.0
        out[:, lay.cost] = err * count
        out[:, lay.abs_r] = torch.rand(B, generator=g) * 1e3
        out[:, lay.count] = count
        return out

    count = torch.randint(100, 2048, (B,), generator=g).float()
    error = torch.rand(B, generator=g) * 10.0 + 1.0
    err = torch.where(torch.rand(B, generator=g) < 0.5, error * 0.9, error * 1.1)
    sums, s_best = sums_of(err, count), sums_of(error, count + 3)
    T = se3.exp(torch.randn(B, 6, generator=g) * 0.05)
    T_best = se3.exp(torch.randn(B, 6, generator=g) * 0.05)
    loop = dict(T=T, ab=torch.randn(B, 2, generator=g), T_best=T_best,
                ab_best=torch.randn(B, 2, generator=g), error=error,
                lam=torch.rand(B, generator=g) * 1e-2 + 1e-5,
                k=torch.randint(0, MAX_ITERS, (B,), generator=g),
                done=torch.zeros(B, dtype=torch.bool), n_inlier=count.long() + 3)
    lanes = LANES if B > 1 else LANES[:1]
    for i, lane in enumerate(lanes):
        if lane == "accept":
            sums[i, lay.cost] = 0.5 * error[i] * count[i]
        elif lane == "reject":
            sums[i, lay.cost] = 2.0 * error[i] * count[i]
        elif lane == "k_max":
            loop["k"][i] = MAX_ITERS
        elif lane == "small":
            sums[i, lay.cost] = 0.5 * error[i] * count[i]
            sums[i, lay.b] *= 1e-8
        elif lane == "lam_500":
            sums[i, lay.cost] = 2.0 * error[i] * count[i]
            loop["lam"][i] = 200.0
        elif lane == "nan_cost":
            sums[i, lay.cost] = float("nan")
        elif lane == "singular":
            # H = -1e-8 I: every pivot is clamped at 1e-20, the step overflows
            for s in (sums, s_best):
                s[i, lay.H] = (-1e-8 * torch.eye(n)).reshape(-1)
                s[i, lay.b] = 1e19
        elif lane == "done":
            loop["done"][i] = True
    if not affine:
        loop["ab"] = loop["ab_best"] = torch.zeros(B, 2)
    to = lambda x: x.to(device)   # noqa: E731
    return (LMLoop(s_best=(to(s_best),), **{k: to(v) for k, v in loop.items()}),
            to(sums), lanes)


class Given:
    """Stands in for an `LMEvaluator` whose every result is `sums`."""

    def __init__(self, sums, affine):
        self.sums, self.affine, self.layout = sums, affine, lm_layout(affine)

    def __call__(self, T, ab=None):
        return self.sums


def _plain_step(loop, sums, affine):
    _, evaluate, solve = photometric._fused_steps(Given(sums, affine), loop.T,
                                                  loop.ab if affine else None)
    return photometric.lm_step(loop, evaluate(loop.T, loop.ab), solve, MAX_ITERS, EPS, affine)


def _same(a, b) -> bool:
    """Equal dtype and values, NaN where the other has NaN."""
    return a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_close(got, want, rtol=POSE_RTOL):
    """Within rtol of each entry's scale (|want|, at least 1); non-finite
    where the plain version is (an init step that is not finite is taken
    unchecked, as the plain version takes it)."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    close = (got == want) | ((got - want).abs() <= rtol * want.abs().clamp(min=1.0)) | nan
    assert bool(close.all()), float((got - want)[~nan].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True], ids=["n6", "n8"])
@pytest.mark.parametrize("B", [1, 95])
def test_lm_step_matches_the_plain_step_on_card(B, affine, cuda_device):
    loop, sums, lanes = _step_case(B, affine, cuda_device)
    before = tuple(t.clone() for t in _leaves(loop))
    want = _plain_step(LMLoop(*loop[:4], (loop.s_best[0].clone(),), *loop[5:]), sums, affine)
    launches = ops.lm_step.launches
    ops.lm_step(loop, sums, MAX_ITERS, EPS)
    torch.cuda.synchronize()
    assert ops.lm_step.launches == launches + 1
    for name in ("k", "done", "n_inlier", "error", "lam"):
        assert _same(getattr(loop, name), getattr(want, name)), name
    assert _same(loop.s_best[0], want.s_best[0])
    for name in ("T", "T_best", "ab", "ab_best"):
        _assert_close(getattr(loop, name), getattr(want, name))
    got = dict(zip(lanes, range(len(lanes))))
    if B > 1:
        assert bool(want.done[[got["small"], got["lam_500"], got["singular"]]].all())
        assert not bool(want.done[got["accept"]]) and int(want.k[got["reject"]]) > 0
        for i in (got["k_max"], got["done"]):        # not active: unchanged
            assert all(torch.equal(a[i], b[i]) for a, b in zip(_leaves(loop), before))


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True], ids=["n6", "n8"])
@pytest.mark.parametrize("B", [1, 95])
def test_lm_step_init_matches_lm_start_on_card(B, affine, cuda_device):
    _, sums, _ = _step_case(B, affine, cuda_device)
    g = torch.Generator().manual_seed(B)
    T0 = se3.exp(torch.randn(B, 6, generator=g) * 0.05).to(cuda_device)
    ab0 = torch.randn(B, 2, generator=g).to(cuda_device)
    got = ops.lm_step_init(sums, T0, ab0, 1e-4, affine)
    first, _, solve = photometric._fused_steps(Given(sums, affine), T0, ab0 if affine else None)
    want = photometric.lm_start(T0, ab0, first, solve, 1e-4, affine)
    torch.cuda.synchronize()
    for name in ("k", "done", "n_inlier", "error", "lam"):
        assert _same(getattr(got, name), getattr(want, name)), name
    assert _same(got.s_best[0], want.s_best[0]) and torch.equal(got.T_best, T0)
    _assert_close(got.T, want.T)
    _assert_close(got.ab, want.ab)


def _level(pts, pt, mode, affine, max_iters=MAX_ITERS):
    B = pts.uv.shape[0]
    T0 = se3.identity((B,), device=pts.uv.device)
    ab0 = torch.zeros(B, 2, device=pts.uv.device)
    if mode == "fc":
        return photometric.lm_level(T0, pts, pts.intensity, pt.images[0], pt.grad_x[0],
                                    pt.grad_y[0], CAM, max_iters=max_iters, affine=affine,
                                    ab0=ab0, keep_residuals=False)
    return photometric.lm_level_ic(T0, pts, pts.intensity, pts.gx0, pts.gy0, pt.images[0], CAM,
                                   max_iters=max_iters, affine=affine, ab0=ab0,
                                   keep_residuals=False)


def _plain_loop(evaluator, T0, ab0, max_iters, eps, init_lambda):
    """The fused path with the plain update on the card's tensors."""
    affine = evaluator.affine
    return photometric._lm_loop(T0, ab0, *photometric._fused_steps(
        evaluator, T0, ab0 if affine else None), max_iters, eps, init_lambda, affine)


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True], ids=["n6", "n8"])
@pytest.mark.parametrize("mode", ["fc", "ic"])
def test_level_on_the_kernel_matches_the_plain_loop_on_card(mode, affine, cuda_device,
                                                            monkeypatch):
    pts, pt = _scene(cuda_device, B=3, points=512)
    launches = ops.lm_step.launches
    got = _level(pts, pt, mode, affine)
    assert ops.lm_step.launches - launches == 1 + MAX_ITERS
    monkeypatch.setattr(photometric, "_kernel_loop", _plain_loop)
    want = _level(pts, pt, mode, affine)
    torch.cuda.synchronize()
    assert ops.lm_step.launches - launches == 1 + MAX_ITERS
    assert torch.equal(got.k, want.k) and torch.equal(got.done, want.done)
    assert torch.equal(got.n_inlier, want.n_inlier)
    assert float((got.T - want.T).abs().max()) <= 1e-5
    assert float((got.ab - want.ab).abs().max()) <= 1e-5 * max(1.0, float(want.ab.abs().max()))


@pytest.mark.cuda
def test_captured_level_launches_two_lm_kernels_per_iteration_on_card(cuda_device):
    from uwslam_tpu_torch.ops.graph import COUNTED, CapturedStep

    pts, pt = _scene(cuda_device, B=1, points=512)
    eager = _level(pts, pt, "fc", False).T

    def level(image):
        return _level(pts, pt._replace(images=[image, *pt.images[1:]]), "fc", False).T

    step = CapturedStep(level, (pt.images[0],))
    got = step(pt.images[0]).clone()
    torch.cuda.synchronize()
    counts = dict(zip((w.__name__ for w in COUNTED), step.kernel_launches))
    # the first evaluation and the init step, then one evaluation and one
    # step per iteration
    assert counts["lm_evaluate"] == counts["lm_step"] == 1 + MAX_ITERS
    assert torch.equal(got, eager)
