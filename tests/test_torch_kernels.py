"""The port's kernel wrappers: CPU dispatch, argument checks, and (marked
`cuda`, skipped without a card) each CUDA kernel against its plain PyTorch
version on the card, launch counts included.

This file imports neither JAX nor the JAX package, so on a CUDA machine
without JAX it runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`.
K1, K2 and K3 and their plain versions evaluate the same f32 operations in
the same order without FMA contraction, so the card's comparison is exact
(atol 0), planar and texels alike. `lm_evaluate` sums in another order than
its plain version: valid counts equal, sums within 2e-5 of the pair's
largest |H| entry (b: of sqrt(2 max|H| cost)), two launches bit-equal.
The pipelined loop's CUDA graph replays the same launches on the same
inputs, so it equals the eager megastep bit for bit; the card's pipelined
run is held to the CPU's at 1e-3 (other sums inside `lm_evaluate`).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import ops  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402
from uwslam_tpu_torch.tracking.robust import WeightKind  # noqa: E402

# Power-of-two focal lengths: depth-1 points project exactly onto the edges.
CAM = PinholeCamera(fx=64.0, fy=64.0, cx=31.5, cy=23.5, width=64, height=48)


def _images(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 255.0


def _uv(n, seed):
    g = torch.Generator().manual_seed(seed)
    uv = torch.rand(n, 2, generator=g) * torch.tensor([67.0, 51.0]) - 2.0
    edges = [[63, 3.5], [63, 47], [5.25, 47], [0, 0], [63.001, 2], [float("nan"), 2]]
    uv[: len(edges)] = torch.tensor(edges)
    return uv


def _p3d(n, seed):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) * torch.tensor([1.2, 0.8, 2.2]) + torch.tensor(
        [-0.6, -0.4, 0.8])
    x, y = (63 - CAM.cx) / CAM.fx, (47 - CAM.cy) / CAM.fy
    p[:8] = torch.stack([torch.full((8,), x), torch.linspace(-0.3, 0.3, 8), torch.ones(8)], -1)
    p[8:16] = torch.stack([torch.linspace(-0.4, 0.4, 8), torch.full((8,), y), torch.ones(8)], -1)
    p[16:20] = torch.tensor([[0, 0, -1.0], [0, 0, 5e-4], [0, 0, 0.0], [0.1, 0.1, 1e-3]])
    return p


def _cases():
    imgs = _images((2, 48, 64), 1)
    stack = _images((2, 3, 48, 64), 2)
    uv = torch.stack([_uv(300, 3), _uv(300, 4)])
    p3d = torch.stack([_p3d(300, 5), _p3d(300, 6)])
    T = se3.exp(torch.tensor([[0.0] * 6, [0.03, -0.02, 0.01, 0.02, -0.01, 0.015]]))
    texels = ops.pack_texels(stack[:, 0], stack[:, 1], stack[:, 2])
    g = torch.Generator().manual_seed(7)
    ref_int = torch.rand(2, 300, generator=g) * 255.0
    valid = torch.rand(2, 300, generator=g) > 0.1
    J_ref = torch.randn(2, 300, 6, generator=g) * valid[..., None]
    sigma = torch.tensor([0.5, 30.0])
    lm = (ref_int, valid, sigma)
    return {
        "scharr": (ops.scharr_gradients_batched, ops.scharr_plain, (imgs,), {}),
        "warp_sample": (ops.warp_and_sample, ops.warp_and_sample_plain,
                        (stack[:, :1].contiguous(), p3d, T), {"cam": CAM}),
        "warp_sample_c3": (ops.warp_and_sample, ops.warp_and_sample_plain,
                           (stack, p3d, T), {"cam": CAM}),
        "bilinear_sample": (ops.cuda_bilinear_sample, ops.bilinear_sample_plain,
                            (stack, uv), {}),
        "warp_sample_texels": (ops.warp_and_sample, ops.warp_and_sample_plain,
                               (texels, p3d, T), {"cam": CAM, "texels": True}),
        "bilinear_sample_texels": (
            ops.cuda_bilinear_sample,
            lambda t, q, texels: ops.bilinear_sample_texels_plain(t, q),
            (texels, uv), {"texels": True}),
        "lm_evaluate_ic": (ops.lm_evaluate, ops.lm_evaluate_plain,
                           (stack[:, 0].contiguous(), p3d, T, *lm),
                           {"cam": CAM, "kind": WeightKind.HUBER, "J_ref": J_ref}),
        "lm_evaluate_fc": (ops.lm_evaluate, ops.lm_evaluate_plain, (texels, p3d, T, *lm),
                           {"cam": CAM, "kind": WeightKind.NONE}),
    }


# Kernels that equal their plain versions bit for bit, and the fused sums.
CASES = ["scharr", "warp_sample", "warp_sample_c3", "bilinear_sample",
         "warp_sample_texels", "bilinear_sample_texels"]
LM_CASES = ["lm_evaluate_ic", "lm_evaluate_fc"]


@pytest.mark.parametrize("case", CASES + LM_CASES)
def test_wrapper_runs_plain_version_on_cpu_tensors(case):
    wrapper, plain, args, kw = _cases()[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert wrapper.launches == before   # nothing was launched


@pytest.mark.parametrize("case", CASES + LM_CASES)
def test_wrapper_refuses_other_devices(case):
    wrapper, _, args, kw = _cases()[case]
    with pytest.raises(ValueError):
        wrapper(*(a.to("meta") for a in args), **kw)


def test_plain_versions_mark_edges_and_cameras_as_the_kernels_do():
    _, ok = ops.warp_and_sample_plain(_images((1, 1, 48, 64), 7), _p3d(64, 8)[None],
                                      torch.eye(4)[None], CAM)
    assert ok[0, :16].all() and not ok[0, 16:20].any()
    _, ok = ops.bilinear_sample_plain(_images((1, 1, 48, 64), 9), _uv(8, 10)[None])
    assert ok[0, :4].all() and not ok[0, 4:6].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version_on_card(case, cuda_device):
    wrapper, plain, args, kw = _cases()[case]
    args = tuple(a.to(cuda_device) for a in args)
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, b in zip(got, want):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LM_CASES)
def test_lm_evaluate_matches_plain_version_on_card(case, cuda_device):
    wrapper, plain, args, kw = _cases()[case]
    args = tuple(a.to(cuda_device) for a in args)
    kw = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    before = wrapper.launches
    got, again, want = wrapper(*args, **kw).clone(), wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[:, 44], want[:, 44]) and float(want[:, 44].min()) > 0
    H = got[:, :36].view(-1, 6, 6)
    assert torch.equal(H, H.transpose(1, 2)) and not got[:, 45:].any()
    h_scale = want[:, :36].abs().amax(-1, keepdim=True)
    b_scale = torch.sqrt(2.0 * h_scale * want[:, 42:43])
    for sl, scale in ((slice(0, 36), h_scale), (slice(36, 42), b_scale),
                      (slice(42, 44), want[:, 42:44].abs())):
        assert bool(((got[:, sl] - want[:, sl]).abs() <= 2e-5 * scale).all())


@pytest.mark.cuda
def test_lm_evaluator_rejects_bad_arguments_on_card(cuda_device):
    _, _, (target, p3d, T, ref_int, valid, sigma), kw = _cases()["lm_evaluate_ic"]
    d = cuda_device
    good = dict(target=target.to(d), p3d=p3d.to(d), ref_intensity=ref_int.to(d),
                pts_valid=valid.to(d), sigma=sigma.to(d), cam=CAM, kind=WeightKind.HUBER,
                J_ref=kw["J_ref"].to(d))
    evaluator = ops.LMEvaluator(**good)
    with pytest.raises(ValueError):
        evaluator(T.to(d)[:1])                                      # pose shape
    with pytest.raises(ValueError):
        evaluator(T)                                                # pose device
    for name, bad in (("pts_valid", valid.to(d).float()), ("sigma", sigma.to(d)[:1]),
                      ("J_ref", kw["J_ref"].to(d)[:, :, :5]), ("p3d", p3d)):
        with pytest.raises(ValueError):
            ops.LMEvaluator(**{**good, name: bad})
    with pytest.raises(ValueError):
        ops.LMEvaluator(**{**good, "kind": WeightKind.TUKEY})


@pytest.mark.cuda
def test_kernels_reject_bad_arguments_on_card(cuda_device):
    wrapper, _, (stack, p3d, T), kw = _cases()["warp_sample_c3"]
    stack, p3d, T = stack.to(cuda_device), p3d.to(cuda_device), T.to(cuda_device)
    with pytest.raises(ValueError):
        wrapper(stack, p3d.transpose(1, 2).contiguous(), T, **kw)   # shape
    with pytest.raises(ValueError):
        wrapper(stack, p3d.double(), T, **kw)                       # dtype
    with pytest.raises(ValueError):
        wrapper(stack.transpose(2, 3), p3d, T, **kw)                # contiguity
    with pytest.raises(ValueError):
        wrapper(stack, p3d.cpu(), T, **kw)                          # device
    with pytest.raises(ValueError):
        ops.scharr_gradients_batched(stack)                         # rank


@pytest.mark.cuda
def test_kernels_at_main_path_shapes_on_card(cuda_device):
    """K1 on a 96 x 480 x 640 batch; K2 and K3 with 95 pairs of 2048 points."""
    dev = cuda_device
    imgs = _images((96, 480, 640), 11).to(dev)
    for a, b in zip(ops.scharr_gradients_batched(imgs), ops.scharr_plain(imgs)):
        assert torch.equal(a, b)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    g = torch.Generator().manual_seed(12)
    uv = torch.rand(95, 2048, 2, generator=g) * torch.tensor([640.0, 480.0]) - 0.5
    p3d = cam.unproject(uv, torch.full((95, 2048), 2.0)).to(dev)
    T = se3.exp(0.01 * torch.randn(95, 6, generator=g)).to(dev)
    tgt = imgs[1:, None]
    for a, b in zip(ops.warp_and_sample(tgt, p3d, T, cam),
                    ops.warp_and_sample_plain(tgt, p3d, T, cam)):
        assert torch.equal(a, b)
    stack = torch.stack([imgs[:-1, ::2, ::2]] * 3, dim=1).contiguous()
    uv = (uv * 0.5).to(dev)
    for a, b in zip(ops.cuda_bilinear_sample(stack, uv),
                    ops.bilinear_sample_plain(stack, uv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pairs,points,want", [
    (1, 2048, (256, 8)),      # the live frame: one pair over 8 SMs
    (95, 2048, (256, 2)),     # the offline chunk: ~2 blocks per SM in all
    (32, 2048, (256, 8)), (40, 2048, (256, 4)), (500, 2048, (256, 1)),
    (1, 300, (256, 2)), (1, 100, (256, 1)), (1, 300000, (256, 8)),
])
def test_lm_evaluate_launch_shape(pairs, points, want):
    from uwslam_tpu_torch.ops.cuda_track import launch_shape

    assert launch_shape(pairs, points, sm_count=132) == want


def test_build_targets_sm90a_from_the_package_sources():
    from uwslam_tpu_torch.ops import _lib

    path = _lib.library_path()
    assert path.parent == _lib.BUILD_DIR and path.suffix == ".so"
    assert all((_lib.CSRC / s).is_file() for s in _lib.SOURCES + _lib.HEADERS)
    assert "arch=compute_90a,code=sm_90a" in _lib.NVCC_FLAGS


# ---- the pipelined live loop's CUDA graph (160 x 120, 512 points, 4 levels)

LIVE_CAM = PinholeCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
LIVE_TRACKER = dict(pyramid_levels=4, track_levels=(2, 1, 0), num_points=512, point_block=4,
                    mono_depth=2.0)


def _live_frames(n):
    """Views of the textured plane along a sinusoidal motion with reversals."""
    from uwslam_tpu_torch.utils.synthetic import render_plane_view

    i = torch.arange(n, dtype=torch.float32)
    s, c = torch.sin(0.35 * i), torch.cos(0.22 * i)
    xi = torch.stack([0.28 * s, 0.10 * c, 0.05 * s, 0.010 * c, -0.012 * s, 0.015 * c], -1)
    return render_plane_view(LIVE_CAM, se3.exp(xi), 2.0)


def _live_system(device):
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.config import SlamConfig, TrackerConfig
    from uwslam_tpu_torch.system import SlamSystem

    return SlamSystem(Calibration(raw=LIVE_CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**LIVE_TRACKER)), device=device)


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_megastep_on_card(cuda_device):
    from uwslam_tpu_torch.ops.graph import WARMUP_CALLS, tree_leaves

    frames = _live_frames(4).to(cuda_device)
    system = _live_system(cuda_device)
    system.process_frame(frames[0])
    eager = system._build_step_plain()
    for i, f in enumerate(frames[1:]):
        prev_pyr, prev_pts, _ = system._prev
        want = eager(f, prev_pyr, prev_pts, system._velocity, system._T_wc,
                     system.keyframes.latest.T_wc, system._eye)
        before = ops.scharr_gradients_batched.launches
        system.process_frame_async(f)
        # A replay runs the captured launches (4 pyramid levels) and counts
        # them; the first frame also ran the eager warm-up calls, while the
        # capture itself, which runs nothing, counts nothing.
        calls = 1 + (WARMUP_CALLS if i == 0 else 0)
        assert ops.scharr_gradients_batched.launches - before == 4 * calls
        got = (*system._prev[:2], system._velocity, system._T_wc)
        for a, b in zip(tree_leaves(got), tree_leaves(want[:4])):
            assert torch.equal(a, b)
    system.flush()
    assert system.graph_replays == 3 and len(system.trajectory) == 4


@pytest.mark.cuda
def test_pipelined_loop_on_card_matches_cpu(cuda_device):
    frames = _live_frames(24)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        system = _live_system(device)
        for i, f in enumerate(frames.to(device)):
            system.process_frame_async(f, timestamp=float(i))
        system.flush()
        runs.append(system)
    card, cpu = runs
    assert card.graph_replays == 23 and cpu.graph_replays == 0
    assert sum(s.is_keyframe for s in card.trajectory) >= 2
    for a, b in zip(card.trajectory, cpu.trajectory):
        assert (a.status, a.is_keyframe, a.ref_kf_id) == (b.status, b.is_keyframe, b.ref_kf_id)
        assert torch.allclose(torch.from_numpy(a.T_wc), torch.from_numpy(b.T_wc), atol=1e-3)
