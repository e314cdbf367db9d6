"""The port's kernel wrappers: CPU dispatch, argument checks, and (marked
`cuda`, skipped without a card) each CUDA kernel against its plain PyTorch
version on the card, launch counts included.

This file imports neither JAX nor the JAX package, so on a CUDA machine
without JAX it runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`.
The pyramid kernel (K1 redesigned: every level in one launch; K1 alone at
one level), K2 and K3 and their plain versions evaluate the same f32
operations in the same order without FMA contraction, so the card's
comparison is exact (atol 0), planar and texels alike. `lm_evaluate` sums in another order than
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
    ab = torch.tensor([[0.05, -3.0], [-0.02, 7.5]])
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
        "lm_evaluate_ic_affine": (ops.lm_evaluate, ops.lm_evaluate_plain,
                                  (stack[:, 0].contiguous(), p3d, T, *lm),
                                  {"cam": CAM, "kind": WeightKind.NONE, "J_ref": J_ref, "ab": ab}),
        "lm_evaluate_fc_affine": (ops.lm_evaluate, ops.lm_evaluate_plain,
                                  (texels, p3d, T, *lm),
                                  {"cam": CAM, "kind": WeightKind.HUBER, "ab": ab}),
    }


# Kernels that equal their plain versions bit for bit, and the fused sums.
CASES = ["scharr", "warp_sample", "warp_sample_c3", "bilinear_sample",
         "warp_sample_texels", "bilinear_sample_texels"]
LM_CASES = ["lm_evaluate_ic", "lm_evaluate_fc"]
AFFINE_LM_CASES = ["lm_evaluate_ic_affine", "lm_evaluate_fc_affine"]


@pytest.mark.parametrize("case", CASES + LM_CASES + AFFINE_LM_CASES)
def test_wrapper_runs_plain_version_on_cpu_tensors(case):
    wrapper, plain, args, kw = _cases()[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert wrapper.launches == before   # nothing was launched


@pytest.mark.parametrize("case", CASES + LM_CASES + AFFINE_LM_CASES)
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


def test_affine_evaluator_takes_the_brightness_exactly_when_affine():
    _, _, (target, p3d, T, ref_int, valid, sigma), kw = _cases()["lm_evaluate_ic_affine"]
    args = dict(target=target, p3d=p3d, ref_intensity=ref_int, pts_valid=valid, sigma=sigma,
                cam=CAM, kind=WeightKind.HUBER, J_ref=kw["J_ref"])
    affine = ops.LMEvaluator(**args, affine=True)
    assert affine(T, kw["ab"]).shape == (2, 80) and affine.layout.n == 8
    with pytest.raises(ValueError):
        affine(T)
    with pytest.raises(ValueError):
        ops.LMEvaluator(**args)(T, kw["ab"])


def _affine_lm_case(B, fc, device, N=2048, H=60, W=80):
    """B pairs of random targets (texels in FC), points in front of and
    behind the camera, 10% invalid, random poses near identity, Huber scale
    and a non-zero brightness (a, b), all from one seed."""
    g = torch.Generator().manual_seed(11 + B)
    cam = PinholeCamera(fx=70.0, fy=70.0, cx=39.5, cy=29.5, width=W, height=H)
    imgs = torch.rand(B, 3, H, W, generator=g) * 255.0
    p3d = torch.rand(B, N, 3, generator=g) * torch.tensor([1.6, 1.2, 2.0]) + torch.tensor(
        [-0.8, -0.6, 0.9])
    p3d[:, :4, 2] = torch.tensor([-1.0, 0.0, 5e-4, 1e-3])
    T = se3.exp(torch.randn(B, 6, generator=g) * 0.02)
    ref_int = torch.rand(B, N, generator=g) * 255.0
    valid = torch.rand(B, N, generator=g) > 0.1
    sigma = torch.rand(B, generator=g) * 20.0
    ab = torch.stack([torch.randn(B, generator=g) * 0.05, torch.randn(B, generator=g) * 5.0], -1)
    if fc:
        target, J_ref = ops.pack_texels(imgs[:, 0], imgs[:, 1], imgs[:, 2]), None
    else:
        target, J_ref = imgs[:, 0].contiguous(), torch.randn(B, N, 6, generator=g) * valid[..., None]
    to = lambda x: None if x is None else x.to(device)   # noqa: E731
    return (to(target), to(p3d), to(T), to(ref_int), to(valid), to(sigma), cam,
            WeightKind.HUBER, to(J_ref), to(ab))


@pytest.mark.cuda
@pytest.mark.parametrize("fc", [False, True], ids=["ic", "fc"])
@pytest.mark.parametrize("B", [1, 95])
def test_lm_evaluate_affine_matches_plain_version_on_card(B, fc, cuda_device):
    target, p3d, T, ref_int, valid, sigma, cam, kind, J_ref, ab = _affine_lm_case(
        B, fc, cuda_device)
    lay = ops.cuda_track.LM_AFFINE
    evaluator = ops.LMEvaluator(target, p3d, ref_int, valid, sigma, cam, kind, J_ref,
                                affine=True)
    before = ops.lm_evaluate.launches
    got, again = evaluator(T, ab).clone(), evaluator(T, ab)
    want = ops.lm_evaluate_plain(target, p3d, T, ref_int, valid, sigma, cam, kind, J_ref, ab)
    torch.cuda.synchronize()
    assert ops.lm_evaluate.launches == before + 2 and got.shape == (B, lay.width)
    assert torch.equal(got, again)
    assert torch.equal(got[:, lay.count], want[:, lay.count])
    assert float(want[:, lay.count].min()) > 0
    H = got[:, lay.H].view(-1, 8, 8)
    assert torch.equal(H, H.transpose(1, 2)) and not got[:, lay.count + 1:].any()
    h_scale = want[:, lay.H].abs().amax(-1, keepdim=True)
    b_scale = torch.sqrt(2.0 * h_scale * want[:, lay.cost, None])
    tail = slice(lay.cost, lay.abs_r + 1)
    for sl, scale in ((lay.H, h_scale), (lay.b, b_scale), (tail, want[:, tail].abs())):
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


# The pyramid kernel: ragged tiles, the paths' shapes, K1 alone.
PYRAMID_SHAPES = [
    (2, 48, 80, 5),       # ragged tiles in both axes
    (1, 464, 624, 5),     # the rectified ROI, ragged
    (96, 480, 640, 5),    # the offline chunk (64 x 64 tiles)
    (1, 480, 640, 3),     # the live frame
    (1, 480, 736, 5),     # the rectified EUROC frame
    (1, 480, 640, 5),     # track_sequence and entry()
    (3, 37, 53, 1),       # one level of an odd frame
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,levels", PYRAMID_SHAPES)
def test_pyramid_kernel_matches_plain_version_on_card(B, H, W, levels, cuda_device):
    imgs = _images((B, H, W), H + W + levels).to(cuda_device)
    before = ops.cuda_build_pyramid.launches
    got = ops.cuda_build_pyramid(imgs, levels)
    want = ops.pyramid_plain(imgs, levels)
    torch.cuda.synchronize()
    assert ops.cuda_build_pyramid.launches == before + 1
    assert got[0][0] is imgs                        # level 0 is the input, not a copy
    for field_got, field_want in zip(got, want):
        assert len(field_got) == levels
        for a, b in zip(field_got, field_want):
            assert a.shape == b.shape and a.is_contiguous() and a.device == imgs.device
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_scharr_is_the_pyramid_kernel_at_one_level_on_card(cuda_device):
    imgs = _images((3, 37, 53), 13).to(cuda_device)
    before = (ops.scharr_gradients_batched.launches, ops.cuda_build_pyramid.launches)
    got = ops.scharr_gradients_batched(imgs)
    _, gx, gy, gm = ops.cuda_build_pyramid(imgs, 1)
    torch.cuda.synchronize()
    assert (ops.scharr_gradients_batched.launches, ops.cuda_build_pyramid.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b, c in zip(got, (gx[0], gy[0], gm[0]), ops.scharr_plain(imgs)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_pyramid_kernel_rejects_bad_inputs_on_card(cuda_device):
    imgs = _images((2, 48, 80), 14).to(cuda_device)
    before = ops.cuda_build_pyramid.launches
    for bad, levels in ((imgs.transpose(1, 2), 1),          # not contiguous
                        (imgs[:, :, ::2], 1),                # not contiguous
                        (imgs.double(), 3),                  # not f32
                        (imgs.half(), 1),                    # not f32
                        (imgs[:, :40].contiguous(), 5),      # 40 rows: not divisible by 16
                        (imgs, 6), (imgs, 0),                # levels out of range
                        (imgs[0], 3)):                       # rank
        with pytest.raises(ValueError):
            ops.cuda_build_pyramid(bad, levels)
    assert ops.cuda_build_pyramid.launches == before


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


def test_build_falls_back_to_a_user_cache_when_the_package_is_read_only(monkeypatch, tmp_path):
    """A writable install builds inside the package; a read-only one under
    $XDG_CACHE_HOME, else ~/.cache. Nothing is compiled here."""
    from uwslam_tpu_torch.ops import _lib

    monkeypatch.setattr(_lib, "_writable", lambda path: True)
    assert _lib.build_dir() == _lib.BUILD_DIR
    monkeypatch.setattr(_lib, "_writable", lambda path: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _lib.build_dir() == tmp_path / "xdg" / "uwslam_tpu_torch"
    assert _lib.library_path().parent == tmp_path / "xdg" / "uwslam_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _lib.build_dir() == tmp_path / "home" / ".cache" / "uwslam_tpu_torch"


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
        before = ops.cuda_build_pyramid.launches
        system.process_frame_async(f)
        # A replay runs the captured launches (one pyramid launch builds all
        # 4 levels) and counts them; the first frame also ran the eager
        # warm-up calls, while the capture itself, which runs nothing,
        # counts nothing.
        calls = 1 + (WARMUP_CALLS if i == 0 else 0)
        assert ops.cuda_build_pyramid.launches - before == calls
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


# ------------------- K3 at the depth-refinement shape, and the new paths

def _refine_case(device, height=480, width=640, n=2048, seed=21):
    """The frame's texels (1, H, W, 4) and 2048 projected points with some on
    the last row, the last column, the corner and outside."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((3, 1, height, width), generator=g) * 255.0
    texels = ops.pack_texels(img[0], img[1], img[2]).to(device)
    uv = torch.rand((1, n, 2), generator=g) * torch.tensor([width + 3.0, height + 3.0]) - 2.0
    edges = torch.tensor([[width - 1.0, 3.5], [width - 1.0, height - 1.0], [5.25, height - 1.0],
                          [0.0, 0.0], [width - 0.999, 2.0], [float("nan"), 2.0],
                          [width - 1.5, height - 1.5]])
    uv[0, : len(edges)] = edges
    return texels, uv.to(device)


def test_refine_shape_wrapper_runs_plain_version_on_cpu():
    texels, uv = _refine_case("cpu", 48, 64, 256)
    before = ops.cuda_bilinear_sample.launches
    got = ops.cuda_bilinear_sample(texels, uv, texels=True)
    want = ops.bilinear_sample_texels_plain(texels, uv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (1, 3, 256) and ops.cuda_bilinear_sample.launches == before
    assert got[1][0, :4].all() and not got[1][0, 4:6].any()


def test_refine_inverse_depth_samples_five_times():
    """4 Gauss-Newton steps and the final evaluation: 5 K3 calls per
    refinement (launches on a card)."""
    from uwslam_tpu_torch.tracking import depth_refine
    from uwslam_tpu_torch.tracking.points import TrackPoints

    calls = []
    real = depth_refine.cuda_bilinear_sample
    depth_refine.cuda_bilinear_sample = lambda *a, **k: (calls.append(k), real(*a, **k))[1]
    try:
        img = _images((1, 48, 64), 3)
        uv = _uv(64, 4)[None].clamp(2, 40)
        pts = TrackPoints(uv=uv, p3d=CAM.unproject(uv, torch.full((1, 64), 2.0)),
                          intensity=torch.full((1, 64), 100.0),
                          valid=torch.ones(1, 64, dtype=torch.bool))
        T = se3.exp(torch.tensor([0.02, 0.0, 0.0, 0.0, 0.0, 0.0]))
        out = depth_refine.refine_inverse_depth(pts, T, img, img * 0.1, img * 0.2, CAM)
    finally:
        depth_refine.cuda_bilinear_sample = real
    assert len(calls) == 5 and all(k == {"texels": True} for k in calls)
    assert out.inv_depth.shape == (1, 64) and torch.isfinite(out.inv_depth).all()


@pytest.mark.cuda
def test_k3_at_the_depth_refinement_shape_on_card(cuda_device):
    """C = 3 texels of one 480 x 640 frame, 2048 points: bit for bit."""
    texels, uv = _refine_case(cuda_device)
    before = ops.cuda_bilinear_sample.launches
    got = ops.cuda_bilinear_sample(texels, uv, texels=True)
    want = ops.bilinear_sample_texels_plain(texels, uv)
    torch.cuda.synchronize()
    assert ops.cuda_bilinear_sample.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1][0, :4].all() and got[1][0, 6] and not got[1][0, 4:6].any()


@pytest.mark.cuda
def test_bundle_adjust_repeats_bit_for_bit_on_card(cuda_device):
    from uwslam_tpu_torch import bench
    from uwslam_tpu_torch.ba import bundle_adjust

    problem, _ = bench.ba_bench_problem(cuda_device)
    a = bundle_adjust(problem, bench.CAM, max_iters=8)
    b = bundle_adjust(problem, bench.CAM, max_iters=8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a.cost) < float(a.initial_cost)


@pytest.mark.cuda
def test_fused_linalg_matches_torch_linalg_on_card(cuda_device):
    from uwslam_tpu_torch.utils import linalg

    g = torch.Generator().manual_seed(5)
    B = torch.randn((64, 9, 8), generator=g).to(cuda_device)
    A = B @ B.transpose(-1, -2)                                   # rank 8
    v, ref = linalg.smallest_eigvec_subspace(A), linalg.smallest_eigvec_spd(A)
    assert float(torch.minimum((v - ref).abs().amax(-1), (v + ref).abs().amax(-1)).max()) < 1e-3
    F = torch.randn((64, 3, 3), generator=g).to(cuda_device)
    U, s, Vt = linalg.svd3_jacobi(F)
    assert float((U * s[..., None, :] @ Vt - F).abs().max()) < 2e-5
    # The card against the CPU run of the same forms: the same operations,
    # so a few ulp apart (products and sums may fuse differently).
    v_cpu = linalg.smallest_eigvec_subspace(A.cpu())
    assert float((v.cpu() - v_cpu).abs().max()) < 2e-4
    U_cpu, s_cpu, Vt_cpu = linalg.svd3_jacobi(F.cpu())
    assert float((s.cpu() - s_cpu).abs().max()) < 5e-6
    assert float((Vt.cpu() - Vt_cpu).abs().max()) < 2e-5


def _boot_system(device):
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.config import SlamConfig, TrackerConfig
    from uwslam_tpu_torch.system import SlamSystem

    tracker = dict(LIVE_TRACKER, mono_depth=2.5, depth_bootstrap=True, bootstrap_anchor_frames=3)
    return SlamSystem(Calibration(raw=LIVE_CAM, out_width=160, out_height=120),
                      SlamConfig(tracker=TrackerConfig(**tracker), use_features=True),
                      device=device)


def _scene_frames(n):
    from uwslam_tpu_torch.utils.synthetic import render_scene_view

    return torch.stack([
        render_scene_view(LIVE_CAM, se3.exp(torch.tensor(
            [0.04 * i, 0.015 * i, 0.01 * i, 0.003 * i, 0.01 * i, 0.004 * i])))
        for i in range(n)
    ])


@pytest.mark.cuda
def test_boot_graph_replay_equals_the_eager_megastep_on_card(cuda_device):
    from uwslam_tpu_torch.ops.graph import tree_leaves

    frames = _scene_frames(10).to(cuda_device)
    system = _boot_system(cuda_device)
    replayed = 0
    for i, f in enumerate(frames):
        if system._can_pipeline(None):
            prev_pyr, prev_pts, _ = system._prev
            kp, desc = system._prev_feats
            want = system._build_step_boot()(
                f, prev_pyr, prev_pts, kp.uv, desc, kp.valid, system._depth_prior,
                system._velocity, system._T_wc, system.keyframes.latest.T_wc, system._eye,
                system._ransac_uniforms(desc.shape[0], system._frame_id),
            )
            system.process_frame_async(f, timestamp=float(i))
            got = (*system._prev[:2], system._velocity, system._T_wc, system._depth_prior,
                   system._kp_depth)
            ref = (want[0], want[7], want[3], want[4], want[5], want[6])
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))
            replayed += 1
        else:
            system.process_frame_async(f, timestamp=float(i))
    system.flush()
    assert replayed >= 4 and system.graph_replays == replayed
    assert all(s.status == "ok" for s in system.trajectory)


@pytest.mark.cuda
def test_window_ba_on_card_matches_cpu_and_does_not_block(cuda_device):
    """The captured window solve against the CPU's, retired inside the
    dispatch on both (when a result arrives depends on the card's pace, and
    the frame at which its correction lands with it); then the asynchronous
    loop: solves retired, the trajectory as good."""
    from uwslam_tpu_torch.camera import Calibration
    from uwslam_tpu_torch.config import BAConfig, SlamConfig, TrackerConfig
    from uwslam_tpu_torch.io.trajectory import ate_rmse
    from uwslam_tpu_torch.system import SlamSystem

    frames = _live_frames(40)
    i = torch.arange(40, dtype=torch.float32)
    s, c = torch.sin(0.35 * i), torch.cos(0.22 * i)
    xi = torch.stack([0.28 * s, 0.10 * c, 0.05 * s, 0.010 * c, -0.012 * s, 0.015 * c], -1)
    gt = se3.inverse(se3.exp(xi)).numpy()

    def run(device, asynchronous):
        system = SlamSystem(
            Calibration(raw=LIVE_CAM, out_width=160, out_height=120),
            SlamConfig(tracker=TrackerConfig(**LIVE_TRACKER), use_ba=True,
                       ba=BAConfig(max_iterations=6, asynchronous=asynchronous)), device=device)
        for k, f in enumerate(frames.to(device)):
            system.process_frame_async(f, timestamp=float(k))
        system.flush()
        return system

    card, cpu = run(cuda_device, False), run(torch.device("cpu"), False)
    assert card.ba_stats["runs"] == cpu.ba_stats["runs"] >= 1
    assert any(key[0] == "ba" for key in card._steps)          # one captured solve
    a, b = card.export_trajectory()[1], cpu.export_trajectory()[1]
    assert torch.allclose(torch.from_numpy(a), torch.from_numpy(b), atol=1e-3)
    loose = run(cuda_device, True)
    assert loose.ba_stats["runs"] == card.ba_stats["runs"] and loose._ba_inflight is None
    ate = [ate_rmse(x.export_trajectory()[1][:, :3, 3], gt[:, :3, 3]) for x in (loose, card)]
    assert ate[0] < 1.5 * ate[1] + 1e-3


# ---- photometric window BA: K3 at its shapes, the solve as a CUDA graph

@pytest.mark.cuda
def test_k3_at_the_photometric_ba_shape_on_card(cuda_device):
    """10 observers' texels at level 1 of 480 x 640, each sampled at the
    10 x 2048 projections of the window's points (with edge and outside
    points), and the reference intensity with C = 1: bit-equal to plain."""
    g = torch.Generator().manual_seed(5)
    planes = (torch.rand((10, 3, 240, 320), generator=g) * 255.0).to(cuda_device)
    texels = ops.pack_texels(planes[:, 0], planes[:, 1], planes[:, 2])
    uv = torch.rand((10, 20480, 2), generator=g) * torch.tensor([330.0, 250.0]) - 5.0
    uv[:, :4] = torch.tensor([[319.0, 5.5], [3.25, 239.0], [319.0, 239.0], [0.0, 0.0]])
    uv = uv.to(cuda_device)
    before = ops.cuda_bilinear_sample.launches
    got = ops.cuda_bilinear_sample(texels, uv, texels=True)
    one = ops.cuda_bilinear_sample(planes[:, :1].contiguous(), uv[:, :2048].contiguous())
    torch.cuda.synchronize()
    assert ops.cuda_bilinear_sample.launches == before + 2
    want = ops.bilinear_sample_texels_plain(texels, uv)
    want_one = ops.bilinear_sample_plain(planes[:, :1].contiguous(), uv[:, :2048].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(one, want_one))
    assert got[1][:, :4].all() and 0.2 < float(got[1].float().mean()) < 1.0


def _photo_window(device, keyframes=4, points=256, level=1):
    """A photometric window on the two-depth scene at LIVE_CAM: keyframe
    pyramids, top-K points at their exact depths, poses perturbed (numpy
    seed 0), inverse depths with 5% noise."""
    import numpy as np

    from uwslam_tpu_torch.ba.photometric import photo_ba_problem_from_keyframes
    from uwslam_tpu_torch.image.pyramid import build_pyramid
    from uwslam_tpu_torch.tracking.points import topk_gradient_points
    from uwslam_tpu_torch.utils.synthetic import render_two_plane_view, two_plane_depth

    rng = np.random.default_rng(0)
    k = torch.arange(keyframes, dtype=torch.float32)[:, None]
    T_gt = se3.exp(k * torch.tensor([0.05, 0.02, 0.01, 0.004, -0.006, 0.008])).to(device)
    pyrs, pts = [], []
    for T in T_gt:
        pyr = build_pyramid(render_two_plane_view(LIVE_CAM, T), levels=level + 2)
        p = topk_gradient_points(pyr.images[0], pyr.grad_mag[0], LIVE_CAM, num_points=points,
                                 block=4)
        z = _depth_at_pixels(two_plane_depth(LIVE_CAM, T), p.uv[0])
        pyrs.append(pyr)
        pts.append(p._replace(p3d=LIVE_CAM.unproject(p.uv, z[None]), valid=p.valid & (z > 0.1)))
    noise = torch.from_numpy(rng.normal(scale=0.008, size=(keyframes, 6)).astype(np.float32))
    noise[0] = 0.0
    T_init = se3.compose(se3.exp(noise.to(device)), T_gt)
    prob = photo_ba_problem_from_keyframes(pyrs, T_init, pts, level=level)
    scale = torch.from_numpy(1.0 + rng.normal(scale=0.05, size=prob.inv_depth.shape)
                             .astype(np.float32)).to(device)
    return prob._replace(inv_depth=prob.inv_depth * scale), LIVE_CAM.scaled(level)


def _depth_at_pixels(depth, uv):
    u = uv[:, 0].long().clamp(0, depth.shape[1] - 1)
    v = uv[:, 1].long().clamp(0, depth.shape[0] - 1)
    return depth[v, u]


def test_photometric_window_solves_on_cpu_tensors():
    """The card test's window on the CPU (the plain K3): the solve lowers the
    cost and two solves are bit-equal."""
    from uwslam_tpu_torch.ba.photometric import photometric_bundle_adjust

    prob, cam = _photo_window("cpu")
    a = photometric_bundle_adjust(prob, cam, max_iters=6)
    b = photometric_bundle_adjust(prob, cam, max_iters=6)
    assert float(a.cost) < 0.5 * float(a.initial_cost)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_captured_photometric_solve_repeats_bit_for_bit_on_card(cuda_device):
    from uwslam_tpu_torch.ba.photometric import PhotoBAProblem, photometric_bundle_adjust
    from uwslam_tpu_torch.ops.graph import WARMUP_CALLS, CapturedStep, tree_clone

    prob, cam = _photo_window(cuda_device)

    def solve(*fields):
        out = photometric_bundle_adjust(PhotoBAProblem(*fields), cam, max_iters=6)
        return tuple(out)

    eager = solve(*prob)
    before = ops.cuda_bilinear_sample.launches
    step = CapturedStep(solve, tuple(prob))
    first = tree_clone(step(*prob))
    second = step(*prob)
    torch.cuda.synchronize()
    # 2 max_iters + 1 evaluations per solve, each one K3 launch.
    assert step.kernel_launches[2] == 13
    assert ops.cuda_bilinear_sample.launches - before == 13 * (2 + WARMUP_CALLS)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    cpu = solve(*(t.cpu() for t in prob))
    gap = se3.log(se3.compose(first[0].cpu(), se3.inverse(cpu[0]))).abs().max()
    assert float(gap) < 1e-3 and float(first[2]) < 0.5 * float(first[3])
