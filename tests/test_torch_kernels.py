"""The port's kernel wrappers: CPU dispatch, argument checks, and (marked
`cuda`, skipped without a card) each CUDA kernel against its plain PyTorch
version on the card, launch counts included.

This file imports neither JAX nor the JAX package, so on a CUDA machine
without JAX it runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`.
Kernel and plain version evaluate the same f32 operations in the same order
without FMA contraction, so the card's comparison is exact (atol 0).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import ops  # noqa: E402
from uwslam_tpu_torch.camera import PinholeCamera  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402

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
    return {
        "scharr": (ops.scharr_gradients_batched, ops.scharr_plain, (imgs,), {}),
        "warp_sample": (ops.warp_and_sample, ops.warp_and_sample_plain,
                        (stack[:, :1].contiguous(), p3d, T), {"cam": CAM}),
        "warp_sample_c3": (ops.warp_and_sample, ops.warp_and_sample_plain,
                           (stack, p3d, T), {"cam": CAM}),
        "bilinear_sample": (ops.cuda_bilinear_sample, ops.bilinear_sample_plain,
                            (stack, uv), {}),
    }


CASES = ["scharr", "warp_sample", "warp_sample_c3", "bilinear_sample"]


@pytest.mark.parametrize("case", CASES)
def test_wrapper_runs_plain_version_on_cpu_tensors(case):
    wrapper, plain, args, kw = _cases()[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert wrapper.launches == before   # nothing was launched


@pytest.mark.parametrize("case", CASES)
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


def test_build_targets_sm90a_from_the_package_sources():
    from uwslam_tpu_torch.ops import _lib

    path = _lib.library_path()
    assert path.parent == _lib.BUILD_DIR and path.suffix == ".so"
    assert all((_lib.CSRC / s).is_file() for s in _lib.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _lib.NVCC_FLAGS
