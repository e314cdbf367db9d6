"""The port's session views (`uwslam_tpu_torch.viz`, `utils.profiling.trace`)
against the JAX package's.

- `write_ply`, `trajectory_svg`, `write_trajectory_html`, `EventStream`:
  host numpy in both packages, so the same bytes from the same input.
- `VizServer(port=0)` answers over HTTP on an ephemeral port.
- The debug panels on tests/test_parallel.py's TestDebugVisualizers case
  (160 x 120, 256 points at depth 2, the identity pose): every pixel within
  1 gray level of the JAX package's panel (the port samples with kernel
  K3's plain version, the JAX package with its gather; residuals and
  Jacobians agree to f32 rounding, so a pixel may round to the next level).
- `trace` writes a Chrome trace on the CPU.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image import build_pyramid as jbuild_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import topk_gradient_points as jtopk  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu.viz import debug as jdebug  # noqa: E402
from uwslam_tpu.viz import export as jexport  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax, points_from_numpy  # noqa: E402
from uwslam_tpu_torch.utils.profiling import trace  # noqa: E402
from uwslam_tpu_torch.viz import VizServer, debug, export  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, size=(50, 3)).astype(np.uint8)
    est = np.cumsum(rng.normal(scale=0.1, size=(30, 3)), axis=0)
    gt = est + rng.normal(scale=0.01, size=est.shape)
    return pts, colors, est, gt


@pytest.mark.parametrize("with_colors", [False, True])
def test_write_ply_bytes_equal_jax(cloud, tmp_path, with_colors):
    pts, colors, _, _ = cloud
    c = colors if with_colors else None
    export.write_ply(str(tmp_path / "port.ply"), pts, c)
    jexport.write_ply(str(tmp_path / "jax.ply"), pts, c)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


@pytest.mark.parametrize("with_gt", [False, True])
def test_trajectory_svg_and_html_bytes_equal_jax(cloud, tmp_path, with_gt):
    _, _, est, gt = cloud
    g = gt if with_gt else None
    assert export.trajectory_svg(est, g) == jexport.trajectory_svg(est, g)
    assert export.trajectory_svg(est, g, 320, 200) == jexport.trajectory_svg(est, g, 320, 200)
    export.write_trajectory_html(str(tmp_path / "port.html"), est, g)
    jexport.write_trajectory_html(str(tmp_path / "jax.html"), est, g)
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_event_stream_bytes_equal_jax(cloud, tmp_path):
    _, _, est, _ = cloud
    for mod, name in ((export, "port.jsonl"), (jexport, "jax.jsonl")):
        stream = mod.EventStream(str(tmp_path / name))
        stream.emit_pose(3, 0.1, np.eye(4, dtype=np.float32))
        stream.emit("diag", frame_id=3, inliers=412, err=0.25, pos=est[0])
        stream.close()
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    first = json.loads((tmp_path / "port.jsonl").read_text().splitlines()[0])
    assert first["kind"] == "pose" and first["frame_id"] == 3


def test_viz_server_answers_on_an_ephemeral_port(cloud):
    _, _, est, gt = cloud
    server = VizServer(port=0)
    try:
        assert server.port > 0
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/", timeout=10) as r:
            assert "waiting for poses" in r.read().decode()
        server.update(est, gt)
        with urllib.request.urlopen(url + "/", timeout=10) as r:
            page = r.read().decode()
        assert f"{len(est)} poses" in page and jexport.trajectory_svg(est, gt) in page
        with urllib.request.urlopen(url + "/state.json", timeout=10) as r:
            state = json.loads(r.read())
        assert state["frames"] == len(est) and np.allclose(state["est"], est)
    finally:
        server.close()
    assert not server._thread.is_alive()


@pytest.fixture(scope="module")
def panels_case():
    """tests/test_parallel.py:TestDebugVisualizers's case."""
    def frame(i):
        T = jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0, 0, 0, 0.002 * i]))
        return np.asarray(render_plane_view(JCAM, T, 2.0))

    ref, tgt = frame(0), frame(1)
    pyr = jbuild_pyramid(jnp.asarray(ref), levels=3)
    pts = jtopk(pyr.images[0], pyr.grad_mag[0], JCAM, num_points=256, mono_z=2.0)
    pts = pts._replace(p3d=JCAM.unproject(pts.uv, jnp.full(256, 2.0)))
    level = tuple(np.asarray(x[0]) for x in (pyr.images, pyr.grad_x, pyr.grad_y))
    return ref, tgt, pts, level


def _pixels(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def test_debug_panels_match_jax(panels_case, tmp_path):
    ref, tgt, jpts, level = panels_case
    pts = points_from_numpy(jpts, "cpu")
    T = np.eye(4, dtype=np.float32)
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    debug.save_candidate_points(port + "_cand.png", ref, pts.uv, pts.valid)
    jdebug.save_candidate_points(jax_ + "_cand.png", ref, jpts.uv, jpts.valid)
    debug.save_residual_map(port + "_res.png", tgt, pts.uv, pts.intensity - 100.0, pts.valid)
    jdebug.save_residual_map(jax_ + "_res.png", tgt, jpts.uv, jpts.intensity - 100.0, jpts.valid)
    debug.save_warped_panels(port, ref, tgt, pts, T, CAM)
    jdebug.save_warped_panels(jax_, ref, tgt, jpts, jnp.asarray(T), JCAM)
    debug.save_jacobian_panels(port, level, pts, T, CAM)
    jdebug.save_jacobian_panels(jax_, level, jpts, jnp.asarray(T), JCAM)
    suffixes = ["_cand.png", "_res.png", "_ref.png", "_tgt.png", "_warped.png", "_residual.png"]
    suffixes += [f"_J_{n}.png" for n in ("vx", "vy", "vz", "wx", "wy", "wz")]
    for suffix in suffixes:
        a, b = _pixels(port + suffix), _pixels(jax_ + suffix)
        assert a.shape == b.shape, suffix
        assert np.abs(a - b).max() <= 1, suffix
        assert os.path.getsize(port + suffix) > 500, suffix


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
