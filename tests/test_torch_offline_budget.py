"""The port's offline budget (`python -m uwslam_tpu_torch.offline_budget`)
against the JAX package's `benchmarks/offline_budget.py` recipe on the CPU,
at 160 x 120 with the bench camera scaled by 4 (4 pyramid levels: 5 do not
halve 120 rows evenly), 256 points.

- The tool's frames are the JAX script's: `render_plane_view` at poses
  se3.exp(amp sin(2 pi i / 24)), within 1e-4 gray levels.
- Each track-level prefix's poses are `jax.vmap(track)` with mode "ic" and
  the same prefix, on pyramids and points each package builds from those
  frames: 1e-4 on se3.log, tests/test_torch_sequence.py's tolerance for
  `track_sequence_batched`.
- A `--platform cpu` run on 8 frames at the design point writes the JAX
  script's keys, its `device` naming the CPU and no device figure; without
  a card the default platform refuses to run.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.image.pyramid import build_pyramid_batched as jax_pyramid  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.tracking import topk_gradient_points as jax_topk  # noqa: E402
from uwslam_tpu.tracking import track as jax_track  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch import bench, offline_budget  # noqa: E402
from uwslam_tpu_torch.interop import camera_from_jax  # noqa: E402
from uwslam_tpu_torch.lie import se3  # noqa: E402

JCAM = JaxCamera(fx=131.25, fy=131.25, cx=79.5, cy=59.5, width=160, height=120)
CAM = camera_from_jax(JCAM)
DESIGN = offline_budget.Design(levels=4, num_points=256)
FRAMES = 4


@pytest.fixture(scope="module")
def jax_frames():
    amp = jnp.asarray(bench.TWIST_AMP, jnp.float32)
    poses = [jse3.exp(amp * math.sin(2.0 * math.pi * i / 24.0)) for i in range(FRAMES)]
    return jnp.stack([render_plane_view(JCAM, T, 2.0) for T in poses])


def test_frames_are_the_jax_scripts(jax_frames):
    _, frames = offline_budget.scene(FRAMES, CAM, device="cpu")
    np.testing.assert_allclose(frames.numpy(), np.asarray(jax_frames), atol=1e-4)


def test_each_level_prefix_matches_jax_vmap_track(jax_frames):
    frames = torch.from_numpy(np.array(jax_frames))
    stages = {s.name: s for s in offline_budget.stages(frames, CAM, DESIGN)}
    pyrs = jax.jit(lambda f: jax_pyramid(f, levels=DESIGN.levels))(jax_frames)
    pts = jax.jit(jax.vmap(lambda img, gm: jax_topk(
        img, gm, JCAM, num_points=DESIGN.num_points, mono_z=DESIGN.mono_z)))(
        pyrs.images[0], pyrs.grad_mag[0])
    ref, tgt = (jax.tree.map(lambda x, s=s: x[s], pyrs) for s in (slice(None, -1), slice(1, None)))
    ref_pts = jax.tree.map(lambda x: x[:-1], pts)
    for k in range(1, len(DESIGN.track_levels) + 1):
        lv, it = DESIGN.track_levels[:k], DESIGN.iters[:k]
        want = jax.jit(jax.vmap(lambda a, b, p, lv=lv, it=it: jax_track(
            a, b, p, JCAM, T_init=None, levels=lv, max_iters=it, mode="ic").T))(
            ref, tgt, ref_pts)
        got = stages[f"track_levels{lv}(b{FRAMES - 1})"].fn()
        dlog = se3.log(got) - se3.log(torch.from_numpy(np.array(want)))
        assert float(dlog.abs().max()) < 1e-4, lv


def test_cpu_run_writes_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "budget.json"
    assert offline_budget.main(["--platform", "cpu", "--frames", "8", "--out", str(out)]) == 0
    capsys.readouterr()
    got = json.loads(out.read_text())
    assert {"device", "budget", "fps_serial", "fps_pipelined"} <= set(got)
    assert got["device"].startswith("cpu")
    names = [r["stage"] for r in got["budget"]]
    assert names == ["pyramid5_batched(b8)", "topk_select(b8)", "track_levels(3,)(b7)",
                     "track_levels(3, 2)(b7)", "track_levels(3, 2, 1)(b7)",
                     "track_levels(3, 2, 1, 0)(b7)", "full_chunk(b8)"]
    for row in got["budget"]:
        assert {"stage", "ms_per_chunk", "note"} <= set(row)
        assert row["ms_per_chunk"] > 0
        assert row["device_busy_ms"] is None and row["launches"] is None
    assert all(r["note"].startswith("marginal level") for r in got["budget"][2:6])
    assert got["fps_serial"] > 0 and got["fps_pipelined"] > 0
    assert got["ate_m"] < 1e-3


def test_the_default_platform_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        offline_budget.main(["--out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()
