"""The port's command line (`uwslam_tpu_torch.cli.main`) on the 18-frame PNG
dataset of tests/test_cli_offline.py, live and `--offline` (FC and IC),
against the JAX package's CLI on the same files, plus the flags it refuses.

The JAX CLI runs with `--no-pipeline`: its synchronous loop is the port's
live loop, and tests/test_pipeline.py pins its pipelined loop to the same
trajectory. Tolerances: trajectory files within 1e-4 (they are written
with 6 decimals), ATE below 0.01 m.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu.camera import PinholeCamera as JaxCamera  # noqa: E402
from uwslam_tpu.cli import main as jax_main  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu.lie import so3 as jso3  # noqa: E402
from uwslam_tpu.utils.synthetic import render_plane_view  # noqa: E402
from uwslam_tpu_torch.cli.main import UNPORTED_FLAGS, build_parser  # noqa: E402
from uwslam_tpu_torch.cli.main import main as port_main  # noqa: E402

JCAM = JaxCamera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120)
ATE = re.compile(r"ATE RMSE \(Sim3-aligned\): ([0-9.]+) m over (\d+) poses")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_cli_offline.py's dataset: 18 PNG frames named by TUM
    timestamps, TUM ground truth, an undistorted calibration XML."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    rgb = root / "rgb"
    os.makedirs(rgb)
    gt_lines = ["# gt\n# synthetic\n# ts tx ty tz qx qy qz qw\n"]
    for i in range(18):
        xi = jnp.asarray([0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i],
                         jnp.float32)
        T = jse3.exp(xi)
        img = np.asarray(render_plane_view(JCAM, T, 2.0))
        ts = f"{1.0 + 0.033 * i:.6f}"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(rgb / f"{ts}.png")
        Twc = np.asarray(jse3.inverse(T))
        q = np.asarray(jso3.to_quaternion(jnp.asarray(Twc[:3, :3])))
        t = Twc[:3, 3]
        gt_lines.append(f"{ts} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
    (root / "groundtruth.txt").write_text("".join(gt_lines))
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>160</in_width><in_height>120</in_height>
<out_width>160</out_width><out_height>120</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>120.0 120.0 79.5 59.5</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>0 0 0 0</data></rectification>
</opencv_storage>""")
    return root


def _args(root, out, *extra):
    return ["-d", str(root / "rgb"), "-c", str(root / "calib.xml"),
            "--tum-gt", str(root / "groundtruth.txt"), "--mono-depth", "2.0",
            "--levels", "4", "--num-points", "512", "--trajectory-out", str(out), *extra]


@pytest.mark.parametrize("extra", [
    (), ("--offline", "--chunk", "8", "--track-mode", "fc"),
    ("--offline", "--chunk", "8", "--track-mode", "ic"),
], ids=["live", "offline-fc", "offline-ic"])
def test_cli_matches_jax_cli(dataset, tmp_path, capsys, extra):
    port_out, jax_out = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert port_main(_args(dataset, port_out, "--platform", "cpu", *extra)) == 0
    port_stdout = capsys.readouterr().out
    jax_extra = ("--no-pipeline",) if not extra else ()
    assert jax_main(_args(dataset, jax_out, "--platform", "cpu", *extra, *jax_extra)) == 0
    m = ATE.search(port_stdout)
    assert m and float(m.group(1)) < 0.01 and int(m.group(2)) == 18
    a, b = np.loadtxt(port_out), np.loadtxt(jax_out)
    assert a.shape == (18, 8)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_live_cli_reports_its_loop_and_steady_state(dataset, tmp_path, capsys):
    assert port_main(_args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                           "--profile", "--max-frames", "16")) == 0
    err = capsys.readouterr().err
    assert "synchronous process_frame" in err and "ROADMAP" in err
    assert "tracked 16 frames" in err and "ingest" in err


@pytest.mark.parametrize("flag", sorted(UNPORTED_FLAGS))
def test_unported_flags_exit_nonzero_naming_the_roadmap(dataset, tmp_path, capsys, flag):
    action = next(a for a in build_parser()._actions if a.dest == flag)
    value = [] if action.nargs == 0 else [str(tmp_path) if action.type is None else "2"]
    argv = _args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                 action.option_strings[-1], *value)
    assert port_main(argv) != 0
    assert "ROADMAP slice" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


def test_default_platform_needs_a_card(dataset, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(_args(dataset, tmp_path / "t.txt")) != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()
