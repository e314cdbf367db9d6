"""The port's command line (`uwslam_tpu_torch.cli.main`) on the 18-frame PNG
dataset of tests/test_cli_offline.py, live and `--offline` (FC and IC),
against the JAX package's CLI on the same files, plus the flags it refuses.

Both CLIs run their default live loop (pipelined), `--no-pipeline` (the
synchronous one), `-p` (TUM depth images, live and offline) and `--euroc`
with a distorted calibration. Tolerances: trajectory files within 1e-4 (they are written
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
from test_torch_ransac import jax_accelerator_branch  # noqa: E402

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


def _both_clis(argv_port, argv_jax, capsys, n=18, ate_max=0.01):
    """Run both CLIs; the port's ATE line and both trajectory files."""
    assert port_main(argv_port) == 0
    port_stdout = capsys.readouterr().out
    assert jax_main(argv_jax) == 0
    m = ATE.search(port_stdout)
    assert m and float(m.group(1)) < ate_max and int(m.group(2)) == n
    a = np.loadtxt(argv_port[argv_port.index("--trajectory-out") + 1])
    b = np.loadtxt(argv_jax[argv_jax.index("--trajectory-out") + 1])
    assert a.shape == (n, 8)
    np.testing.assert_allclose(a, b, atol=1e-4)
    return a


@pytest.mark.parametrize("extra", [
    (), ("--no-pipeline",), ("--offline", "--chunk", "8", "--track-mode", "fc"),
    ("--offline", "--chunk", "8", "--track-mode", "ic"),
], ids=["live", "live-no-pipeline", "offline-fc", "offline-ic"])
def test_cli_matches_jax_cli(dataset, tmp_path, capsys, extra):
    """`live` is each CLI's default loop, the pipelined one."""
    _both_clis(_args(dataset, tmp_path / "port.txt", "--platform", "cpu", *extra),
               _args(dataset, tmp_path / "jax.txt", "--platform", "cpu", *extra), capsys)


def test_live_cli_reports_its_loop_and_steady_state(dataset, tmp_path, capsys):
    assert port_main(_args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                           "--profile", "--max-frames", "16")) == 0
    err = capsys.readouterr().err
    assert "live loop: synchronous process_frame" in err        # --profile
    assert "tracked 16 frames" in err and "ingest" in err
    assert port_main(_args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                           "--max-frames", "16")) == 0
    err = capsys.readouterr().err
    assert "live loop: pipelined process_frame_async" in err and "steady state" in err


@pytest.fixture(scope="module")
def depth_dir(dataset):
    """TUM depth images for the dataset: 16-bit PNG, 5000 per metre, named
    by timestamps 1 ms off the frames' (associated by nearest timestamp)."""
    from PIL import Image

    from uwslam_tpu.utils.synthetic import plane_depth

    out = dataset / "depth"
    os.makedirs(out)
    for i in range(18):
        xi = jnp.asarray([0.02 * i, 0.008 * i, 0.004 * i, 0.001 * i, -0.002 * i, 0.003 * i],
                         jnp.float32)
        metres = np.asarray(plane_depth(JCAM, jse3.exp(xi), 2.0))
        Image.fromarray(np.round(metres * 5000.0).astype(np.uint16)).save(
            out / f"{1.001 + 0.033 * i:.6f}.png")
    return out


@pytest.mark.parametrize("extra", [
    (), ("--offline", "--chunk", "8", "--track-mode", "ic"),
], ids=["live", "offline-ic"])
def test_cli_with_depth_images_matches_jax_cli(dataset, depth_dir, tmp_path, capsys, extra):
    """`-p`: the monocular depth is deliberately wrong (1 where the plane is
    at 2), so the ATE holds only if the depth images are read and used."""
    def argv(out):
        a = _args(dataset, out, "--platform", "cpu", "-p", str(depth_dir), *extra)
        a[a.index("--mono-depth") + 1] = "1.0"
        return a

    _both_clis(argv(tmp_path / "port.txt"), argv(tmp_path / "jax.txt"), capsys)


def test_depth_png_decodes_to_raw_sixteen_bit_values(depth_dir):
    from uwslam_tpu_torch.io import open_tum

    seq = open_tum(str(depth_dir.parent / "rgb"), str(depth_dir))
    assert [os.path.basename(p) for p in seq.depth_paths[:2]] == ["1.001000.png", "1.034000.png"]
    img, depth = seq.load(0)
    assert depth.dtype == np.float32 and depth.shape == img.shape == (120, 160)
    assert np.array_equal(depth, np.rint(depth)) and 9000 < depth.min() and depth.max() < 11000


def test_offline_cli_warns_when_frames_lack_depth(dataset, depth_dir, tmp_path, capsys,
                                                  monkeypatch):
    from uwslam_tpu_torch.io import dataset as port_dataset

    load = port_dataset.Sequence.load
    monkeypatch.setattr(port_dataset.Sequence, "load",
                        lambda self, i: load(self, i) if i != 3 else (load(self, i)[0], None))
    assert port_main(_args(dataset, tmp_path / "t.txt", "--platform", "cpu", "--offline",
                           "--chunk", "8", "-p", str(depth_dir))) == 0
    assert "1 frames lack depth" in capsys.readouterr().err


@pytest.fixture(scope="module")
def euroc_dataset(tmp_path_factory):
    """tests/test_euroc_rectify.py's dataset: 16 distorted frames in the EUROC
    layout, its ground-truth CSV and a calibration XML with the radtan
    coefficients."""
    from PIL import Image

    from uwslam_tpu.utils.synthetic import render_plane_view_distorted

    raw = JaxCamera(fx=140.0, fy=140.0, cx=95.5, cy=63.5, width=192, height=128,
                    k1=-0.28, k2=0.07, p1=2e-4, p2=1.8e-5)
    root = tmp_path_factory.mktemp("euroc")
    data = root / "mav0" / "cam0" / "data"
    os.makedirs(data)
    rows = ["#ts,px,py,pz,qw,qx,qy,qz\n"]
    for i in range(16):
        T = jse3.exp(jnp.asarray([0.02 * i, 0.008 * i, 0.003 * i, 0.0, 0.0, 0.002 * i]))
        img = np.asarray(render_plane_view_distorted(raw, T, 2.0))
        ns = int(1e9 * 0.05 * i)
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(data / f"{ns}.png")
        Twc = np.asarray(jse3.inverse(T))
        q = np.asarray(jso3.to_quaternion(jnp.asarray(Twc[:3, :3])))
        t = Twc[:3, 3]
        rows.append(f"{ns},{t[0]},{t[1]},{t[2]},{q[0]},{q[1]},{q[2]},{q[3]}\n")
    (root / "gt.csv").write_text("".join(rows))
    (root / "calib.xml").write_text(f"""<?xml version="1.0"?>
<opencv_storage>
<in_width>{raw.width}</in_width><in_height>{raw.height}</in_height>
<out_width>{raw.width}</out_width><out_height>{raw.height}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.fx} {raw.fy} {raw.cx} {raw.cy}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{raw.k1} {raw.k2} {raw.p1} {raw.p2}</data></rectification>
</opencv_storage>""")
    return root


@pytest.mark.parametrize("extra", [(), ("--offline", "--chunk", "8")], ids=["live", "offline"])
def test_euroc_cli_with_distortion_matches_jax_cli(euroc_dataset, tmp_path, capsys, extra):
    def argv(out):
        return ["-d", str(euroc_dataset / "mav0"), "--euroc", "-c",
                str(euroc_dataset / "calib.xml"), "--euroc-gt", str(euroc_dataset / "gt.csv"),
                "--trajectory-out", str(out), "--levels", "4", "--mono-depth", "2.0",
                "--num-points", "512", "--platform", "cpu", *extra]

    _both_clis(argv(tmp_path / "port.txt"), argv(tmp_path / "jax.txt"), capsys, n=16,
               ate_max=0.03)


@pytest.mark.parametrize("flag", sorted(UNPORTED_FLAGS))
def test_unported_flags_exit_nonzero_naming_the_roadmap(dataset, tmp_path, capsys, flag):
    action = next(a for a in build_parser()._actions if a.dest == flag)
    value = [] if action.nargs == 0 else [str(tmp_path) if action.type is None else "2"]
    argv = _args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                 action.option_strings[-1], *value)
    assert port_main(argv) != 0
    assert "ROADMAP slice" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


@pytest.mark.parametrize("loop", [(), ("--no-pipeline",)], ids=["pipelined", "synchronous"])
def test_photo_ba_flag_runs_photometric_window_ba(dataset, tmp_path, capsys, loop):
    """`--photo-ba` turns on window BA in its photometric form (as the JAX
    CLI's flag does): exit 0, the solves reported, ATE below 0.02 m."""
    argv = _args(dataset, tmp_path / "t.txt", "--platform", "cpu", "--photo-ba",
                 "--kf-max-gap", "4", *loop)
    assert port_main(argv) == 0
    out = capsys.readouterr()
    m = ATE.search(out.out)
    assert m and float(m.group(1)) < 0.02 and int(m.group(2)) == 18
    assert re.search(r"window BA: \d+ LM iters over [1-9]\d* runs", out.err)
    assert (tmp_path / "t.txt").exists()


def _jax_uniforms(self, num_matches, seed):
    import jax

    H = self.config.features.ransac_hypotheses
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (H, num_matches), minval=1e-9, maxval=1.0)))


@pytest.mark.parametrize("extra,atol", [
    (("--features",), 5e-4),
    (("--features", "--ba", "--ba-prior-weight", "1e4"), 5e-4),
    # Level 0 only, identity weights, no failure detection: 10 Gauss-Newton
    # steps per frame carry last-bit differences on (6.6e-4 over 18 frames
    # against an XLA CPU build without fused multiply-adds).
    (("--reference-mode", "--kp-per-level", "128"), 3e-3),
    # The bootstrap feeds last-bit differences back into tracking (see
    # tests/test_torch_features_frontend.py): 2e-2 over 18 frames.
    (("--depth-bootstrap", "--bootstrap-block", "16", "--bootstrap-shrink", "0.5",
      "--bootstrap-edge-ratio", "1.6"), 2e-2),
], ids=["features", "features-ba", "reference-mode", "depth-bootstrap"])
def test_config2_and_4_flags_match_jax_cli(dataset, tmp_path, capsys, monkeypatch, extra, atol):
    """The flags of this slice, both CLIs on the same files from the same
    RANSAC samples (the port's are replaced by the JAX package's draw)."""
    from uwslam_tpu_torch.system import SlamSystem

    monkeypatch.setattr(SlamSystem, "_ransac_uniforms", _jax_uniforms)
    argv_port = _args(dataset, tmp_path / "port.txt", "--platform", "cpu", *extra)
    argv_jax = _args(dataset, tmp_path / "jax.txt", "--platform", "cpu", *extra)
    assert port_main(argv_port) == 0
    out = capsys.readouterr()
    # The JAX package on the two-view forms the port runs on every device.
    with jax_accelerator_branch():
        assert jax_main(argv_jax) == 0
    m = ATE.search(out.out)
    assert m and int(m.group(2)) == 18
    a, b = np.loadtxt(tmp_path / "port.txt"), np.loadtxt(tmp_path / "jax.txt")
    np.testing.assert_allclose(a, b, atol=atol)
    m_j = ATE.search(capsys.readouterr().out)
    assert abs(float(m.group(1)) - float(m_j.group(1))) <= max(2e-4, 0.15 * float(m_j.group(1)))
    if "--ba" in extra:
        assert "window BA:" in out.err


def test_depth_bootstrap_implies_features_and_pipelines(dataset, tmp_path, capsys):
    assert port_main(_args(dataset, tmp_path / "t.txt", "--platform", "cpu",
                           "--depth-bootstrap")) == 0
    err = capsys.readouterr().err
    assert "live loop: pipelined process_frame_async" in err and "tracked 18 frames" in err


def test_default_platform_needs_a_card(dataset, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(_args(dataset, tmp_path / "t.txt")) != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


def _config_of(argv, monkeypatch):
    """The SlamConfig the CLI builds for `argv` (construction stops there)."""
    from uwslam_tpu_torch import system as port_system

    seen = {}

    class Stop(Exception):
        pass

    def capture(calib, config, device):
        seen["config"] = config
        raise Stop

    monkeypatch.setattr(port_system, "SlamSystem", capture)
    with pytest.raises(Stop):
        port_main(argv)
    return seen["config"]


@pytest.mark.parametrize("flags,want", [
    (("--loop-closure",), dict(use_loop_closure=True, global_ba=False, use_features=False,
                               use_sim3=True)),
    (("--loop-closure", "--loop-se3"), dict(use_loop_closure=True, use_sim3=False)),
    (("--dist-ba", "--host-devices", "4"), dict(global_ba=True, use_features=True,
                                                use_loop_closure=False)),
], ids=["loop-closure", "loop-se3", "dist-ba"])
def test_loop_and_dist_ba_flags_parse_as_the_jax_cli(dataset, tmp_path, monkeypatch, flags, want):
    """`--dist-ba` implies the feature front end (JAX cli/main.py:369-372);
    `--loop-se3` turns the pose graph to SE(3); `--host-devices` is parsed
    as the global BA's shard count."""
    config = _config_of(_args(dataset, tmp_path / "t.txt", "--platform", "cpu", *flags),
                        monkeypatch)
    got = dict(use_loop_closure=config.use_loop_closure, global_ba=config.global_ba,
               use_features=config.use_features, use_sim3=config.loop.use_sim3)
    assert {k: got[k] for k in want} == want
    assert build_parser().parse_args(_args(dataset, tmp_path / "t.txt", *flags)).host_devices \
        == (4 if "--host-devices" in flags else None)


@pytest.mark.parametrize("flags", [
    ("--loop-closure",), ("--loop-closure", "--loop-se3", "--no-pipeline"),
    ("--dist-ba", "--host-devices", "4"), ("--loop-closure", "--dist-ba", "--host-devices", "8"),
], ids=["loop-closure", "loop-se3-synchronous", "dist-ba", "loop-closure-dist-ba"])
def test_loop_and_dist_ba_flags_run_and_report_in_eval_format(dataset, tmp_path, capsys, flags):
    """A tiny run of each flag: exit 0, the trajectory written, and the
    stderr lines read by eval.py's own patterns (LOOP_RE, DBA_RE or
    DBA_SKIP_RE), as it reads the JAX CLI's."""
    import eval as jax_eval

    argv = _args(dataset, tmp_path / "t.txt", "--platform", "cpu", "--kf-max-gap", "4", *flags)
    assert port_main(argv) == 0
    out = capsys.readouterr()
    m = ATE.search(out.out)
    assert m and float(m.group(1)) < 0.05 and int(m.group(2)) == 18
    assert (tmp_path / "t.txt").exists()
    if "--loop-closure" in flags:
        assert jax_eval.LOOP_RE.search(out.err)
    if "--dist-ba" in flags:
        m = jax_eval.DBA_RE.search(out.err)
        assert m or jax_eval.DBA_SKIP_RE.search(out.err), out.err[-2000:]
        if m:
            assert int(m.group(4)) == int(flags[flags.index("--host-devices") + 1])
            assert int(m.group(5)) >= 1 and int(m.group(3)) >= 30
