"""Parity of the port's calibration loaders, dataset readers and trajectory
I/O with the JAX package's, on fixtures written here (never outside the
repository), plus the binary PGM reader and the prefetcher.

Tolerances: loaders and readers exact; trajectory files to the 6 decimals
they are written with (1e-6 on the written numbers, poses 1e-5).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from uwslam_tpu import camera as jcamera  # noqa: E402
from uwslam_tpu.io import dataset as jdataset  # noqa: E402
from uwslam_tpu.io import trajectory as jtraj  # noqa: E402
from uwslam_tpu.lie import se3 as jse3  # noqa: E402
from uwslam_tpu_torch import camera  # noqa: E402
from uwslam_tpu_torch.io import dataset, native, trajectory  # noqa: E402
from uwslam_tpu_torch.lie import se3, so3  # noqa: E402

XML = """<?xml version="1.0"?>
<opencv_storage>
<in_width>{w}</in_width><in_height>{h}</in_height>
<out_width>{ow}</out_width><out_height>{oh}</out_height>
<calibration_values type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{calib}</data></calibration_values>
<rectification type_id="opencv-matrix"><rows>1</rows><cols>4</cols>
<dt>f</dt><data>{rect}</data></rectification>
</opencv_storage>
"""

CALIBRATIONS = {
    # TUM-like, pixel intrinsics, [0 0 0 1] sentinel (no distortion)
    "tum": dict(w=640, h=480, ow=640, oh=480, calib="517.3 516.5 318.6 255.3",
                rect="0 0 0 1"),
    # EUROC-like, normalized intrinsics and radial-tangential distortion
    "euroc": dict(w=752, h=480, ow=752, oh=480, calib="0.6120 0.9580 0.4992 0.5153",
                  rect="-0.2834 0.0739 0.00019 1.76e-05"),
}


def _fields(cal):
    raw = cal.raw
    intr = (raw.fx, raw.fy, raw.cx, raw.cy, raw.width, raw.height)
    dist = (raw.k1, raw.k2, raw.p1, raw.p2)
    return intr, dist, (cal.out_width, cal.out_height), cal.needs_rectification


@pytest.mark.parametrize("name", sorted(CALIBRATIONS))
def test_calibration_xml_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.xml"
    path.write_text(XML.format(**CALIBRATIONS[name]))
    got, want = camera.load(str(path)), jcamera.load(str(path))
    assert _fields(got) == _fields(want)
    assert got.needs_rectification == (name == "euroc")


def test_calibration_json_matches_jax(tmp_path):
    for d in ({"fx": 500.0, "fy": 501.0, "cx": 320.0, "cy": 240.0, "width": 640,
               "height": 480},
              {"fx": 500.0, "fy": 501.0, "cx": 320.0, "cy": 240.0, "width": 640,
               "height": 480, "k1": -0.1, "out_width": 600, "out_height": 400}):
        path = tmp_path / "calib.json"
        path.write_text(json.dumps(d))
        assert _fields(camera.load(str(path))) == _fields(jcamera.load(str(path)))
    with pytest.raises(ValueError):
        camera.load(str(tmp_path / "calib.yaml"))
    bad = tmp_path / "bad.xml"
    bad.write_text("<opencv_storage><in_width>3</in_width></opencv_storage>")
    with pytest.raises(ValueError, match="in_height"):
        camera.load(str(bad))


def _write_pgm(path, img):
    img = np.asarray(img)
    maxval = 65535 if img.dtype == np.uint16 else 255
    data = img.astype(">u2").tobytes() if maxval > 255 else img.tobytes()
    h, w = img.shape
    path.write_bytes(f"P5\n# a comment\n{w} {h}\n{maxval}\n".encode() + data)


def test_read_pgm_8_and_16_bit(tmp_path):
    rng = np.random.default_rng(0)
    img8 = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    img16 = rng.integers(0, 65536, (5, 4), dtype=np.uint16)
    _write_pgm(tmp_path / "a.pgm", img8)
    _write_pgm(tmp_path / "b.pgm", img16)
    np.testing.assert_array_equal(dataset.read_pgm(str(tmp_path / "a.pgm")), img8)
    np.testing.assert_array_equal(dataset.read_pgm(str(tmp_path / "b.pgm")), img16)
    (tmp_path / "c.pgm").write_bytes(b"P2\n2 1\n255\n1 2\n")
    with pytest.raises(IOError):
        dataset.read_pgm(str(tmp_path / "c.pgm"))
    if native.available():       # the native decoder reads the same pixels
        np.testing.assert_array_equal(native.decode(str(tmp_path / "a.pgm")), img8)


def _image_dir(tmp_path, names, sub="rgb"):
    d = tmp_path / sub
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for n in names:
        _write_pgm(d / n, rng.integers(0, 256, (6, 8), dtype=np.uint8))
    return d


def test_list_images_order_and_minimum(tmp_path):
    names = [f"{i}.pgm" for i in (5, 99, 100, 7, 1000, 3, 42, 8, 9, 10, 11, 12, 13, 14, 15)]
    d = _image_dir(tmp_path, names)
    (d / "notes.txt").write_text("not an image")
    got = dataset.list_images(str(d))
    assert got == jdataset.list_images(str(d))
    assert [os.path.basename(p) for p in got][:4] == ["3.pgm", "5.pgm", "7.pgm", "8.pgm"]
    few = _image_dir(tmp_path, [f"{i}.pgm" for i in range(14)], sub="few")
    with pytest.raises(ValueError, match="insufficient images"):
        dataset.list_images(str(few))
    words = _image_dir(tmp_path, [f"img_{c}.pgm" for c in "abcdefghijklmnop"], sub="words")
    assert dataset.list_images(str(words)) == jdataset.list_images(str(words))


def test_readers_match_jax(tmp_path):
    stamps = [f"{1305031102.175304 + 0.033 * i:.6f}.pgm" for i in range(16)]
    rgb = _image_dir(tmp_path, stamps, sub="tum/rgb")
    depth = _image_dir(tmp_path, [f"{1305031102.160407 + 0.033 * i:.6f}.pgm"
                                  for i in range(17)], sub="tum/depth")
    got, want = dataset.open_tum(str(rgb), str(depth), start=2), jdataset.open_tum(
        str(rgb), str(depth), start=2)
    assert got.image_paths == want.image_paths and got.depth_paths == want.depth_paths
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    ns = [f"{1403636579763555584 + 50_000_000 * i}.pgm" for i in range(15)]
    _image_dir(tmp_path, ns, sub="mav0/cam0/data")
    got, want = (m.open_euroc(str(tmp_path / "mav0"), start=1) for m in (dataset, jdataset))
    assert got.image_paths == want.image_paths
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.timestamps[0] == pytest.approx(1403636579.81355, abs=1e-4)
    for d in (rgb, _image_dir(tmp_path, [f"f{i:02d}.pgm" for i in range(15)], sub="plain")):
        got, want = dataset.open_directory(str(d)), jdataset.open_directory(str(d))
        assert got.image_paths == want.image_paths
        assert (got.timestamps is None) == (want.timestamps is None)
        if got.timestamps is not None:
            np.testing.assert_array_equal(got.timestamps, want.timestamps)
    seq = dataset.open_directory(str(rgb))
    np.testing.assert_array_equal(seq.load(3)[0], dataset.read_pgm(seq.image_paths[3]))


def test_frame_prefetcher_yields_in_order_and_stops(tmp_path):
    d = _image_dir(tmp_path, [f"{i}.pgm" for i in range(20)])
    seq = dataset.open_directory(str(d))
    pf = dataset.FramePrefetcher(seq, lookahead=2)
    got = [i for i, _ in pf]
    pf.close()
    assert got == list(range(20))
    pf = dataset.FramePrefetcher(seq, lookahead=1)
    first = next(iter(pf))
    pf.close()                       # stops while the worker still has frames
    assert first[0] == 0 and not pf._thread.is_alive()
    os.remove(seq.image_paths[5])
    pf = dataset.FramePrefetcher(seq)
    with pytest.raises(OSError):
        list(pf)
    pf.close()


def test_quaternions_match_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 3)).astype(np.float32) * np.array([[1.0], [3.0]] * 32,
                                                               np.float32)
    R = np.asarray(jse3.exp(jnp.asarray(np.concatenate([np.zeros_like(w), w], 1))))[:, :3, :3]
    from uwslam_tpu.lie import so3 as jso3

    q_want = np.asarray(jso3.to_quaternion(jnp.asarray(R)))
    np.testing.assert_allclose(so3.to_quaternion(torch.from_numpy(R.copy())).numpy(),
                               q_want, atol=1e-6)
    np.testing.assert_allclose(so3.from_quaternion(torch.from_numpy(q_want.copy())).numpy(),
                               np.asarray(jso3.from_quaternion(jnp.asarray(q_want))), atol=1e-6)


def test_trajectory_round_trip_against_jax_readers(tmp_path):
    rng = np.random.default_rng(3)
    T = se3.exp(torch.from_numpy(rng.normal(size=(12, 6)).astype(np.float32))).numpy()
    ts = 1.0 + 0.033 * np.arange(12)
    path = tmp_path / "traj.txt"
    trajectory.write_trajectory_tum(str(path), ts, T)
    jpath = tmp_path / "traj_jax.txt"
    jtraj.write_trajectory_tum(str(jpath), ts, T)
    a = np.loadtxt(path)
    b = np.loadtxt(jpath)
    np.testing.assert_allclose(a, b, atol=1.5e-6)
    ts_j, T_j = jtraj.read_trajectory_tum(str(path))
    ts_p, T_p = trajectory.read_trajectory_tum(str(path))
    np.testing.assert_array_equal(ts_p, ts_j)
    np.testing.assert_allclose(T_p, T_j, atol=1e-6)
    np.testing.assert_allclose(T_p, T, atol=1e-5)
    rows_j = jtraj.read_groundtruth_tum(str(path), skip_lines=1)
    np.testing.assert_array_equal(trajectory.read_groundtruth_tum(str(path), skip_lines=1), rows_j)
    csv = tmp_path / "gt.csv"
    csv.write_text("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "".join(
        f"{1403636579763555584 + 5_000_000 * i},{i},0.5,1,1,0,0,0\n" for i in range(5)))
    np.testing.assert_array_equal(trajectory.read_groundtruth_euroc(str(csv)),
                                  jtraj.read_groundtruth_euroc(str(csv)))
    gt_ts = ts[::2] + 0.004
    for a_, b_ in zip(trajectory.associate(ts, gt_ts), jtraj.associate(ts, gt_ts)):
        np.testing.assert_array_equal(a_, b_)


def test_euroc_rows_and_rpe_match_jax():
    """`poses_from_euroc_rows` (qw first) within 1e-6 of the JAX package's
    (f32 quaternion algebra in another order) and the relative pose error
    (host numpy in both) within 1e-9 on the same poses, over deltas 1 and
    3."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = np.concatenate([np.arange(12)[:, None] * 0.05, rng.normal(size=(12, 3)), q], axis=1)
    got = trajectory.poses_from_euroc_rows(rows)
    want = np.asarray(jtraj.poses_from_euroc_rows(rows))
    np.testing.assert_allclose(got, want, atol=1e-6)
    noisy = got.copy()
    noisy[:, :3, 3] += 0.01 * rng.normal(size=(12, 3))
    for delta in (1, 3):
        np.testing.assert_allclose(trajectory.rpe(noisy, got, delta),
                                   jtraj.rpe(noisy, got, delta), atol=1e-9)
    assert trajectory.rpe(got, got)[0] < 1e-6


def test_pipeline_presets_match_jax():
    from uwslam_tpu import models as jmodels
    from uwslam_tpu_torch import models

    for name in ("direct_odometry_config", "feature_slam_config", "windowed_ba_config",
                 "full_slam_config"):
        got, want = getattr(models, name)(profile=True), getattr(jmodels, name)(profile=True)
        for field in ("use_features", "use_ba", "use_reloc", "use_loop_closure", "global_ba",
                      "profile"):
            assert getattr(got, field) == getattr(want, field), (name, field)
