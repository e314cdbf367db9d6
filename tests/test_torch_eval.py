"""The port's evaluation (`python -m uwslam_tpu_torch.eval`) against eval.py.

- The port CLI's lines parse under every pattern of eval.py:308-324 (the
  window-BA line once read "..., T s of host time", which eval.py's WBA_RE
  does not match), and the port's copies of those patterns are eval.py's.
- The health checks give eval.py:590-676's messages on hand-made tables of
  results (eval.py's own `main()` run over the same table, its CLI runs and
  datasets replaced, in a temporary REPO).
- A run of the port's evaluation writes its own files and leaves eval.py's
  `RESULTS.md` and `RESULTS_r*.json` alone; without a card it refuses to run
  unless given `--platform cpu`.
- End to end: config 3 (rectified EUROC, 5 levels, affine brightness,
  depth bootstrap) on 12 frames rendered by eval.py's maker, the port's CLI
  on the CPU against the JAX CLI on the same files (both from the JAX
  package's RANSAC samples, the JAX package on the two-view forms the port
  runs), ATE computed unrounded from the trajectory files, equal frame
  counts. Without `--depth-bootstrap` the two agree closely: ATE
  within 5% (both 0.0013858-0.0013863 m) and every pose within
  E2E_POSE_ATOL. With it, the bootstrap fixes the monocular scale from the
  first pair and the ATE rests on the input's last bits: the JAX CLI's own
  runs of these frames give 0.0029893 m under XLA's AVX2 code, 0.0032294 m
  under its default and 0.0052301 m under SSE4_2 (E2E_JAX_ISA_ATE: this
  test's JAX run under `XLA_FLAGS=--xla_cpu_max_isa=...`, which checks that
  its own run lies in that span); the port, 0.0037590 m, is held inside the
  span widened by E2E_MARGIN on each side. (Config 1 is the comparison
  without the bootstrap and features; it is left out to keep this file's
  time, and the full-size comparison of every config is in PERF.md.)
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import eval as jeval  # noqa: E402
from uwslam_tpu.cli import main as jax_main  # noqa: E402
from uwslam_tpu_torch import eval as port_eval  # noqa: E402
from uwslam_tpu_torch.cli.main import main as port_main  # noqa: E402
from uwslam_tpu_torch.io.trajectory import ate_rmse, associate, read_groundtruth_euroc, \
    read_trajectory_tum  # noqa: E402
from test_torch_cli import _jax_uniforms, dataset  # noqa: E402,F401
from test_torch_ransac import jax_accelerator_branch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ("ATE_RE", "FPS_RE", "WARM_RE", "WBA_RE", "DBA_RE", "DBA_SKIP_RE", "LOOP_RE",
            "DROP_RE")
E2E_FRAMES = 12
E2E_JAX_ISA_ATE = (0.0029893, 0.0032294, 0.0052301)   # AVX2, default, SSE4_2
E2E_MARGIN = 0.05
E2E_POSE_ATOL = 1e-4      # m and rotation entries, without the bootstrap


def test_port_patterns_are_eval_pys():
    for name in PATTERNS:
        assert getattr(port_eval, name).pattern == getattr(jeval, name).pattern, name


def _cli_argv(root, *extra):
    return ["-d", str(root / "rgb"), "-c", str(root / "calib.xml"), "--tum-gt",
            str(root / "groundtruth.txt"), "--mono-depth", "2.0", "--levels", "4",
            "--num-points", "512", *extra]


def test_cli_lines_parse_under_eval_pys_patterns(dataset):
    """`python -m uwslam_tpu_torch` with `--features --ba` on the CPU, as
    eval.py's `run_cli` runs it: ATE, frames, warm fps and the window-BA
    figures all read by eval.py's patterns."""
    proc = subprocess.run([sys.executable, "-m", "uwslam_tpu_torch", *_cli_argv(
        dataset, "--features", "--ba", "--ba-prior-weight", "1e4", "--platform", "cpu")],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for name in ("ATE_RE", "FPS_RE", "WARM_RE", "WBA_RE"):
        assert getattr(jeval, name).search(out), (name, out[-3000:])
    parsed = port_eval.parse_output(out)
    assert parsed["frames"] == parsed["ate_poses"] == 18
    assert parsed["window_ba_iters"] > 0 and parsed["window_ba_iters_per_sec"] > 0
    assert parsed["fps_warm"] > 0


def test_loop_and_global_ba_lines_parse_under_eval_pys_patterns(dataset, capsys):
    assert port_main(_cli_argv(dataset, "--features", "--ba", "--loop-closure", "--dist-ba",
                               "--host-devices", "2", "--platform", "cpu")) == 0
    out = capsys.readouterr()
    text = out.out + out.err
    assert jeval.LOOP_RE.search(text)
    assert jeval.DBA_RE.search(text) or jeval.DBA_SKIP_RE.search(text), text[-3000:]
    assert jeval.WBA_RE.search(text)


def test_drop_line_parses_under_eval_pys_pattern(capsys):
    est = np.random.default_rng(0).standard_normal((40, 3))
    est[3] = np.nan
    ate_rmse(est, est + 0.01)
    text = capsys.readouterr()
    m = jeval.DROP_RE.search(text.out + text.err)
    assert m and (int(m.group(1)), int(m.group(2))) == (1, 40)


GOOD = {
    "0": {"rc": 0, "ate_rmse_m": 0.15, "ate_dropped_pairs": 0, "ate_total_pairs": 150},
    "1": {"rc": 0, "ate_rmse_m": 0.05},
    "2": {"rc": 0, "ate_rmse_m": 0.05},
    "3": {"rc": 0, "ate_rmse_m": 0.03},
    "4": {"rc": 0, "ate_rmse_m": 0.03, "window_ba_iters": 10},
    "5": {"rc": 0, "ate_rmse_m": 0.1, "loop_edges": 4, "dist_ba_keyframes": 60,
          "dist_ba_landmarks": 4000, "dist_ba_obs": 20000, "dist_ba_applied": True},
    "6": {"rc": 0, "ate_rmse_m": 0.2, "loop_edges": 4},
    "7": {"rc": 0, "ate_rmse_m": 0.3, "dist_ba_obs": 5000, "dist_ba_applied": True},
    "8": {"rc": 0, "ate_rmse_m": 0.04},
    "9": {"rc": 0, "ate_rmse_m": 0.04},
    "10": {"rc": 0, "ate_rmse_m": 0.05},
}
BAD = {  # every check of eval.py:590-676 fails
    "0": {"rc": 0, "ate_rmse_m": 0.01},
    "1": {"rc": 0, "ate_rmse_m": 0.05, "ate_dropped_pairs": 9, "ate_total_pairs": 150},
    "2": {"rc": 0, "ate_rmse_m": 0.08},
    "3": {"rc": 0, "ate_rmse_m": 0.09},
    "4": {"rc": 0, "ate_rmse_m": 0.09},
    "5": {"rc": 0, "ate_rmse_m": 0.3, "dist_ba_skipped": True, "dist_ba_keyframes": 12,
          "dist_ba_landmarks": 400, "dist_ba_obs": 50, "dist_ba_applied": False},
    "6": {"rc": 0, "ate_rmse_m": 0.2},
    "7": {"rc": 0, "ate_rmse_m": 0.3, "dist_ba_obs": 5000},
    "8": {"rc": 0, "ate_rmse_m": 0.04},
    "9": {"rc": 0, "ate_rmse_m": 0.04},
    "10": {"rc": 0, "ate_rmse_m": 0.05},
}
SOME = {"1": {"rc": 0, "ate_rmse_m": 0.05}, "2": {"rc": 0, "ate_rmse_m": 0.0551},
        "5": {"rc": 1, "error": "boom"}, "7": {"rc": 1, "error": "boom"}}


def _eval_py_health(table, quick, monkeypatch, tmp_path, capsys) -> list[str]:
    """eval.py's own `main()` over `table`: its CLI runs and datasets
    replaced, REPO a temporary directory; the HEALTH CHECK FAILED lines."""
    calls = iter(sorted(table, key=int))
    fake = {"root": "r", "gt": "g", "calib": "c", "rgb": "i"}
    monkeypatch.setattr(jeval, "REPO", str(tmp_path))
    monkeypatch.setattr(jeval, "make_tum_dataset", lambda *a, **k: fake)
    monkeypatch.setattr(jeval, "make_euroc_dataset", lambda *a, **k: fake)
    monkeypatch.setattr(jeval, "run_cli", lambda args: dict(table[next(calls)]))
    argv = ["eval.py", "--configs", ",".join(sorted(table, key=int))] + (["--quick"] * quick)
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    assert jeval.main() == 0
    return [ln.split("HEALTH CHECK FAILED: ", 1)[1]
            for ln in capsys.readouterr().out.splitlines() if "HEALTH CHECK FAILED" in ln]


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
@pytest.mark.parametrize("name", ["good", "bad", "some"])
def test_health_checks_give_eval_pys_messages(name, quick, monkeypatch, tmp_path, capsys):
    table = {"good": GOOD, "bad": BAD, "some": SOME}[name]
    want = _eval_py_health(table, quick, monkeypatch, tmp_path, capsys)
    ordered = {k: dict(table[k]) for k in sorted(table, key=int)}
    got = port_eval.health_checks(ordered, quick)
    assert got == want
    printed = capsys.readouterr().out
    assert [ln for ln in printed.splitlines() if ln.startswith("HEALTH CHECK FAILED: ")] == \
        [f"HEALTH CHECK FAILED: {m}" for m in want]
    assert (len(want) == 0) == (name == "good")
    if name == "bad":
        assert len(want) == (15 if not quick else 12)


def test_a_run_writes_its_own_files_and_leaves_eval_pys_alone(monkeypatch, tmp_path, capsys):
    sentinels = {"RESULTS.md": "# eval.py's table\n", "RESULTS_r09.json": '{"1": {}}',
                 "BA_VALUE_r09.json": "{}"}
    for name, text in sentinels.items():
        (tmp_path / name).write_text(text)
    fake = {"root": "r", "gt": "g", "calib": "c", "rgb": "i", "renderer": "uwslam_tpu_torch"}
    monkeypatch.setattr(port_eval, "REPO", str(tmp_path))
    monkeypatch.setattr(port_eval, "datasets", lambda quick, device: (fake,) * 4)
    seen = []

    def fake_cli(args, platform):
        seen.append((args, platform))
        return {"rc": 0, "ate_rmse_m": 0.05, "frames": 150, "fps": 3.0}

    monkeypatch.setattr(port_eval, "run_cli", fake_cli)
    assert port_eval.main(["--platform", "cpu", "--configs", "1,2,5", "--round", "9"]) == 0
    for name, text in sentinels.items():
        assert (tmp_path / name).read_text() == text
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        list(sentinels) + ["RESULTS_TORCH_r09.json", "RESULTS_TORCH.md"])
    res = json.loads((tmp_path / "RESULTS_TORCH_r09.json").read_text())
    assert sorted(k for k in res if not k.startswith("_")) == ["1", "2", "5"]
    assert res["1"]["renderer"] == "uwslam_tpu_torch" and res["1"]["platform"] == "cpu"
    assert res["_device"].startswith("cpu")
    md = (tmp_path / "RESULTS_TORCH.md").read_text()
    assert "uwslam_tpu_torch.eval" in md and "| 1 |" in md and res["_device"] in md
    assert all(p == "cpu" for _, p in seen)
    long_args = seen[2][0]   # config 5: eval.py's long-sequence flags, no --platform
    assert "--host-devices" in long_args and "--platform" not in long_args
    assert long_args[-2:] == ["--loop-closure", "--dist-ba"]


def test_eval_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_eval, "REPO", str(tmp_path))
    assert port_eval.main(["--configs", "1"]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


def test_eval_configs_are_eval_pys_flags():
    """The eleven configs' flags: eval.py:449-558 with `--platform cpu` of
    the long sequence left to the run's own `--platform`."""
    ds = {"root": "R", "gt": "G", "calib": "C", "rgb": "I", "renderer": "x"}
    table = port_eval.configs(ds, {**ds, "rgb": "L"}, {**ds, "root": "M"}, {**ds, "root": "V"},
                              640, 160)
    assert sorted(table) == list(range(11))
    assert table[2]["args"][-7:] == ["--mono-depth", "2.5", "--features", "--depth-bootstrap",
                                     "--affine", "--bootstrap-shrink", "0.25"]
    assert table[3]["args"][:3] == ["-d", "M", "--euroc"]
    assert table[4]["args"][-1] == "--ba" and "--ba" not in table[10]["args"]
    assert table[5]["args"][:2] == ["-d", "L"] and table[0]["args"][-1] == "--reference-mode"


def _ate_of(traj_path, gt_rows):
    ts, poses = read_trajectory_tum(str(traj_path))
    ia, ib = associate(np.asarray(ts), gt_rows[:, 0], max_dt=0.05)
    return ate_rmse(poses[ia][:, :3, 3], gt_rows[ib][:, 1:4]), len(ia), poses[ia]


def _config3_both(tmp_path, capsys, monkeypatch, *drop):
    """Config 3 (less the flags `drop`) through the port's CLI and the JAX
    CLI on E2E_FRAMES of eval.py's MH01 render -> per CLI (ATE, poses in
    the ATE, poses)."""
    from uwslam_tpu_torch.system import SlamSystem

    mh01 = jeval.make_euroc_dataset(str(tmp_path / "mh01"), 16, kind="euroc_mh")  # >= 15
    gt = read_groundtruth_euroc(mh01["gt"])
    unused = {"root": "", "gt": "", "calib": "", "rgb": ""}    # the TUM sequences
    argv = [a for a in port_eval.configs(unused, unused, mh01, mh01, 16, 8)[3]["args"]
            if a not in drop] + ["--max-frames", str(E2E_FRAMES), "--platform", "cpu"]
    monkeypatch.setattr(SlamSystem, "_ransac_uniforms", _jax_uniforms)
    assert port_main(argv + ["--trajectory-out", str(tmp_path / "port.txt")]) == 0
    port_out = capsys.readouterr()
    with jax_accelerator_branch():
        assert jax_main(argv + ["--trajectory-out", str(tmp_path / "jax.txt")]) == 0
    jax_out = capsys.readouterr()
    frames = [int(re.search(r"tracked (\d+) frames", o.err).group(1))
              for o in (port_out, jax_out)]
    assert frames == [E2E_FRAMES, E2E_FRAMES]
    runs = [_ate_of(tmp_path / f"{who}.txt", gt) for who in ("port", "jax")]
    assert [n for _, n, _ in runs] == [E2E_FRAMES, E2E_FRAMES]
    return runs


def test_config3_matches_the_jax_cli_on_eval_py_frames(tmp_path, capsys, monkeypatch):
    (a, _, _), (b, _, _) = _config3_both(tmp_path, capsys, monkeypatch)
    lo, hi = min(E2E_JAX_ISA_ATE), max(E2E_JAX_ISA_ATE)
    assert lo <= b <= hi, ("the JAX run outside its own span over instruction sets", b)
    assert (1 - E2E_MARGIN) * lo <= a <= (1 + E2E_MARGIN) * hi, (a, lo, hi)


def test_config3_without_the_bootstrap_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    (a, _, Pa), (b, _, Pb) = _config3_both(tmp_path, capsys, monkeypatch, "--depth-bootstrap")
    assert abs(a - b) <= E2E_MARGIN * b, (a, b)
    np.testing.assert_allclose(Pa, Pb, atol=E2E_POSE_ATOL)
