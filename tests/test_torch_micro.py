"""The port's micro benchmark (`python -m uwslam_tpu_torch.micro`) on the CPU:
every op of benchmarks/micro.py's list builds and runs once at a small batch
(`--platform cpu` times nothing), and without a card the default platform
refuses to run. Its device times come from the card only."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from uwslam_tpu_torch import micro  # noqa: E402

OPS = ("pyramid5_k1", "live_pyramid3", "roi_pyramid5", "scharr_l0", "sample_c3", "sample_c1",
       "normal_eq_6x6", "solve_6x6", "lm_step", "lm_step", "lm_step_affine", "lm_step_affine",
       "topk_points", "se3_exp_compose_inv", "lm_evaluate",
       "lm_evaluate_affine",
       # K1 on the offline pyramid's levels 1-4, the kernels at the rectified EUROC shapes
       "scharr_l1", "scharr_l2", "scharr_l3", "scharr_l4",
       "euroc_pyramid5", "euroc_scharr_l0", "euroc_scharr_l1", "euroc_scharr_l2", "euroc_scharr_l3",
       "euroc_scharr_l4", "euroc_warp_texels_c3", "euroc_sample_texels_c3", "euroc_lm_evaluate",
       "euroc_lm_evaluate_affine")


def test_every_op_runs_once_on_the_cpu(capsys):
    assert micro.main(["--platform", "cpu", "--batch", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split('"')[3].split("(")[0] for ln in lines] == list(OPS)
    assert all('"ms": null' in ln for ln in lines)


def test_the_pyramid_bound_counts_each_byte_once():
    b = micro.bound_pyramid(torch.empty(96, 480, 640), 5)
    assert b["bytes"] == 628_531_200 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.18762, rel=1e-4)
    assert micro.bound_pyramid(torch.empty(1, 480, 640), 3)["bytes"] == 6_451_200
    assert micro.bound_pyramid(torch.empty(1, 480, 736), 5)["bytes"] == 7_529_280


def test_bounds_are_the_larger_of_bytes_and_operations():
    b = micro.bound(3.35e9, 0.0)
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 1.0) < 1e-12
    b = micro.bound(0.0, 67e9)
    assert b["bound_by"] == "operations" and abs(b["bound_ms"] - 1.0) < 1e-12


def test_the_default_platform_needs_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert micro.main(["--out", str(tmp_path / "m.json")]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "m.json").exists()
