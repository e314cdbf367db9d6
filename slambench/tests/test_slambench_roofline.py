"""The kernels' byte counts at the cells' shapes, and the frozen copy's
agreement with the program's own arithmetic (`uwslam_tpu_torch.micro`)."""
import pytest
import torch

from slambench import roofline


def test_pyramid_bytes_at_the_cells_shape():
    # 640 x 480, 3 levels: level 0 read; gx, gy, |g| of 307,200 + 76,800 +
    # 19,200 pixels and the images of levels 1 and 2 written, 4 B each
    assert roofline.pyramid_bytes(480, 640, 3) == 4 * (307200 + 3 * 403200 + 96000)


@pytest.mark.parametrize("fc,affine,per_pair", [(True, False, 248), (True, True, 376),
                                                (False, False, 248)])
def test_lm_evaluate_bytes_at_the_cells_shape(fc, affine, per_pair):
    n = roofline.lm_evaluate_bytes(2048, 2000, fc, affine)
    assert n == 2048 * 13 + 2000 * (4 + (48 if fc else 40)) + per_pair


@pytest.mark.parametrize("levels", [3, 5])
def test_pyramid_count_is_micro_s(levels):
    from uwslam_tpu_torch import micro

    images = torch.zeros(1, 480, 640)
    assert roofline.pyramid_bytes(480, 640, levels) == micro.bound_pyramid(images, levels)["bytes"]


@pytest.mark.parametrize("fc", [True, False])
@pytest.mark.parametrize("affine", [False, True])
def test_lm_evaluate_count_is_micro_s(fc, affine):
    from uwslam_tpu_torch import micro

    valid = torch.ones(1, 2048, dtype=torch.bool)
    ok = torch.arange(2048)[None] < 1900
    assert roofline.lm_evaluate_bytes(2048, 1900, fc, affine) == micro.bound_lm_evaluate(
        valid, ok, fc, affine)["bytes"]


def test_peaks_are_the_h100_data_sheet_s():
    p = roofline.peak("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["f32_flop_per_s"] == 67e12
