"""Pinhole camera model, rectification and calibration loading."""
from .calibration import Calibration, load, load_json, load_opencv_xml
from .model import (
    PinholeCamera,
    compute_roi,
    optimal_new_camera,
    remap_bilinear,
    undistort_map,
)

__all__ = [
    "Calibration",
    "PinholeCamera",
    "compute_roi",
    "load",
    "load_json",
    "load_opencv_xml",
    "optimal_new_camera",
    "remap_bilinear",
    "undistort_map",
]
