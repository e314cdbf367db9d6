"""Pinhole camera model and calibration loading."""
from .calibration import Calibration, load, load_json, load_opencv_xml
from .model import PinholeCamera

__all__ = ["Calibration", "PinholeCamera", "load", "load_json", "load_opencv_xml"]
